"""PyTorch port, training helpers against the JAX package: the learning
rate schedules, the flow-matching training schedule and logit-normal
density (from injected normals), the EMA under accumulation, the
optimizer against optax (clip, AdamW, MultiSteps) on a toy tree, the
checkpoint manager (rotation, atomic saves, save_final, restore), and the
loggers (rounded PNGs, JSON lines). fp32 bounds are stated per test."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from prompt_diffusion_tpu.schedulers import flow_match as jfm
from prompt_diffusion_tpu.training import ema as jema
from prompt_diffusion_tpu.training import lr_schedules as jlr
from prompt_diffusion_tpu_torch.schedulers import flow_match as pfm
from prompt_diffusion_tpu_torch.training import checkpoint as ckpt
from prompt_diffusion_tpu_torch.training import lr_schedules as plr
from prompt_diffusion_tpu_torch.training.ema import EMA
from prompt_diffusion_tpu_torch.training.image_logger import MetricLogger, save_grid
from prompt_diffusion_tpu_torch.training.optimizer import AdamW, TrainState

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(base_lr=1e-4, warm_up_steps=10_000, f_start=1e-6, f_max=1.0, f_min=1.0),
    dict(base_lr=2e-4, warm_up_steps=100, f_start=0.1, f_max=1.0, f_min=0.5, cycle_length=1000),
    dict(base_lr=1e-4, warm_up_steps=0, f_min=0.25, cycle_length=500),
])
def test_lambda_linear_matches_jax(kw):
    p, j = plr.lambda_linear(**kw), jlr.lambda_linear(**kw)
    for step in (0, 1, 50, 99, 100, 101, 499, 9_999, 10_000, 123_456):
        assert p(step) == pytest.approx(float(j(step)), rel=1e-6)


def test_warmup_cosine_matches_jax():
    kw = dict(base_lr=3e-4, warm_up_steps=50, lr_min=0.1, lr_max=1.0, lr_start=0.01,
              max_steps=1000)
    p, j = plr.warmup_cosine(**kw), jlr.warmup_cosine(**kw)
    for step in (0, 1, 25, 49, 50, 51, 500, 999, 1000, 5000):
        assert p(step) == pytest.approx(float(j(step)), rel=1e-5, abs=1e-12)


@pytest.mark.parametrize("shift", [3.0, 1.0])
def test_flow_match_schedule_matches_jax(shift):
    """The fp32 tables bit for bit; add_noise and the index lookup."""
    p, j = pfm.FlowMatchSchedule.create(shift=shift), jfm.FlowMatchSchedule.create(shift=shift)
    assert p.num_train_timesteps == j.num_train_timesteps and p.shift == j.shift
    np.testing.assert_array_equal(p.sigmas.numpy(), np.asarray(j.sigmas))
    np.testing.assert_array_equal(p.timesteps.numpy(), np.asarray(j.timesteps))
    idx = np.array([0, 17, 999, 500])
    np.testing.assert_array_equal(p.sigma_for_timestep_index(torch.from_numpy(idx)).numpy(),
                                  np.asarray(j.sigma_for_timestep_index(jnp.asarray(idx))))
    rng = np.random.default_rng(0)
    x0, noise = rng.normal(size=(2, 3, 4, 4)).astype(np.float32), \
        rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    sig = np.array([0.25, 0.9], np.float32)
    np.testing.assert_allclose(
        p.add_noise(torch.from_numpy(x0), torch.from_numpy(sig), torch.from_numpy(noise)).numpy(),
        np.asarray(j.add_noise(jnp.asarray(x0), jnp.asarray(sig), jnp.asarray(noise))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (0.5, 1.3)])
def test_logit_normal_density_matches_jax(mean, std):
    """The JAX density from its key; the port from the same normals."""
    key = jax.random.PRNGKey(7)
    want = jfm.logit_normal_timestep_density(key, 16, mean, std)
    normals = torch.from_numpy(np.array(jax.random.normal(key, (16,), jnp.float32)))
    got = pfm.logit_normal_timestep_density(16, mean, std, normals=normals)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    drawn = pfm.logit_normal_timestep_density(16, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (16,) and ((drawn > 0) & (drawn < 1)).all()


def test_ema_steps_on_accumulation_boundaries_like_jax():
    """The round-3 fix: with every=3 the EMA moves (and its count
    advances) only on micro-steps 2, 5, ...; values as JAX's."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(5,)).astype(np.float32)
    ema, jstate = EMA([torch.from_numpy(p0)]), jema.ema_init({"w": jnp.asarray(p0)})
    for step in range(7):
        p = rng.normal(size=(5,)).astype(np.float32)
        ema.update_every([torch.from_numpy(p)], 0.999, step, 3)
        jstate = jema.ema_update_every(jstate, {"w": jnp.asarray(p)}, 0.999, step, 3)
        assert ema.count == int(jstate.count) == (step + 1) // 3
        np.testing.assert_allclose(ema.params[0].numpy(), np.asarray(jstate.params["w"]),
                                   rtol=1e-6, atol=1e-7)
    assert not torch.equal(ema.params[0], torch.from_numpy(p0))


def _toy(seed=2):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32)}


@pytest.mark.parametrize("accum,max_norm", [(1, 1.0), (1, 100.0), (3, 0.5)])
def test_adamw_matches_optax(accum, max_norm):
    """`AdamW.apply` on fp32 tensors against optax's clip + adamw (+
    MultiSteps) for six micro-steps of random gradients: the parameters
    within 1e-6 of their size, the moments and counts alike."""
    sched = plr.lambda_linear(1e-2, warm_up_steps=4, f_start=0.1)
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(jlr.lambda_linear(1e-2, warm_up_steps=4, f_start=0.1),
                                 weight_decay=0.01))
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    params = {k: jnp.asarray(v) for k, v in _toy().items()}
    opt_state = tx.init(params)
    named = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in _toy().items()}
    state = TrainState(named, accum_steps=accum)
    opt = AdamW(sched, 0.01, max_norm, accum)
    rng = np.random.default_rng(3)
    for step in range(6):
        g = {k: (rng.normal(size=v.shape) * 3).astype(np.float32) for k, v in _toy().items()}
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, upd)
        moved = opt.apply(state, [torch.from_numpy(g[k]) for k in state.names])
        assert moved == ((step + 1) % accum == 0)
        for k, p in zip(state.names, state.params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=0,
                                       atol=1e-6 * np.abs(np.asarray(params[k])).max())
    assert state.count == 6 // accum


def _state(seed):
    named = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in _toy(seed).items()}
    st = TrainState(named, accum_steps=2, use_ema=True, seed=seed)
    st.step, st.count, st.mini_step, st.ema.count = 3, 1, 1, 1
    for t in st.tensors().values():
        t.add_(1.5)
    return st


def test_checkpoint_rotation_atomic_and_restore(tmp_path):
    """Multiples of save_every only, newest `keep` kept, no temporary
    directory left; restore gives back every tensor and counter bit for
    bit, and (template, None) with no checkpoint; save_final saves the last
    step once."""
    m = ckpt.make_manager(str(tmp_path / "c"), save_every=2, keep=2)
    template = _state(9)
    assert ckpt.restore_state(m, template) == (template, None)
    src = _state(4)
    saved = [s for s in range(7) if ckpt.save_state(m, s, src)]
    m.wait_until_finished()
    assert saved == [0, 2, 4, 6] and m.all_steps() == [4, 6]
    assert not [n for n in os.listdir(tmp_path / "c") if n.startswith(".tmp")]
    assert not ckpt.save_state(m, 6, src)  # not later than the latest
    got, step = ckpt.restore_state(m, template)
    assert step == 6 and got is template and got.meta() == src.meta()
    for k, t in src.tensors().items():
        assert torch.equal(got.tensors()[k], t), k
    for p, mst in zip(got.params, got.master):  # the modules' tensors follow
        assert torch.equal(p.detach(), mst)
    ckpt.save_final(m, 6, src)
    ckpt.save_final(m, 7, src)
    assert m.all_steps() == [6, 7]
    with pytest.raises(ValueError, match="other trainable tensors"):
        bad = TrainState({"z": torch.nn.Parameter(torch.zeros(2))}, accum_steps=2, use_ema=True)
        ckpt.restore_state(m, bad)
    m.close()


def test_save_runs_off_the_calling_thread(tmp_path, monkeypatch):
    """The tensors are copied before `save` returns, so a change made right
    after it does not reach the file; the write happens on the worker."""
    import threading

    threads = []
    real = ckpt.safetensors_io.save_file
    monkeypatch.setattr(ckpt.safetensors_io, "save_file",
                        lambda *a, **k: (threads.append(threading.current_thread()),
                                         real(*a, **k)))
    m = ckpt.make_manager(str(tmp_path), save_every=1, keep=None)
    st = _state(5)
    want = {k: t.clone() for k, t in st.tensors().items()}
    m.save(0, st)
    for t in st.tensors().values():
        t.add_(1.0)
    m.wait_until_finished()
    assert threads and threads[0] is not threading.main_thread()
    fresh = _state(5)
    ckpt.restore_state(m, fresh)
    for k, t in want.items():
        assert torch.equal(fresh.tensors()[k], t)
    m.close()


def test_png_grid_rounds_and_metrics_are_json_lines(tmp_path):
    """PNGs round to the nearest 8-bit value (the JAX `_to_uint8`
    truncates; ROADMAP queue 3); metrics are one JSON object a line."""
    img = np.full((2, 4, 4, 3), 0.5, np.float32)  # 127.5 -> 128
    img[1] = 0.999  # 254.745 -> 255
    save_grid(img, str(tmp_path / "g" / "grid.png"))
    arr = np.asarray(Image.open(tmp_path / "g" / "grid.png"))
    assert arr.shape == (4, 8, 3) and arr[0, 0, 0] == 128 and arr[0, 4, 0] == 255
    log = MetricLogger(str(tmp_path))
    log.log(3, {"loss": torch.tensor(0.25), "lr": 1e-4, "note": "x"})
    log.log(4, {"loss": 0.5})
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows == [{"step": 3, "loss": 0.25, "lr": 1e-4}, {"step": 4, "loss": 0.5}]
