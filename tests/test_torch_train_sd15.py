"""PyTorch port, SD1.5 training: the port's train step against JAX's
`make_train_step` over two steps at fp32 on the tiny configs (the port fed
the draws JAX makes from `fold_in(rng, step)`), the round-3 fixes as
tests, the loader copy against its original, the crossing of a trained
ControlNet to JAX's importer, and the two SD1.5 entries on a temporary data
root.

Bounds: the loss within 1e-5 relative; grad_norm within 1e-5 relative at
the first step and 1e-4 at the second. AdamW's first steps move a
parameter by about lr wherever |g| >> eps, so a parameter is held within
1e-3 lr (plus one fp32 rounding of its own value) where JAX's gradient
exceeds 1e-3 of the tree's largest in both steps, and within 2 lr x steps
elsewhere: a gradient at the rounding noise has a sign the two frameworks
may round apart, and its parameter moves by lr either way, which also
moves the second step's gradient (by ~3e-5 of its norm here)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prompt_diffusion_tpu.data import edit_dataset as jed
from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.tools.torch_import import import_ldm_checkpoint as j_import_ldm
from prompt_diffusion_tpu.training import sd15 as jtr
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch import finetune_sd15, train_sd15
from prompt_diffusion_tpu_torch.data import edit_dataset as ped
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.tools.torch_import import export_ldm_checkpoint
from prompt_diffusion_tpu_torch.training import sd15 as tr
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE, make_edit_root, randomize

torch.set_num_threads(2)

B, IMG, T, STEPS = 2, 32, 1000, 2
KEY = jax.random.PRNGKey(1)
LR = 1e-4


@pytest.fixture(scope="module")
def models():
    """The tiny JAX pipeline, its random parameters, a port pipeline, and
    one batch (drop rate 0.3 so the two steps' draws drop text and pair)."""
    jpol = j_fp32_policy()
    ucfg = junet.UNetConfig(**TINY_UNET)
    jpipe = JPipe(
        unet=junet.UNetSD15(config=ucfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jpol),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP), policy=jpol),
        schedule=JSchedule.create(),
    )
    params = randomize(jax.eval_shape(lambda r: jpipe.init_params(r, image_size=IMG),
                                      jax.random.PRNGKey(0)), 30)
    pol = fp32_policy()
    pipe = PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET), pol),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, pol),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), pol),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP), pol), device="cpu")
    rng = np.random.default_rng(3)
    batch = dict(image=rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
                 query=rng.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32),
                 example_pair=rng.uniform(-1, 1, (B, IMG, IMG, 6)).astype(np.float32),
                 token_ids=rng.integers(0, 100, (B, 77)).astype(np.int32),
                 null_ids=np.zeros((1, 77), np.int32))
    return jpipe, params, pipe, batch


def jax_draws(step: int) -> tr.Draws:
    """The draws of JAX's loss at `step`, in the port's NCHW layout."""
    r_enc, r_t, r_noise, r_drop = jax.random.split(jax.random.fold_in(KEY, step), 4)
    shape = (B, IMG // 8, IMG // 8, 4)
    nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()
    return tr.Draws(nchw(jax.random.normal(r_enc, shape)),
                    torch.from_numpy(np.array(jax.random.randint(r_t, (B,), 0, T))).long(),
                    nchw(jax.random.normal(r_noise, shape)),
                    torch.from_numpy(np.array(jax.random.uniform(r_drop, (B,)))))


# an optax transformation that keeps, as its state, the gradient it passes on
RECORD = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def run_both(models, **kw):
    """Two steps of each framework from the same parameters; returns
    (JAX state, JAX metrics, JAX gradients per step, port state, port
    metrics, the port's initial UNet state dict). JAX's optimizer is
    chained after `RECORD`, which hands it the gradient unchanged."""
    jpipe, params, pipe, batch = models
    jcfg = jtr.SD15TrainConfig(**kw)
    cfg = tr.SD15TrainConfig(**kw)
    template = {"controlnet": params["controlnet"]}
    if not jcfg.sd_locked:
        template["unet"] = params["unet"]
    tx = optax.chain(RECORD, jtr.make_optimizer(jcfg, template))
    jstate = jtr.init_train_state(jcfg, params, tx)
    frozen = {k: params[k] for k in ("unet", "vae", "clip")}
    jstep = jax.jit(jtr.make_train_step(jpipe, jcfg, tx))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    load_jax_params(pipe, params)
    unet0 = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    state = tr.init_train_state(cfg, pipe)
    step = tr.make_train_step(pipe, cfg)
    jm, pm, grads = [], [], []
    for s in range(STEPS):
        jstate, m = jstep(jstate, frozen, jb, KEY)
        grads.append(jstate.opt_state[0])
        jm.append(m)
        pm.append(step(state, batch, jax_draws(s)))
    return jstate, jm, grads, state, pm, unet0


def assert_params_close(mine, tree, grads, ns, accum=1, lr=LR):
    """`mine` against JAX's `tree` by the bounds above; "JAX's gradient" is
    the one each update applied (the mean of `accum` micro-steps')."""
    want = state_dict_from_jax(tree)
    micro = [state_dict_from_jax(g[ns]) for g in grads]
    gs = [{k: sum(m[k] for m in micro[i:i + accum]) / accum for k in want}
          for i in range(0, len(micro), accum)]
    big = [max(v.abs().max() for v in g.values()) for g in gs]
    for k, w in want.items():
        large = torch.stack([g[k].abs() > 1e-3 * b for g, b in zip(gs, big)]).all(dim=0)
        bound = torch.where(large, 1e-3 * lr + torch.finfo(torch.float32).eps * w.abs(),
                            torch.full_like(w, 2 * lr * STEPS))
        assert ((mine[k] - w).abs() <= bound).all(), (ns, k, (mine[k] - w).abs().max().item())


def grad_norm(grads, namespaces):
    """The global norm of the gradients the optimizer updates: the
    ControlNet's, and the UNet decoder's and head's where it trains."""
    sq = sum(float((v.double() ** 2).sum()) for k, v in state_dict_from_jax(
        grads["controlnet"]).items())
    if "unet" in namespaces:
        sq += sum(float((v.double() ** 2).sum()) for k, v in state_dict_from_jax(
            grads["unet"]).items() if tr.is_unet_decoder(k))
    return sq ** 0.5


CASES = {
    "eps-locked": dict(),
    "v-locked": dict(parameterization="v"),
    "eps-unlocked": dict(sd_locked=False),
    "eps-locked-accum2-ema": dict(accum_steps=2, use_ema=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(models, case):
    kw = dict(CASES[case], drop_rate=0.3, warm_up_steps=0, learning_rate=LR)
    jstate, jm, grads, state, pm, unet0 = run_both(models, **kw)
    pipe = models[2]
    trained = ("controlnet",) if kw.get("sd_locked", True) else ("controlnet", "unet")
    for s in range(STEPS):
        np.testing.assert_allclose(float(pm[s]["loss"]), float(jm[s]["loss"]), rtol=1e-5)
        # JAX's metric counts the frozen UNet encoder's gradient too; the
        # optimizer (and the port's metric) sees the trainable set only
        rtol = 1e-5 if s == 0 else 1e-4
        np.testing.assert_allclose(float(pm[s]["grad_norm"]), grad_norm(grads[s], trained),
                                   rtol=rtol)
        if trained == ("controlnet",):
            np.testing.assert_allclose(float(pm[s]["grad_norm"]), float(jm[s]["grad_norm"]),
                                       rtol=rtol)
        assert pm[s]["lr"] == pytest.approx(float(jm[s]["lr"]), rel=1e-6)
        assert pm[s]["step"] == s
    accum = kw.get("accum_steps", 1)
    assert_params_close(pipe.controlnet.state_dict(), jstate.trainable["controlnet"], grads,
                        "controlnet", accum)
    unet = pipe.unet.state_dict()
    if "unet" in trained:
        # the decoder and head move; the encoder stays bit-equal (the frozen
        # UNet encoder is in no optimizer: the round-3 fix)
        moved = [k for k in unet if tr.is_unet_decoder(k)]
        assert moved and all(not torch.equal(unet[k], unet0[k]) for k in moved
                             if k.endswith("weight"))
        for k in unet:
            if not tr.is_unet_decoder(k):
                assert torch.equal(unet[k], unet0[k]), k
        dec = {k: v for k, v in unet.items() if tr.is_unet_decoder(k)}
        want = {k: v for k, v in state_dict_from_jax(jstate.trainable["unet"]).items()
                if tr.is_unet_decoder(k)}
        for k in dec:
            assert (dec[k] - want[k]).abs().max() <= 2 * LR * STEPS
    else:
        assert all(torch.equal(unet[k], unet0[k]) for k in unet)
    if accum > 1:
        # one optimizer update in two micro-steps: the EMA moved once
        assert state.count == 1 and state.ema.count == 1 and int(jstate.ema.count) == 1
        names = [n.split(".", 1)[1] for n in state.names]
        assert_params_close(dict(zip(names, state.ema.params)),
                            jstate.ema.params["controlnet"], grads, "controlnet", accum)


def test_trained_controlnet_crosses_to_jax_bit_for_bit(models, tmp_path):
    """A ControlNet trained two steps in the port, written by
    `export_ldm_checkpoint`, comes back through JAX's importer equal."""
    _, params, pipe, batch = models
    load_jax_params(pipe, params)
    cfg = tr.SD15TrainConfig(drop_rate=0.3, warm_up_steps=0)
    state, step = tr.init_train_state(cfg, pipe, seed=4), tr.make_train_step(pipe, cfg)
    before = {k: v.clone() for k, v in pipe.controlnet.state_dict().items()}
    for _ in range(STEPS):
        step(state, batch)
    assert any(not torch.equal(v, before[k]) for k, v in pipe.controlnet.state_dict().items())
    path = str(tmp_path / "trained.ckpt")
    export_ldm_checkpoint({"controlnet": pipe.controlnet.state_dict()}, path,
                          unet_cfg=UNetConfig(**TINY_UNET))
    tree = j_import_ldm(path, unet_cfg=junet.UNetConfig(**TINY_UNET))["controlnet"]
    back = state_dict_from_jax(tree)
    mine = pipe.controlnet.state_dict()
    assert set(back) == set(mine)
    for k in mine:
        assert torch.equal(back[k], mine[k]), k


def test_step_draws_depend_on_seed_and_step_only(models):
    """Without `draws=` a step draws from a generator seeded by (seed,
    step): two states at the same step draw the same, other steps or seeds
    differ."""
    from prompt_diffusion_tpu_torch.training.optimizer import step_generator

    shape = (2, 4, 4, 4)
    d = lambda seed, step: tr.make_draws(step_generator(seed, step, "cpu"), shape, T)
    a, b, c, e = d(1, 5), d(1, 5), d(1, 6), d(2, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.noise, c.noise) and not torch.equal(a.noise, e.noise)
    assert a.t.dtype == torch.int64 and (a.t >= 0).all() and (a.t < T).all()


# ---- data: the EditDataset copy and the shared shard permutation ---------


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return make_edit_root(str(tmp_path_factory.mktemp("edit")))


def _batches(loader_cls, ds, n, **kw):
    it = iter(loader_cls(ds, batch_size=3, seed=7, **kw))
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_edit_dataset_copy_matches_original(data_root, monkeypatch, decoder):
    """The same index, samples and batches (three epochs' worth) as the
    JAX package's EditDataset and BatchLoader, on its PIL path (its native
    path patched away) and on its native path."""
    if decoder == "pil":
        monkeypatch.setattr(jed.BatchLoader, "_make_batch_native", lambda self, s, i: None)
    pd, jd = ped.EditDataset(data_root, resolution=32), jed.EditDataset(data_root, resolution=32)
    assert len(pd) == len(jd) == 9
    for task in pd.task_list:
        assert ([r.gt_path for r in pd.file_mapping[task]]
                == [r.gt_path for r in jd.file_mapping[task]])
    a, b = pd.sample(np.random.default_rng(4), 2), jd.sample(np.random.default_rng(4), 2)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k]
    for pb, jb in zip(_batches(ped.BatchLoader, pd, 9, decoder=decoder),
                      _batches(jed.BatchLoader, jd, 9)):
        assert pb.keys() == jb.keys()
        for k in pb:
            assert np.array_equal(pb[k], jb[k]) if isinstance(pb[k], np.ndarray) else pb[k] == jb[k]
    for n, seed, epoch in ((9, 0, 0), (100, 3, 2)):
        assert np.array_equal(ped.shard_order(n, seed, epoch, 1, 4),
                              jed.shard_order(n, seed, epoch, 1, 4))


def test_loader_resumes_at_a_batch(data_root):
    """`iterate(start)` gives the batches an iteration from the first gives
    from `start` on, across an epoch boundary (3 batches an epoch)."""
    ds = ped.EditDataset(data_root, resolution=32)
    whole = _batches(ped.BatchLoader, ds, 7)
    it = ped.BatchLoader(ds, batch_size=3, seed=7).iterate(4)
    rest = [next(it) for _ in range(3)]
    it.close()
    for a, b in zip(rest, whole[4:]):
        assert a["prompt"] == b["prompt"] and np.array_equal(a["image"], b["image"])


def test_shard_permutation_is_shared():
    """Each epoch's permutation depends on (seed, epoch) only: the shards
    partition the data set (no sample twice, none skipped)."""
    for epoch in range(3):
        parts = [ped.shard_order(50, 9, epoch, s, 4) for s in range(4)]
        assert sorted(np.concatenate(parts).tolist()) == list(range(50))
    assert not np.array_equal(ped.shard_order(50, 9, 0, 0, 4), ped.shard_order(50, 9, 1, 0, 4))


# ---- the entries ----------------------------------------------------------


def _argv(root, logdir, *extra):
    return ["--data-root", root, "--logdir", logdir, "--tiny", "--device", "cpu",
            "--batch-size", "2", "--resolution", "32", "--accum-steps", "1",
            "--image-log-every", "0", *extra]


def test_train_sd15_resume_equals_an_uninterrupted_run(data_root, tmp_path):
    """train_sd15 with --use-ema and --use-checkpoint: 4 steps in one run,
    and 2 steps then `--resume` to 4, end bit-equal (masters, moments, EMA,
    step, module weights); the resumed run starts at the saved step + 1,
    and save_final keeps the last step; the UNet, VAE and CLIP stay
    unchanged."""
    extra = ("--use-ema", "--use-checkpoint", "--ckpt-every", "2")
    whole = train_sd15.main(_argv(data_root, str(tmp_path / "a"), "--max-steps", "4", *extra))
    first = train_sd15.main(_argv(data_root, str(tmp_path / "b"), "--max-steps", "2", *extra))
    assert first["start_step"] == 0
    assert sorted(os.listdir(tmp_path / "b" / "checkpoints")) == ["0", "1"]  # 1 by save_final
    resumed = train_sd15.main(_argv(data_root, str(tmp_path / "b"), "--max-steps", "4",
                                    "--resume", *extra))
    assert resumed["start_step"] == 2 and len(resumed["metrics"]) == 2
    assert sorted(os.listdir(tmp_path / "b" / "checkpoints")) == ["0", "1", "2", "3"]
    assert [m["loss"] for m in resumed["metrics"]] == [m["loss"] for m in whole["metrics"][2:]]
    a, b = whole["state"], resumed["state"]
    assert a.meta() == b.meta() and a.step == 4 and a.ema.count == 4
    ta, tb = a.tensors(), b.tensors()
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    for name, m in whole["pipe"].jax_modules().items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, resumed["pipe"].jax_modules()[name].state_dict()[k])
    fresh = train_sd15.build_pipe(True, "cpu")
    train_sd15.init_weights(fresh, 0)
    for name in ("unet", "vae", "clip"):
        for k, v in fresh.jax_modules()[name].state_dict().items():
            assert torch.equal(v, whole["pipe"].jax_modules()[name].state_dict()[k]), (name, k)
    assert any(not torch.equal(v, whole["pipe"].controlnet.state_dict()[k])
               for k, v in fresh.controlnet.state_dict().items())


def test_train_sd15_init_ckpt_without_controlnet(data_root, tmp_path):
    """--init-ckpt with an SD-only checkpoint: the ControlNet's shared
    encoder starts as the UNet's (`controlnet_init_from_unet`); the image
    log writes its PNGs."""
    src = train_sd15.build_pipe(True, "cpu")
    train_sd15.init_weights(src, 5)
    path = str(tmp_path / "sd.ckpt")
    export_ldm_checkpoint({k: v for k, v in src.state_dicts().items() if k != "controlnet"},
                          path, unet_cfg=src.unet.config, vae_ch_mult=src.vae.config.ch_mult,
                          vae_num_res_blocks=src.vae.config.num_res_blocks, clip_layers=2)
    argv = _argv(data_root, str(tmp_path / "run"), "--max-steps", "2", "--init-ckpt", path,
                 "--lr", "0")
    argv[argv.index("--image-log-every") + 1] = "1"
    out = train_sd15.main(argv)
    cn, un = out["pipe"].controlnet.state_dict(), src.unet.state_dict()
    assert torch.equal(cn["input_blocks_1_res.in_conv.weight"],
                       un["input_blocks_1_res.in_conv.weight"])
    assert torch.equal(out["pipe"].vae.state_dict()["decoder.conv_in.weight"],
                       src.vae.state_dict()["decoder.conv_in.weight"])
    assert os.path.exists(tmp_path / "run" / "image_log" / "train" / "samples_step000001.png")


def test_finetune_sd15_entry(data_root, tmp_path):
    out = finetune_sd15.main(["--data-root", data_root, "--task", "canny", "--logdir",
                              str(tmp_path), "--tiny", "--device", "cpu", "--batch-size", "2",
                              "--resolution", "32", "--max-steps", "2", "--num-supports", "3"])
    assert len(out["metrics"]) == 2 and all(np.isfinite(m["loss"]) for m in out["metrics"])
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["0", "1"]


def test_entries_refuse_fsdp_and_default_to_the_card(data_root, monkeypatch):
    """Both entries run on the card by default, decode natively where the
    decoder builds (`--loader auto`), and refuse a --num-fsdp that does not
    divide the world: without torchrun the world is one process."""
    for mod in (train_sd15, finetune_sd15):
        assert mod.parse_args(["--data-root", "x", "--task", "t"] if mod is finetune_sd15
                              else ["--data-root", "x"]).device == "cuda"
    assert train_sd15.parse_args(["--data-root", "x"]).loader == "auto"
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="--num-fsdp 2 does not divide the world size 1"):
        train_sd15.main(["--data-root", data_root, "--num-fsdp", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--num-fsdp 2 does not divide the world size 1"):
        finetune_sd15.main(["--data-root", data_root, "--task", "canny", "--num-fsdp", "2",
                            "--device", "cpu"])


def test_use_checkpoint_is_a_config_field():
    assert dataclasses.replace(UNetConfig(), use_checkpoint=True).use_checkpoint
    assert not UNetConfig().use_checkpoint and not junet.UNetConfig().use_checkpoint
