"""PyTorch port, sharded training, generate and FID over torch.distributed:
two gloo ranks on the CPU (`tests/torch_dist_util.py`) against the port's
one-rank step and JAX's unsharded `make_train_step` on the tiny configs at
fp32, the port fed JAX's draws for the global batch.

Bounds, as `tests/test_multidevice.py` holds the JAX package's meshes: the
loss within 2e-5 relative, grad_norm within 1e-4, the parameter update
within 5e-3 relative (1e-10 absolute) of the one-rank port's wherever it
is a whole Adam step (`_assert_updates_close` says how the rest, and the
update against JAX, are held). A restored checkpoint continues bit for bit; ranks hold equal
modules; sharded generate within 1e-4 / 1e-5 of the unsharded images at
fp32, and under the int8 policy (fp32 compute; DDIM eta 0 and 1) and in
bf16 with eta 0.5 within `GENERATE_REL_L2` (the CPU's convolutions round a
batch of 2 apart from a batch of 4, and int8 codes or bf16 roundings can
flip on that), with the mutations that would break the sharded numbers (a
rank-local int8 scale, rank-local step noise) shown to fall outside those
bounds; the FID statistics within 1e-5 of JAX's single-process ones."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prompt_diffusion_tpu.evaluation import fid as jfid
from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import controlnet_sd3 as jcn3
from prompt_diffusion_tpu.models import mmdit_sd3 as jmm
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3 as JPipe3
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.training import sd3 as jtr3
from prompt_diffusion_tpu.training import sd15 as jtr
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.data import edit_dataset as ped
from prompt_diffusion_tpu_torch.ops import quant
from prompt_diffusion_tpu_torch.parallel import mesh as pmesh
from prompt_diffusion_tpu_torch.pipelines import sharded
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.training import checkpoint as ckpt
from prompt_diffusion_tpu_torch.training import sd3 as tr3
from prompt_diffusion_tpu_torch.training import sd15 as tr
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy
from tests import torch_dist_util as du
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE, make_edit_root, randomize

torch.set_num_threads(2)

B, IMG, T, LR, WORLD = 4, 32, 1000, 1e-4, 2
KEY = jax.random.PRNGKey(1)
MESHES = ((1, 2), (2, 1))
CFG = dict(drop_rate=0.3, warm_up_steps=0, learning_rate=LR)
# an optax transformation that keeps, as its state, the gradient it passes on
RECORD = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def jax_draws(step: int, b=B, img=IMG) -> tr.Draws:
    """JAX's draws at `step` for the global batch, NCHW."""
    r_enc, r_t, r_noise, r_drop = jax.random.split(jax.random.fold_in(KEY, step), 4)
    shape = (b, img // 8, img // 8, 4)
    nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()
    return tr.Draws(nchw(jax.random.normal(r_enc, shape)),
                    torch.from_numpy(np.array(jax.random.randint(r_t, (b,), 0, T))).long(),
                    nchw(jax.random.normal(r_noise, shape)),
                    torch.from_numpy(np.array(jax.random.uniform(r_drop, (b,)))))


def fid_w():
    return np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def sd15(tmp_path_factory):
    """JAX's unsharded step, the port's one-rank runs, and every check of
    `du.sd15_train_worker` on two ranks, from one set of tiny weights."""
    jpol = j_fp32_policy()
    ucfg = junet.UNetConfig(**TINY_UNET)
    jpipe = JPipe(
        unet=junet.UNetSD15(config=ucfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jpol),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP), policy=jpol),
        schedule=JSchedule.create())
    params = randomize(jax.eval_shape(lambda r: jpipe.init_params(r, image_size=IMG),
                                      jax.random.PRNGKey(0)), 31)
    rng = np.random.default_rng(3)
    batch = dict(image=rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
                 query=rng.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32),
                 example_pair=rng.uniform(-1, 1, (B, IMG, IMG, 6)).astype(np.float32),
                 token_ids=rng.integers(0, 100, (B, 77)).astype(np.int32),
                 null_ids=np.zeros((1, 77), np.int32))

    jcfg = jtr.SD15TrainConfig(**CFG)
    tx = optax.chain(RECORD, jtr.make_optimizer(jcfg, {"controlnet": params["controlnet"]}))
    jstate = jtr.init_train_state(jcfg, params, tx)
    frozen = {k: params[k] for k in ("unet", "vae", "clip")}
    jstate1, jm = jax.jit(jtr.make_train_step(jpipe, jcfg, tx))(
        jstate, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, KEY)
    jax_out = {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
               "controlnet": state_dict_from_jax(jstate1.trainable["controlnet"]),
               "grads": {"controlnet": state_dict_from_jax(jstate1.opt_state[0]["controlnet"])}}

    pipe = du.tiny_sd15()
    load_jax_params(pipe, params)
    state_dicts = {n: {k: v.clone() for k, v in m.state_dict().items()}
                   for n, m in pipe.jax_modules().items()}
    draws = [jax_draws(0), jax_draws(1)]
    one = {}
    state = tr.init_train_state(tr.SD15TrainConfig(**CFG), pipe)
    one["step"] = du.step_record(state, tr.make_train_step(pipe, tr.SD15TrainConfig(**CFG))(
        state, batch, draws[0]), {"controlnet": pipe.controlnet})
    one["local_bytes"] = state.local_bytes()
    du.load(pipe, state_dicts)
    cfg = tr.SD15TrainConfig(**CFG, accum_steps=2, use_ema=True)
    state = tr.init_train_state(cfg, pipe)
    step = tr.make_train_step(pipe, cfg)
    one["accum_losses"] = [float(step(state, batch, draws[s])["loss"]) for s in range(2)]
    one["accum_tensors"] = {k: v.clone() for k, v in state.tensors().items()}
    one["accum_meta"] = state.meta()

    du.load(pipe, state_dicts)
    g_rng = np.random.default_rng(8)
    gen = dict(token_ids=torch.from_numpy(g_rng.integers(0, 100, (B, 77))),
               neg_token_ids=torch.zeros((B, 77), dtype=torch.int64),
               example_pair=torch.from_numpy(g_rng.uniform(-1, 1, (B, IMG, IMG, 6))).float(),
               query=torch.from_numpy(g_rng.uniform(-1, 1, (B, IMG, IMG, 3))).float(),
               num_steps=2, guidance_scale=9.0)
    one["generate"] = pipe.generate(**gen, generator=torch.Generator().manual_seed(5))
    one["variants"], one["quant_calls"] = {}, {}
    for name, (policy, eta) in du.GENERATE_VARIANTS.items():
        calls = []
        with mock.patch.object(quant, "quant_act", _recording(quant.quant_act, calls)):
            one["variants"][name] = du.load(du.tiny_sd15(policy), state_dicts).generate(
                **gen, eta=eta, generator=torch.Generator().manual_seed(5))
        one["quant_calls"][name] = len(calls)

    f_rng = np.random.default_rng(1)
    fid_inputs = {"images": f_rng.uniform(0, 1, (64, 8, 8, 3)).astype(np.float32),
                  "batches": du.np_batches(f_rng, (19, 16, 5))}
    workdir = str(tmp_path_factory.mktemp("sd15_dist"))
    ranks = du.spawn(du.sd15_train_worker, WORLD, workdir, {
        "state_dicts": state_dicts, "batch": batch, "draws": draws, "cfg": CFG,
        "meshes": MESHES, "generate": gen, "generate_seed": 5, "fid": fid_inputs,
        "fid_w": fid_w()})
    return dict(jax=jax_out, one=one, ranks=ranks, state_dicts=state_dicts, batch=batch,
                draws=draws, workdir=workdir, fid=fid_inputs)


def _update(after, before):
    return {k: after[k].double() - before[k].double() for k in before}


def _assert_updates_close(mine, ref, jax_ref, jax_grads, params):
    """The sharded update against the one-rank port's and JAX's, where
    JAX's gradient exceeds 1e-3 of the namespace's largest: within 5e-3
    relative (1e-10 absolute) of the port's, 1e-3 lr (and one fp32 rounding
    of the parameter) of JAX's; elsewhere
    within 2 lr of both (AdamW moves a parameter by about lr whatever its
    gradient's size, so a gradient at the rounding noise, which the batch
    split and the framework reorder, may step either way:
    `tests/test_torch_train_sd15.py`'s rule)."""
    big = max(g.abs().max() for g in jax_grads.values())
    for k in ref:
        live = jax_grads[k].abs() > 1e-3 * big
        np.testing.assert_allclose(mine[k][live].numpy(), ref[k][live].numpy(), rtol=5e-3,
                                   atol=1e-10, err_msg=k)
        ulp = torch.finfo(torch.float32).eps * params[k].double().abs()
        assert ((mine[k] - jax_ref[k]).abs() <= 1e-3 * LR + ulp)[live].all(), k
        for other in (ref, jax_ref):
            assert ((mine[k] - other[k]).abs()[~live] <= 2 * LR).all(), k


@pytest.mark.parametrize("shape", MESHES)
def test_sd15_sharded_step_matches_one_rank_and_jax(sd15, shape):
    got, one, jx = sd15["ranks"][0]["steps"][shape], sd15["one"]["step"], sd15["jax"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["loss"], jx["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], jx["grad_norm"], rtol=1e-4)
    before = sd15["state_dicts"]["controlnet"]
    mine = _update(got["params"]["controlnet"], before)
    ref = _update(one["params"]["controlnet"], before)
    assert max(v.abs().max() for v in ref.values()) > 0
    _assert_updates_close(mine, ref, _update(jx["controlnet"], before),
                          jx["grads"]["controlnet"], before)


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_hold_equal_modules_and_a_chunk_of_the_state(sd15, shape):
    """After the gather every rank's ControlNet is the same bit for bit;
    with fsdp 2 a rank holds half of the flat state (up to one aligned
    chunk's padding), with fsdp 1 all of it."""
    a, b = (r["steps"][shape] for r in sd15["ranks"])
    for k, v in a["params"]["controlnet"].items():
        assert torch.equal(v, b["params"]["controlnet"][k]), k
    whole, held = sd15["one"]["local_bytes"], a["local_bytes"]
    pad = 3 * 4 * pmesh.ALIGN * (len(sd15["state_dicts"]["controlnet"]) + 1)
    assert whole / shape[1] <= held <= whole / shape[1] + pad


def test_sd15_accumulation_and_ema_sharded(sd15):
    """accum_steps=2 with the EMA on a 1 x 2 mesh: two micro-steps, one
    update; the gathered state against the one-rank run's."""
    got, one = sd15["ranks"][0]["accum"], sd15["one"]
    np.testing.assert_allclose(got["losses"], one["accum_losses"], rtol=2e-5)
    assert got["meta"] == one["accum_meta"]
    assert got["meta"]["count"] == 1 and got["meta"]["ema_count"] == 1
    ref = one["accum_tensors"]
    assert got["tensors"].keys() == ref.keys()
    before = {f"controlnet.{k}": v for k, v in sd15["state_dicts"]["controlnet"].items()}
    # the update's gradient is the micro-steps' mean, mu / (1 - b1): live where
    # it exceeds 1e-3 of the largest, as in `_assert_updates_close`
    mu = {k.split("/", 1)[1]: v for k, v in ref.items() if k.startswith("mu/")}
    big = max(v.abs().max() for v in mu.values())
    for kind in ("master", "ema"):
        for name, b in before.items():
            live = mu[name].abs() > 1e-3 * big
            d_mine = got["tensors"][f"{kind}/{name}"].double() - b.double()
            d_want = ref[f"{kind}/{name}"].double() - b.double()
            np.testing.assert_allclose(d_mine[live].numpy(), d_want[live].numpy(), rtol=5e-3,
                                       atol=1e-10, err_msg=f"{kind}/{name}")
            assert ((d_mine - d_want).abs()[~live] <= 2 * LR).all(), (kind, name)
    for key, want in ref.items():
        kind = key.split("/", 1)[0]
        v = got["tensors"][key]
        if kind == "acc":
            assert not v.any() and not want.any()  # emptied by the update
        elif kind in ("mu", "nu"):  # the moments of the mean gradient
            scale = max(t.abs().max() for k, t in ref.items() if k.startswith(kind + "/"))
            np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=1e-3,
                                       atol=1e-4 * scale.item(), err_msg=key)


def test_sharded_checkpoint_roundtrip(sd15, tmp_path):
    """Saved after step 0 on 1 x 2 in the one-card format: restored at
    world size 2 the state is bit-equal and its next step equals the
    uninterrupted run's bit for bit; restored at world size 1 (here) the
    tensors are bit-equal and its next step agrees within the bounds."""
    r0, r1 = (r["ckpt"] for r in sd15["ranks"])
    assert r0["at"] == r1["at"] == 0 and r0["restored_equal"] and r1["restored_equal"]
    for r in (r0, r1):
        assert r["resumed"]["loss"] == r["on"]["loss"]
        for k, v in r["on"]["params"]["controlnet"].items():
            assert torch.equal(v, r["resumed"]["params"]["controlnet"][k]), k
    pipe = du.load(du.tiny_sd15(), sd15["state_dicts"])
    cfg = tr.SD15TrainConfig(**CFG, use_ema=True)
    state = tr.init_train_state(cfg, pipe)
    manager = ckpt.make_manager(os.path.join(sd15["workdir"], "ckpt"), save_every=1)
    state, at = ckpt.restore_state(manager, state)
    manager.close()
    assert at == 0
    mine = state.tensors()
    assert mine.keys() == r0["saved"].keys()
    for k, v in r0["saved"].items():
        assert torch.equal(mine[k], v), k
    m = tr.make_train_step(pipe, cfg)(state, sd15["batch"], sd15["draws"][1])
    np.testing.assert_allclose(float(m["loss"]), r0["on"]["loss"], rtol=2e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), r0["on"]["grad_norm"], rtol=1e-4)


def test_generate_sharded_equals_unsharded(sd15):
    """Two ranks, each its 2 of the 4 requests, x_T drawn for the whole
    batch from the same seeded generator; gathered images within the JAX
    test's bounds of the unsharded call's."""
    for r in sd15["ranks"]:
        np.testing.assert_allclose(r["generate"].numpy(), sd15["one"]["generate"].numpy(),
                                   rtol=1e-4, atol=1e-5)


def _recording(fn, log):
    """`fn`, recording each call."""
    def wrapped(*args, **kwargs):
        log.append(args)
        return fn(*args, **kwargs)
    return wrapped


# The sharded SD1.5 images against the unsharded ones under each of
# `du.GENERATE_VARIANTS`, relative L2 over the batch, by compute dtype. The
# CPU's convolutions round a batch of 2 apart from a batch of 4 (fp32:
# 1.2e-6 here): under the int8 policy such a rounding can move an
# activation across a code boundary (measured 2.8e-4 at eta 0, 2.4e-7 at eta
# 1), and in bf16 CFG 9 makes a flipped rounding of epsilon a visible step
# (measured 2.2e-3). The mutations land outside the fp32 bound: a
# rank-local int8 scale 5.5e-2, eta's step noise drawn for the rank's rows
# alone 4.7e-3.
GENERATE_REL_L2 = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


def _generate_close(got, want, name):
    """Whether a sharded SD1.5 image batch is within its variant's bound
    (`GENERATE_REL_L2`) of the unsharded one."""
    got, want = got.numpy().astype(np.float64), want.numpy().astype(np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    return rel <= GENERATE_REL_L2[du.GENERATE_VARIANTS[name][0].compute_dtype]


@pytest.mark.parametrize("name", list(du.GENERATE_VARIANTS))
def test_generate_sharded_int8_and_eta_equal_unsharded(sd15, name):
    """Two ranks, each its 2 of the 4 requests, under the int8 policy
    (fp32 compute) with DDIM eta 0 and 1, and in bf16 with eta 0.5: within
    the variant's bound of the unsharded call.
    Each int8 activation quantized from a float tensor takes its amax over
    both ranks (one MAX all-reduce per quantized tensor: as many as the
    unsharded call's `quant_act` calls); eta's step noise is drawn for the
    whole batch at every step and cut to the rank's rows."""
    want = sd15["one"]["variants"][name]
    n_quant = sd15["one"]["quant_calls"][name]
    assert (n_quant > 0) == (du.GENERATE_VARIANTS[name][0].quant == "int8")
    for r in sd15["ranks"]:
        got, all_reduces = r["variants"][name]
        assert got.shape == want.shape and _generate_close(got, want, name)
        assert all_reduces == n_quant


def test_generate_sharded_mutations_fall_outside_the_bounds(sd15):
    """The bounds above see the sharding: the int8 scale taken over the
    rank's rows alone (no all-reduce) and eta's step noise drawn for the
    rank's rows alone (int8, eta 1) each land outside their variant's
    bound."""
    for r in sd15["ranks"]:
        assert not _generate_close(r["variants"]["rank_local_scale"],
                                   sd15["one"]["variants"]["int8"], "int8")
        assert not _generate_close(r["variants"]["rank_local_noise"],
                                   sd15["one"]["variants"]["int8_eta"], "int8_eta")


class _Mesh:
    """A mesh of two ranks, for the checks `generate_sharded` makes before
    it touches a process group."""

    def size(self, dim=None):
        return 2


def test_generate_sharded_refusals():
    """Refused before any model runs: a batch the ranks do not divide. The
    int8 policy and DDIM with eta > 0, refused before, are accepted (the
    tests above)."""
    int8 = du.tiny_sd15(DTypePolicy(compute_dtype=torch.float32, quant="int8"))
    with pytest.raises(ValueError, match="a batch of 3 does not divide over 2 ranks"):
        sharded.generate_sharded(int8, _Mesh(), query=torch.zeros((3, 32, 32, 3)), eta=0.5,
                                 generator=torch.Generator().manual_seed(0))


def test_fid_sharded_matches_jax_single_process(sd15):
    """`compute_stats_sharded` (64 images over 2 ranks) and the streaming
    form with partial batches (19, 16, 5: tails counted on rank 0) against
    JAX's single-process `compute_stats_from_iterator`, the feature
    function of `test_fid_psum_matches_single_process`; within 1e-5
    relative, or 1e-5 of the largest entry (the frameworks round the fp32
    features apart)."""
    w = jnp.asarray(fid_w())
    feature_fn = lambda x01: jnp.mean(x01, axis=(1, 2)) @ w
    imgs, batches = sd15["fid"]["images"], sd15["fid"]["batches"]
    single = jfid.compute_stats_from_iterator(feature_fn, iter([imgs[:40], imgs[40:]]), 16)
    stream = jfid.compute_stats_from_iterator(feature_fn, iter(batches), 16)
    for r in sd15["ranks"]:
        for got, want, n in ((r["fid"], single, 64), (r["fid_stream"], stream, 40)):
            assert got.count == want.count == n
            for a, b in ((got.raw_sum, want.raw_sum), (got.raw_outer, want.raw_outer)):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_loader_shards_partition_an_epoch(tmp_path):
    """The threaded BatchLoaders of shard 0 and of shard 1 (native decoder,
    batch 1) read disjoint samples whose union is the data set, over one
    epoch (`scripts/multiprocess_sim.py`'s partition check)."""
    from prompt_diffusion_tpu_torch.native import load_batch

    ds = ped.EditDataset(make_edit_root(str(tmp_path)), resolution=32)
    n = len(ds)
    seen = []
    for shard in range(2):
        it = ped.BatchLoader(ds, batch_size=1, seed=4, shard_id=shard, num_shards=2).iterate()
        seen.append([next(it)["image"][0].tobytes() for _ in range((n - shard + 1) // 2)])
        it.close()
    paths = [r.gt_path for r in ds.file_mapping[ds.task_list[0]]]
    whole = {load_batch([p], 32, to_m11=True)[0].tobytes() for p in paths}
    a, b = set(seen[0]), set(seen[1])
    assert len(whole) == n and len(a) == len(seen[0]) and len(b) == len(seen[1])
    assert not (a & b) and a | b == whole


def test_batch_slice_and_mesh_refusals(sd15):
    """`batch_slice` without a mesh is the batch; a 1 x 3 mesh over two
    ranks is refused."""
    x = torch.arange(6)
    assert pmesh.batch_slice(x, None) is x and pmesh.world_size(None) == 1
    d = tr.Draws(*(torch.ones(4) for _ in range(4)))
    assert pmesh.batch_slice(d, None) == d
    for r in sd15["ranks"]:
        assert r["refusal"] == "a 1x3 mesh needs 3 ranks, the world has 2"


# ---- the entries under torchrun --------------------------------------------


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    from PIL import Image

    root = make_edit_root(str(tmp_path_factory.mktemp("edit")), res=64)
    png_dir = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(6)
    for i in range(7):
        Image.fromarray(rng.integers(0, 255, (24, 20, 3), dtype=np.uint8)).save(
            png_dir / f"{i}.png")
    ranks = du.spawn(du.entries_worker, WORLD, str(tmp_path_factory.mktemp("entries")),
                     {"root": root, "png_dir": str(png_dir)})
    return ranks, str(png_dir)


def test_train_sd15_under_torchrun_resumes_bit_for_bit(entries):
    """`train_sd15 --num-fsdp 2` on two ranks (a 1 x 2 mesh, batch 1 a
    rank): three steps whole, and two then `--resume` to three, end
    bit-equal (masters, moments, EMA, counters); the losses are the
    ranks' mean, the same on both."""
    ranks, _ = entries
    for r in ranks:
        whole, resumed = r["sd15"]["whole"], r["sd15"]["resumed"]
        assert whole["mesh"] == resumed["mesh"] == (1, 2)
        assert resumed["start"] == 2 and resumed["losses"] == whole["losses"][2:]
        assert resumed["meta"] == whole["meta"] and whole["meta"]["step"] == 3
        assert whole["tensors"].keys() == resumed["tensors"].keys()
        for k, v in whole["tensors"].items():
            assert torch.equal(v, resumed["tensors"][k]), k
    assert ranks[0]["sd15"]["whole"]["losses"] == ranks[1]["sd15"]["whole"]["losses"]


def test_entries_run_under_torchrun(entries):
    """finetune_sd15 and train_sd3 (a 2 x 1 mesh) take a step on two ranks,
    `fid ref --sharded` gives the single-process statistics, and a global
    batch the two ranks do not divide is refused."""
    ranks, png_dir = entries
    for r in ranks:
        assert all(np.isfinite(v) for v in r["losses"]["finetune"] + r["losses"]["sd3"])
        assert r["sd3_mesh"] == (2, 1)
        assert r["refusal"] == "--batch-size 3 must be divisible by the mesh's 2 data-parallel ranks"
    from prompt_diffusion_tpu_torch.evaluation import fid

    single = fid.compute_stats_from_iterator(
        fid.default_feature_fn("cpu")[0], fid._image_dir_batches(png_dir, 3), 2048, "cpu")
    for r in ranks:
        got = r["fid"]
        assert got.count == single.count == 7
        np.testing.assert_allclose(got.raw_sum, single.raw_sum, rtol=1e-6,
                                   atol=1e-6 * np.abs(single.raw_sum).max())
        np.testing.assert_allclose(got.raw_outer, single.raw_outer, rtol=1e-6,
                                   atol=1e-6 * np.abs(single.raw_outer).max())


# ---- SD3 ------------------------------------------------------------------

TCFG, CLIP3, VAE3 = du.TCFG, du.SD3_CLIP, du.SD3_VAE
B3, IMG3, L3 = 2, 64, 20


@pytest.fixture(scope="module")
def sd3(tmp_path_factory):
    jp = j_fp32_policy()
    mm = lambda: jmm.MMDiTConfig(**TCFG)
    jclip_ = lambda: jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**CLIP3), policy=jp)
    jpipe = JPipe3(transformer=jmm.SD3Transformer(config=mm(), policy=jp),
                   controlnet=jcn3.SD3ControlNet(config=mm(), policy=jp),
                   down_proj=jcn3.SupportPairDownProj(policy=jp),
                   vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**VAE3), policy=jp),
                   clip_l=jclip_(), clip_g=jclip_(), t5=None)
    k, lat_n = jax.random.PRNGKey(0), IMG3 // 8
    lat, t = jnp.zeros((1, lat_n, lat_n, 4)), jnp.zeros((1,))
    ctx, pooled = jnp.zeros((1, L3, 64)), jnp.zeros((1, 56))
    img, ids = jnp.zeros((1, IMG3, IMG3, 3)), jnp.zeros((1, 77), jnp.int32)
    params = randomize({
        "transformer": jax.eval_shape(jpipe.transformer.init, k, lat, t, ctx, pooled),
        "controlnet": jax.eval_shape(jpipe.controlnet.init, k, lat, t, lat, lat, ctx, pooled),
        "down_proj": jax.eval_shape(jpipe.down_proj.init, k, img, img),
        "vae": jax.eval_shape(jpipe.vae.init, k, img),
        "clip_l": jax.eval_shape(jpipe.clip_l.init, k, ids),
        "clip_g": jax.eval_shape(jpipe.clip_g.init, k, ids)}, 61)
    rng = np.random.default_rng(5)
    im = lambda: rng.uniform(-1, 1, (B3, IMG3, IMG3, 3)).astype(np.float32)
    batch = dict(image=im(), control=im(), support_cond=im(), support_image=im(),
                 context=rng.normal(size=(B3, L3, 64)).astype(np.float32),
                 pooled=rng.normal(size=(B3, 56)).astype(np.float32))
    key = jax.random.PRNGKey(2)
    r = jax.random.split(jax.random.fold_in(key, 0), 5)
    shape = (B3, lat_n, lat_n, 4)
    nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()
    draws = tr3.SD3Draws(nchw(jax.random.normal(r[0], shape)),
                         torch.from_numpy(np.array(jax.random.normal(r[1], (B3,)))),
                         nchw(jax.random.normal(r[2], shape)), nchw(jax.random.normal(r[3], shape)),
                         nchw(jax.random.normal(r[4], shape)))

    jcfg = jtr3.SD3TrainConfig(learning_rate=LR)
    tx = optax.chain(RECORD, jtr3.make_sd3_optimizer(jcfg))
    jstate = jtr3.init_sd3_train_state(jcfg, params, tx)
    frozen = {k: params[k] for k in ("transformer", "vae", "clip_l", "clip_g")}
    jstate1, jm = jax.jit(jtr3.make_sd3_train_step(jpipe, jcfg, tx))(
        jstate, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jax_out = {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
               **{ns: state_dict_from_jax(jstate1.trainable[ns])
                  for ns in ("controlnet", "down_proj")},
               "grads": {ns: state_dict_from_jax(jstate1.opt_state[0][ns])
                         for ns in ("controlnet", "down_proj")}}

    pipe = du.tiny_sd3()
    load_jax_params(pipe, params)
    state_dicts = {n: {k: v.clone() for k, v in m.state_dict().items()}
                   for n, m in pipe.jax_modules().items()}
    cfg = tr3.SD3TrainConfig(learning_rate=LR)
    state = tr3.init_sd3_train_state(cfg, pipe)
    one = du.step_record(state, tr3.make_sd3_train_step(pipe, cfg)(state, batch, draws),
                         {"controlnet": pipe.controlnet, "down_proj": pipe.down_proj})
    # generate reads CLIP's second to last layer: a pipeline with two,
    # random weights from a seed
    pipe = du.tiny_sd3(2, 64)
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for m in pipe.jax_modules().values():
            for v in m.parameters():
                v.copy_(torch.randn(v.shape, generator=g) * (0.2 if v.ndim > 1 else 0.05))
    gen_state_dicts = {n: {k: v.clone() for k, v in m.state_dict().items()}
                       for n, m in pipe.jax_modules().items()}
    g_rng = np.random.default_rng(9)
    ids = lambda: torch.from_numpy(g_rng.integers(0, 100, (B3, 77)))
    im = lambda: torch.from_numpy(g_rng.uniform(-1, 1, (B3, IMG3, IMG3, 3))).float()
    gen = dict(prompt_ids={"l": ids(), "g": ids()}, neg_prompt_ids={"l": ids(), "g": ids()},
               control_image=im(), support_cond=im(), support_image=im(), num_steps=2)
    one_gen = pipe.generate(**gen, generator=torch.Generator().manual_seed(3))
    int8_gen = du.load(du.tiny_sd3(2, 64, du.INT8_F32), gen_state_dicts).generate(
        **gen, generator=torch.Generator().manual_seed(3))
    ranks = du.spawn(du.sd3_train_worker, WORLD, str(tmp_path_factory.mktemp("sd3_dist")), {
        "state_dicts": state_dicts, "batch": batch, "draws": [draws],
        "cfg": {"learning_rate": LR}, "meshes": ((1, 2),), "generate": gen,
        "generate_seed": 3, "generate_state_dicts": gen_state_dicts})
    return dict(jax=jax_out, one=one, ranks=ranks, state_dicts=state_dicts, generate=one_gen,
                generate_int8=int8_gen)


def test_sd3_sharded_step_matches_one_rank_and_jax(sd3):
    got, one, jx = sd3["ranks"][0][(1, 2)], sd3["one"], sd3["jax"]
    for want in (one, jx):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    for ns in ("controlnet", "down_proj"):
        before = sd3["state_dicts"][ns]
        _assert_updates_close(_update(got["params"][ns], before),
                              _update(one["params"][ns], before), _update(jx[ns], before),
                              jx["grads"][ns], before)
    b = sd3["ranks"][1][(1, 2)]
    for ns in ("controlnet", "down_proj"):
        for k, v in got["params"][ns].items():
            assert torch.equal(v, b["params"][ns][k]), (ns, k)


def test_sd3_generate_sharded_equals_unsharded(sd3):
    """SD3 over two ranks: the support pair's and the query condition's VAE
    sampling noise and x_T drawn for the whole batch in `generate`'s order,
    each rank its request; within the SD1.5 test's bounds."""
    for r in sd3["ranks"]:
        np.testing.assert_allclose(r["generate"].numpy(), sd3["generate"].numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_sd3_generate_sharded_int8_equals_unsharded(sd3):
    """SD3 under the int8 policy (fp32 compute) over two ranks: within the
    fp32 test's bounds of the unsharded call. Every int8 site of the MMDiT
    and the ControlNet takes a kernel's per-row pair (K13, K10, K11), so
    no activation scale spans the batch and nothing is all-reduced."""
    assert not np.array_equal(sd3["generate_int8"].numpy(), sd3["generate"].numpy())
    for r in sd3["ranks"]:
        got, all_reduces = r["generate_int8"]
        np.testing.assert_allclose(got.numpy(), sd3["generate_int8"].numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert all_reduces == 0
