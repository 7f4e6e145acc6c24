"""PyTorch port, SD3 training: the port's flow-matching train step against
JAX's `make_sd3_train_step` over two steps at fp32 on tiny configurations
(the port fed the five draws JAX makes from `fold_in(rng, step)`), for
each weighting scheme and with EDM preconditioning; the support pair's
gradient path beside the inference path under `no_grad`; and the
`train_sd3` entry on a temporary data root, with staged T5 and resume.

Bounds as in tests/test_torch_train_sd15.py: the loss within 1e-5
relative, grad_norm within 1e-5 at the first step and 1e-4 at the second,
the ControlNet's and down_proj's parameters within 1e-3 lr (plus one fp32
rounding of their value) where JAX's gradient exceeds 1e-3 of the
namespace's largest in both steps, else within 2 lr x steps."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd3 as jcn
from prompt_diffusion_tpu.models import mmdit_sd3 as jmm
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3 as JPipe
from prompt_diffusion_tpu.training import sd3 as jtr
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch import train_sd3
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet, SupportPairDownProj
from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.training import sd3 as tr
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.test_tokenizers import T5_VOCAB
from tests.torch_port_util import make_edit_root, randomize

torch.set_num_threads(2)

TCFG = dict(sample_size=8, patch_size=2, in_channels=4, num_layers=2, attention_head_dim=16,
            num_attention_heads=4, joint_attention_dim=64, caption_projection_dim=64,
            pooled_projection_dim=56, out_channels=4, pos_embed_max_size=16)
CLIP = dict(vocab_size=100, hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64)
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=4,
                scale_factor=1.5305, shift_factor=0.0609)
B, IMG, L, STEPS, LR = 2, 64, 20, 2, 1e-4
LAT = IMG // 8
KEY = jax.random.PRNGKey(2)
# an optax transformation that keeps, as its state, the gradient it passes on
RECORD = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def models():
    jp = j_fp32_policy()
    mm = lambda: jmm.MMDiTConfig(**TCFG)
    jclip_ = lambda: jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**CLIP), policy=jp)
    jpipe = JPipe(transformer=jmm.SD3Transformer(config=mm(), policy=jp),
                  controlnet=jcn.SD3ControlNet(config=mm(), policy=jp),
                  down_proj=jcn.SupportPairDownProj(policy=jp),
                  vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jp),
                  clip_l=jclip_(), clip_g=jclip_(), t5=None)
    k = jax.random.PRNGKey(0)
    lat, t = jnp.zeros((1, LAT, LAT, 4)), jnp.zeros((1,))
    ctx, pooled = jnp.zeros((1, L, 64)), jnp.zeros((1, 56))
    img, ids = jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, 77), jnp.int32)
    params = randomize({
        "transformer": jax.eval_shape(jpipe.transformer.init, k, lat, t, ctx, pooled),
        "controlnet": jax.eval_shape(jpipe.controlnet.init, k, lat, t, lat, lat, ctx, pooled),
        "down_proj": jax.eval_shape(jpipe.down_proj.init, k, img, img),
        "vae": jax.eval_shape(jpipe.vae.init, k, img),
        "clip_l": jax.eval_shape(jpipe.clip_l.init, k, ids),
        "clip_g": jax.eval_shape(jpipe.clip_g.init, k, ids)}, 60)
    pol = fp32_policy()
    pipe = PromptDiffusionSD3.create(
        transformer=SD3Transformer(MMDiTConfig(**TCFG), pol),
        controlnet=SD3ControlNet(MMDiTConfig(**TCFG), pol), down_proj=SupportPairDownProj(pol),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), pol),
        clip_l=CLIPTextModel(CLIPTextConfig(**CLIP), pol),
        clip_g=CLIPTextModel(CLIPTextConfig(**CLIP), pol), device="cpu")
    rng = np.random.default_rng(5)
    img = lambda: rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    batch = dict(image=img(), control=img(), support_cond=img(), support_image=img(),
                 context=rng.normal(size=(B, L, 64)).astype(np.float32),
                 pooled=rng.normal(size=(B, 56)).astype(np.float32))
    return jpipe, params, pipe, batch


def jax_draws(step: int) -> tr.SD3Draws:
    """The five draws of JAX's SD3 loss at `step`, NCHW."""
    r = jax.random.split(jax.random.fold_in(KEY, step), 5)
    shape = (B, LAT, LAT, 4)
    nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()
    return tr.SD3Draws(nchw(jax.random.normal(r[0], shape)),
                       torch.from_numpy(np.array(jax.random.normal(r[1], (B,), jnp.float32))),
                       nchw(jax.random.normal(r[2], shape)), nchw(jax.random.normal(r[3], shape)),
                       nchw(jax.random.normal(r[4], shape)))


def _params_close(mine, tree, micro, lr=LR):
    want = state_dict_from_jax(tree)
    gs = [state_dict_from_jax(g) for g in micro]
    big = [max(v.abs().max() for v in g.values()) for g in gs]
    for k, w in want.items():
        large = (gs[0][k].abs() > 1e-3 * big[0]) & (gs[1][k].abs() > 1e-3 * big[1])
        bound = torch.where(large, 1e-3 * lr + torch.finfo(torch.float32).eps * w.abs(),
                            torch.full_like(w, 2 * lr * STEPS))
        assert ((mine[k] - w).abs() <= bound).all(), (k, (mine[k] - w).abs().max().item())


@pytest.mark.parametrize("scheme,precondition", [
    ("logit_normal", False), ("uniform", False), ("sigma_sqrt", False),
    ("logit_normal", True), ("sigma_sqrt", True)])
def test_sd3_train_step_matches_jax(models, scheme, precondition):
    jpipe, params, pipe, batch = models
    kw = dict(weighting_scheme=scheme, precondition_outputs=precondition, learning_rate=LR)
    jcfg, cfg = jtr.SD3TrainConfig(**kw), tr.SD3TrainConfig(**kw)
    tx = optax.chain(RECORD, jtr.make_sd3_optimizer(jcfg))
    jstate = jtr.init_sd3_train_state(jcfg, params, tx)
    frozen = {k: params[k] for k in ("transformer", "vae", "clip_l", "clip_g")}
    jstep = jax.jit(jtr.make_sd3_train_step(jpipe, jcfg, tx))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    load_jax_params(pipe, params)
    before = {n: {k: v.clone() for k, v in getattr(pipe, n).state_dict().items()}
              for n in ("transformer", "vae")}
    state, step = tr.init_sd3_train_state(cfg, pipe), tr.make_sd3_train_step(pipe, cfg)
    grads = []
    for s in range(STEPS):
        jstate, jm = jstep(jstate, frozen, jb, KEY)
        grads.append(jstate.opt_state[0])
        pm = step(state, batch, jax_draws(s))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5 if s == 0 else 1e-4)
        assert pm["step"] == s
    for ns in ("controlnet", "down_proj"):
        _params_close(getattr(pipe, ns).state_dict(), jstate.trainable[ns],
                      [g[ns] for g in grads])
    for n, sd in before.items():  # frozen
        assert all(torch.equal(v, getattr(pipe, n).state_dict()[k]) for k, v in sd.items())


def test_support_pair_gradient_path(models):
    """`support_pair_latents` records the gradient to down_proj through the
    VAE encoder; `encode_support_pair` (inference) records none and gives
    the same latents for the same noise."""
    _, params, pipe, batch = models
    load_jax_params(pipe, params)
    pipe.down_proj.requires_grad_(True)
    try:
        cond, gt = (torch.from_numpy(batch[k]) for k in ("support_cond", "support_image"))
        noise = torch.randn((B, 4, LAT, LAT), generator=torch.Generator().manual_seed(0))
        lat = pipe.support_pair_latents(cond, gt, noise=noise)
        lat.square().sum().backward()
        assert all(p.grad is not None and p.grad.abs().sum() > 0
                   for p in pipe.down_proj.parameters())
        inf = pipe.encode_support_pair(cond, gt, torch.Generator().manual_seed(0))
        assert inf.grad_fn is None and torch.equal(inf, lat.detach())
    finally:
        pipe.down_proj.requires_grad_(False)
        pipe.down_proj.zero_grad(set_to_none=True)


def test_train_sd3_entry_staged_t5_and_resume(tmp_path_factory):
    """`train_sd3 --tiny --device cpu` with a T5 tokenizer: T5 runs staged
    over the data set's prompts and is freed; 3 steps, then `--resume` to
    4 starts at step 3; the transformer and VAE stay unchanged, the
    ControlNet and down_proj move; `--num-fsdp 2` is refused without
    torchrun (a world of one)."""
    root = make_edit_root(str(tmp_path_factory.mktemp("sd3data")), res=64)
    assets = tmp_path_factory.mktemp("t5")
    (assets / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": "Unigram", "vocab": [list(p) for p in T5_VOCAB]}}))
    logdir = str(tmp_path_factory.mktemp("sd3run"))
    argv = ["--data-root", root, "--logdir", logdir, "--tiny", "--device", "cpu",
            "--batch-size", "2", "--resolution", "64", "--ckpt-every", "2",
            "--t5-assets", str(assets)]
    first = train_sd3.main(argv + ["--max-steps", "3"])
    assert first["pipe"].t5 is None  # staged and freed
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints"))) == ["0", "2"]
    resumed = train_sd3.main(argv + ["--max-steps", "4", "--resume"])
    assert resumed["start_step"] == 3 and len(resumed["metrics"]) == 1
    assert np.isfinite(resumed["metrics"][0]["loss"])
    fresh = train_sd3.build_pipe(True, "cpu", with_t5=True)
    gen = torch.Generator().manual_seed(0)
    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    for m in fresh.jax_modules().values():
        random_init_(m, gen)
    for name in ("transformer", "vae", "clip_l", "clip_g", "controlnet", "down_proj"):
        same = all(torch.equal(v, getattr(resumed["pipe"], name).state_dict()[k])
                   for k, v in getattr(fresh, name).state_dict().items())
        assert same == (name not in ("controlnet", "down_proj")), name
    assert train_sd3.parse_args(["--data-root", "x"]).device == "cuda"
    with pytest.raises(SystemExit, match="--num-fsdp 2 does not divide the world size 1"):
        train_sd3.main(["--data-root", root, "--num-fsdp", "2", "--device", "cpu"])
