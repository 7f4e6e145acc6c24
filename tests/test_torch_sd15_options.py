"""PyTorch port, SD1.5 pipeline and model options against the JAX package:
`generate` with every sampler, guess mode on and off, a partial control
window, per-sample (B,1,1,1) guidance and control scales and FreeU (fp32
compute, the same weights and injected x_T); the UNet's FreeU and
`only_mid_control`; a `use_scale_shift_norm` ResBlock (fp32 and int8);
long-prompt encoding and `encode_image`'s moments."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import layers as jlayers
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.utils.dtypes import DTypePolicy as JPolicy
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.layers import ResBlock
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15, _freeu_filter
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_model, load_jax_params
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, fp32_policy
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE, nchw, nhwc, randomize

torch.set_num_threads(2)

B, IMG, STEPS = 2, 64, 3
KEY = jax.random.PRNGKey(0)
FREEU = (0.9, 0.2, 1.2, 1.4)  # (s1, s2, b1, b2), FreeU's SD1.5 values


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pipes(freeu=None):
    jpol, pol = j_fp32_policy(), fp32_policy()
    jcfg = junet.UNetConfig(**TINY_UNET, freeu=freeu)
    jpipe = JPipe(
        unet=junet.UNetSD15(config=jcfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=junet.UNetConfig(**TINY_UNET), hint_channels=6,
                                      policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jpol),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP), policy=jpol),
        schedule=JSchedule.create(),
    )
    pipe = PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET, freeu=freeu), pol),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, pol),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), pol),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP), pol),
        device="cpu",
    )
    return jpipe, pipe


@pytest.fixture(scope="module")
def pipes():
    jpipe, pipe = _pipes()
    shapes = jax.eval_shape(lambda r: jpipe.init_params(r, image_size=IMG), KEY)
    params = randomize(shapes, 21)
    load_jax_params(pipe, params)
    return jpipe, params, pipe


def _request(seed):
    rng = np.random.default_rng(seed)
    return dict(
        ids=rng.integers(0, 100, (B, 77)).astype(np.int32),
        neg=np.zeros((B, 77), np.int32),
        pair=rng.uniform(-1, 1, (B, IMG, IMG, 6)).astype(np.float32),
        query=rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
        noise=rng.normal(size=(B, IMG // 8, IMG // 8, 4)).astype(np.float32),
    )


PER_SAMPLE_G = np.asarray([4.0, 9.0], np.float32).reshape(B, 1, 1, 1)
PER_SAMPLE_C = np.asarray([0.3, 1.2], np.float32).reshape(B, 1, 1, 1)
# sampler, guess mode, guidance, control scale, control window, FreeU
CASES = {
    "unipc-per_sample-window": ("unipc", False, PER_SAMPLE_G, PER_SAMPLE_C, (0.0, 0.6), None),
    "dpm++-guess-per_sample": ("dpm++", True, PER_SAMPLE_G, PER_SAMPLE_C, (0.0, 1.0), None),
    "dpm-window-freeu": ("dpm", False, 7.5, 0.8, (0.3, 1.0), FREEU),
    "plms-guess-window": ("plms", True, 9.0, 0.7, (0.2, 0.9), None),
    "ddim-per_sample-window-guess": ("ddim", True, PER_SAMPLE_G, PER_SAMPLE_C, (0.34, 1.0),
                                     None),
}


def _as(v, jx):
    if isinstance(v, np.ndarray):
        return jnp.asarray(v) if jx else torch.from_numpy(v)
    return v


@pytest.mark.parametrize("case", list(CASES))
def test_generate_options_match_jax(pipes, case):
    """Tolerance of test_generate_matches_jax (tests/test_torch_port_pipeline.py)."""
    sampler, guess, g, c, (start, end), freeu = CASES[case]
    jpipe, params, pipe = pipes
    if freeu is not None:
        jpipe = dataclasses.replace(
            jpipe, unet=junet.UNetSD15(config=junet.UNetConfig(**TINY_UNET, freeu=freeu),
                                       policy=j_fp32_policy()))
        unet = UNetSD15(UNetConfig(**TINY_UNET, freeu=freeu), fp32_policy())
        unet.load_state_dict(pipe.unet.state_dict())
        pipe = dataclasses.replace(pipe, unet=unet.eval())
    r = _request(11)
    kw = dict(num_steps=STEPS, guess_mode=guess, sampler=sampler,
              control_guidance_start=start, control_guidance_end=end)
    ref = jpipe.jit_generate()(
        params, KEY, jnp.asarray(r["ids"]), jnp.asarray(r["neg"]), jnp.asarray(r["pair"]),
        jnp.asarray(r["query"]), guidance_scale=_as(g, True), control_scale=_as(c, True),
        init_noise=jnp.asarray(r["noise"]), **kw)
    got = pipe.generate(
        torch.from_numpy(r["ids"]), torch.from_numpy(r["neg"]), torch.from_numpy(r["pair"]),
        torch.from_numpy(r["query"]), guidance_scale=_as(g, False), control_scale=_as(c, False),
        init_noise=torch.from_numpy(r["noise"]), **kw)
    ref = np.asarray(ref)
    assert got.shape == (B, IMG, IMG, 3)
    inside = ((ref > 0.01) & (ref < 0.99)).mean()
    assert inside > 0.5, f"only {inside:.0%} of the pixels are not clipped"
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_window_and_per_sample_scales_change_the_image(pipes):
    """The options reach the model: a window that drops the control, and a
    per-sample control scale, each change the image; per-sample scales
    equal to the number give the number's image."""
    _, _, pipe = pipes
    r = {k: torch.from_numpy(v) for k, v in _request(12).items()}
    run = lambda **kw: pipe.generate(r["ids"], r["neg"], r["pair"], r["query"], num_steps=2,
                                     init_noise=r["noise"], sampler="unipc", **kw)
    base = run(control_scale=0.5)
    assert not torch.equal(base, run(control_scale=0.5, control_guidance_start=0.5))
    same = run(control_scale=torch.full((B, 1, 1, 1), 0.5),
               guidance_scale=torch.full((B, 1, 1, 1), 9.0))
    np.testing.assert_allclose(same.numpy(), base.numpy(), atol=1e-6)
    mixed = run(control_scale=torch.tensor([0.5, 1.5]).reshape(B, 1, 1, 1))
    np.testing.assert_allclose(mixed[0].numpy(), base[0].numpy(), atol=1e-6)
    assert not np.allclose(mixed[1].numpy(), base[1].numpy(), atol=1e-3)
    with pytest.raises(ValueError, match="control_guidance_start"):
        run(control_guidance_start=0.8, control_guidance_end=0.4)


def test_per_sample_control_scale_promotes_like_jax():
    """A bf16 tap times an fp32 (B,1,1,1) tensor is fp32 (JAX's
    promotion); times a Python float it stays bf16."""
    cn = ControlNetSD15(UNetConfig(**TINY_UNET), 6, DTypePolicy()).eval()
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(B, 4, 8, 8)).astype(np.float32))
    t = torch.tensor([10, 500])
    ctx = torch.from_numpy(rng.normal(size=(B, 77, 64)).astype(np.float32))
    hint = torch.zeros(B, 32, 8, 8, dtype=torch.bfloat16)
    with torch.no_grad():
        per = cn(x, t, context=ctx, guided_hint=hint,
                 conditioning_scale=torch.full((B, 1, 1, 1), 0.5))
        one = cn(x, t, context=ctx, guided_hint=hint, conditioning_scale=0.5)
    assert all(o.dtype == torch.float32 for o in per)
    assert all(o.dtype == torch.bfloat16 for o in one)


def _unet_case():
    cfg = dict(TINY_UNET, channel_mult=(1, 2, 4), attention_resolutions=(4,))
    rng = np.random.default_rng(14)
    x = rng.normal(size=(B, 8, 8, 4)).astype(np.float32)
    t = np.asarray([3, 700], np.int32)
    ctx = rng.normal(size=(B, 7, 64)).astype(np.float32)
    jm = junet.UNetSD15(config=junet.UNetConfig(**cfg), policy=j_fp32_policy())
    params = randomize(jax.eval_shape(jm.init, KEY, jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(ctx)), 15)
    # one residual per encoder tap, then the middle one (the widest)
    chans = junet.UNetConfig(**cfg).encoder_plan()[1]
    control = [rng.normal(size=(B, 8 >> lvl, 8 >> lvl, c)).astype(np.float32)
               for c, lvl in zip(chans + [chans[-1]], _levels(cfg))]
    return cfg, params, (x, t, ctx), control


def _levels(cfg):
    """The downsampling level of each encoder tap and of the middle tap."""
    plan = junet.UNetConfig(**cfg).encoder_plan()[0]
    lvl, out = 0, []
    for kind, _, _ in plan:
        if kind == "down":
            lvl += 1
        out.append(lvl)
    return out + [lvl]


@pytest.mark.parametrize("freeu,only_mid", [(None, True), (FREEU, False)])
def test_unet_freeu_and_only_mid_control_match_jax(freeu, only_mid):
    """Three levels, so FreeU meets both its 4x and its 2x model_channels
    branches."""
    cfg, params, (x, t, ctx), control = _unet_case()
    jm = junet.UNetSD15(config=junet.UNetConfig(**cfg, freeu=freeu), policy=j_fp32_policy())
    ref = jax.jit(jm.apply, static_argnames="only_mid_control")(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        control=[jnp.asarray(c) for c in control], only_mid_control=only_mid)
    port = UNetSD15(UNetConfig(**cfg, freeu=freeu), fp32_policy())
    load_jax_model(port, params)
    with torch.no_grad():
        got = nhwc(port.eval()(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                               control=[nchw(c) for c in control], only_mid_control=only_mid))
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=1e-4)


def test_freeu_filter_matches_jax():
    rng = np.random.default_rng(16)
    x = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    ref = junet._freeu_filter(jnp.asarray(x), 0.3)
    got = nhwc(_freeu_filter(nchw(x), 0.3))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_scale_shift_resblock_matches_jax(int8):
    """fp32: within 1e-4 of JAX. int8 (fp32 compute; the block's norms emit
    no int8, its convs quantize their float inputs): as close to JAX int8
    as test_int8_block_matches_jax holds the other blocks (a fifth of JAX
    int8's own distance from JAX fp32)."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    emb = rng.normal(size=(2, 128)).astype(np.float32)
    jpol = JPolicy(compute_dtype=jnp.float32, quant="int8") if int8 else j_fp32_policy()
    jm = lambda pol: jlayers.ResBlock(out_channels=64, policy=pol, use_scale_shift_norm=True)
    params = randomize(jax.eval_shape(jm(jpol).init, KEY, jnp.asarray(x), jnp.asarray(emb)), 18)
    run = lambda pol: np.asarray(jm(pol).apply(params, jnp.asarray(x), jnp.asarray(emb)))
    pol = DTypePolicy(compute_dtype=torch.float32, quant="int8" if int8 else "none")
    port = ResBlock(32, 64, 128, pol, use_scale_shift_norm=True)
    load_jax_model(port, params)
    assert port.emb_proj.weight.shape == (128, 128)
    assert not port.in_norm.quant_out and not port.out_norm.quant_out
    with torch.no_grad():
        got = nhwc(port.eval()(nchw(x), torch.from_numpy(emb)))
    ref = run(jpol)
    if not int8:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        return
    quant_err, port_err = _rel(ref, run(j_fp32_policy())), _rel(got, ref)
    assert quant_err > 1e-3, quant_err
    assert port_err <= quant_err / 5, (port_err, quant_err)


@pytest.fixture(scope="module")
def clip_pair():
    """A tiny CLIP with the real vocabulary (the windows add SOT and EOT)."""
    cfg = dict(TINY_CLIP, vocab_size=49408)
    jm = jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**cfg), policy=j_fp32_policy())
    params = randomize(jax.eval_shape(jm.init, KEY, jnp.zeros((1, 77), jnp.int32)), 19)
    jpipe = JPipe(unet=None, controlnet=None, vae=None, text_encoder=jm,
                  schedule=JSchedule.create())
    pipe = PromptDiffusionSD15(unet=None, controlnet=None, vae=None,
                               text_encoder=CLIPTextModel(CLIPTextConfig(**cfg), fp32_policy()),
                               schedule=None)
    load_jax_model(pipe.text_encoder, params)
    pipe.text_encoder.eval()
    return jpipe, {"clip": params}, pipe


@pytest.mark.parametrize("clip_skip", [0, 1])
@pytest.mark.parametrize("length", [77, 200])
def test_encode_long_prompt_matches_jax(clip_pair, clip_skip, length, monkeypatch):
    jpipe, params, pipe = clip_pair
    monkeypatch.setattr(PromptDiffusionSD15, "device", property(lambda self: torch.device("cpu")))
    rng = np.random.default_rng(20)
    ids = rng.integers(1, 49000, (B, length)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 49406, 49407
    ref = jpipe.encode_long_prompt(params, jnp.asarray(ids), windows=3, clip_skip=clip_skip)
    with torch.no_grad():
        got = pipe.encode_long_prompt(torch.from_numpy(ids), windows=3, clip_skip=clip_skip)
    assert got.shape == (B, 3 * 77, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_encode_image_moments_match_jax(pipes):
    """The moments against JAX's; the sampled latents are the moments'
    sample with the generator's noise, shifted and scaled."""
    jpipe, params, pipe = pipes
    rng = np.random.default_rng(21)
    img = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    ref = jpipe.vae.apply(params["vae"], jnp.asarray(img), method=jvae.AutoencoderKL.encode_moments)
    with torch.no_grad():
        moments = pipe.vae.encode_moments(nchw(img))
        z = pipe.encode_image(torch.from_numpy(img), torch.Generator().manual_seed(3))
    np.testing.assert_allclose(nhwc(moments), np.asarray(ref), atol=1e-4, rtol=1e-4)
    mean, logvar = moments.chunk(2, dim=1)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    cfg = pipe.vae.config
    want = (mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise - cfg.shift_factor)
    np.testing.assert_allclose(z.numpy(), nhwc(want * cfg.scale_factor), atol=1e-6)
    assert z.shape == (B, IMG // 8, IMG // 8, 4)
