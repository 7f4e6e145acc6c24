"""PyTorch port, the last kernels of the serving ops: K12 AdaLN with its
gradient and K8's xshift variant. Their plain versions against the JAX
package (its CPU paths and its Pallas kernels in interpret mode), the
xshift option through `QuantConv` and the tiny SD1.5 int8 pipeline, and the
dispatch of CPU tensors. Inputs come from numpy seeds; each test states its
bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.ops import fused_adaln as jadaln
from prompt_diffusion_tpu.ops.int8_conv import conv3x3_int8 as j_conv3x3_int8
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln
from prompt_diffusion_tpu_torch.ops.int8_conv import conv3x3_int8, conv3x3_int8_xshift
from prompt_diffusion_tpu_torch.ops.quant import QuantConv
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE, randomize

torch.set_num_threads(2)

INT8_F32 = DTypePolicy(compute_dtype=torch.float32, quant="int8")


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _adaln_inputs(seed, n, form, c=64):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (2, n, c), 2.0) + 0.5
    mod = (2, 1, c) if form == "B1C" else (2, c)
    return x, _normal(rng, mod, 0.3), _normal(rng, mod, 0.3)


# ---- K12 AdaLN ------------------------------------------------------------


@pytest.mark.parametrize("form", ["B1C", "BC"])
@pytest.mark.parametrize("n", [32, 154, 333])  # a multiple of 8, the SD3 context lengths
def test_adaln_plain_matches_jax(n, form, monkeypatch):
    """Plain K12 at fp32 within 1e-5 of the JAX CPU path (`_jnp_adaln`) and
    of the Pallas kernel (`_adaln_kernel`, rows padded to 8) in interpret
    mode; the modulation as (B, 1, C) and as (B, C)."""
    x, s, t = _adaln_inputs(n, n, form)
    got = fused_adaln(*(torch.from_numpy(a) for a in (x, s, t)))
    assert got.shape == (2, n, 64) and got.dtype == torch.float32
    args = [jnp.asarray(a) for a in (x, s, t)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jadaln.fused_adaln(*args)), atol=1e-5)
    monkeypatch.setattr(jadaln, "_FORCE_INTERPRET", True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jadaln.fused_adaln(*args)), atol=1e-5)


def test_adaln_keeps_the_input_dtype():
    """bf16 in, bf16 out: the fp32 result rounded once."""
    x, s, t = (torch.from_numpy(a) for a in _adaln_inputs(1, 20, "B1C"))
    got = fused_adaln(x.bfloat16(), s, t)
    assert got.dtype == torch.bfloat16
    want = fused_adaln(x.bfloat16().float(), s, t).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["B1C", "BC"])
def test_adaln_gradient_matches_jax(form):
    """Gradients of sum(adaln^2) in x, scale and shift, in their input
    shapes, within 1e-4 of `jax.grad` of the JAX `fused_adaln` (whose VJP
    recomputes through `_jnp_adaln`, as the port's backward does)."""
    x, s, t = _adaln_inputs(4, 24, form, c=32)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, s, t)]
    fused_adaln(*inputs).square().sum().backward()
    loss = lambda a, b, c: jnp.sum(jadaln.fused_adaln(a, b, c) ** 2)
    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(a) for a in (x, s, t)))
    for got, ref in zip(inputs, want):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


# ---- K8 xshift ------------------------------------------------------------


def _conv_inputs(seed, b, h, w, cin, cout, with_bias=True):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)  # HWIO, as JAX takes it
    s_a = rng.uniform(0.01, 0.1, (b,)).astype(np.float32)
    s_w = rng.uniform(0.001, 0.01, (cout,)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32) if with_bias else None
    return xq, s_a, wq, s_w, bias


@pytest.mark.parametrize("shape,with_bias,out_dtype", [
    ((2, 8, 8, 4, 16), True, torch.bfloat16),     # the 4-channel latent input conv
    ((2, 8, 8, 16, 16), True, torch.float32),
    ((2, 8, 8, 16, 16), False, torch.bfloat16),
    ((1, 16, 8, 48, 24), True, torch.bfloat16),   # Cin not a multiple of 32
    ((3, 5, 8, 32, 40), True, torch.float32),     # several images per 8x8-like tile
])
def test_conv3x3_int8_xshift_bit_equal_to_pallas(shape, with_bias, out_dtype):
    """Plain K8 xshift against the TPU kernel `_conv_kernel_xshift` in
    interpret mode, and against the port's im2col variant: bit-equal."""
    b, h, w, cin, cout = shape
    xq, s_a, wq, s_w, bias = _conv_inputs(cin + h, b, h, w, cin, cout, with_bias)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = j_conv3x3_int8(jnp.asarray(xq), jnp.asarray(s_a), jnp.asarray(wq), jnp.asarray(s_w),
                         None if bias is None else jnp.asarray(bias), out_dtype=jdt,
                         interpret=True, variant="xshift")
    args = (torch.from_numpy(xq), torch.from_numpy(s_a),
            torch.from_numpy(wq.transpose(3, 0, 1, 2).copy()), torch.from_numpy(s_w),
            None if bias is None else torch.from_numpy(bias), out_dtype)
    got = conv3x3_int8(*args, variant="xshift")
    assert got.dtype == out_dtype and got.shape == (b, h, w, cout)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    assert torch.equal(got, conv3x3_int8(*args, variant="im2col"))
    assert torch.equal(got, conv3x3_int8_xshift(*args))


def test_unknown_conv_variant_raises():
    xq, s_a, wq, s_w, bias = (torch.from_numpy(a) for a in _conv_inputs(0, 1, 4, 4, 8, 8))
    with pytest.raises(ValueError, match="variant"):
        conv3x3_int8(xq, s_a, wq.permute(3, 0, 1, 2), s_w, bias, variant="winograd")
    with pytest.raises(ValueError, match="conv_variant"):
        QuantConv(8, 8, 3, padding=1, conv_variant="winograd")
    with pytest.raises(ValueError, match="conv_variant"):
        PromptDiffusionSD15.create(device="cpu", conv_variant="winograd")


def test_quant_conv_xshift_equals_im2col():
    """A QuantConv 3x3 under either variant gives the same bits."""
    conv = QuantConv(16, 24, 3, padding=1, out_dtype=torch.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(_normal(np.random.default_rng(2), (24, 16, 3, 3))))
    x = torch.from_numpy(_normal(np.random.default_rng(3), (2, 16, 8, 8)))
    im2col = conv(x)
    conv.conv_variant = "xshift"
    assert torch.equal(conv(x), im2col)


def test_cpu_tensors_take_the_plain_adaln_and_xshift_versions():
    """On the CPU, K12 (forward and backward) and K8 xshift run their plain
    versions and count no launch."""
    counted = (fused_adaln, conv3x3_int8_xshift, conv3x3_int8)
    before = [f.launches for f in counted]
    x = torch.randn(2, 5, 16, requires_grad=True)
    fused_adaln(x, torch.zeros(2, 16), torch.zeros(2, 1, 16)).sum().backward()
    xq, s_a, wq, s_w, bias = (torch.from_numpy(a) for a in _conv_inputs(1, 1, 4, 4, 8, 8))
    conv3x3_int8(xq, s_a, wq.permute(3, 0, 1, 2).contiguous(), s_w, bias, variant="xshift")
    assert [f.launches for f in counted] == before


# ---- the tiny SD1.5 int8 pipeline under both variants ----------------------


B, IMG = 2, 64


def _port_pipe(conv_variant):
    return PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET), INT8_F32),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, INT8_F32),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), INT8_F32),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP),
                                   DTypePolicy(compute_dtype=torch.float32)),
        device="cpu", conv_variant=conv_variant)


def test_int8_pipeline_xshift_bit_equal_to_im2col():
    """The tiny int8 pipeline (int8 UNet, ControlNet and VAE; batch 2, 64²,
    2 DDIM steps, CFG 9) with weights from the JAX tree through the bridge:
    `conv_variant="xshift"` reaches every QuantConv and gives the im2col
    pipeline's images bit for bit."""
    jpipe = JPipe(
        unet=junet.UNetSD15(config=junet.UNetConfig(**TINY_UNET), policy=j_fp32_policy()),
        controlnet=jcn.ControlNetSD15(config=junet.UNetConfig(**TINY_UNET), hint_channels=6,
                                      policy=j_fp32_policy()),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=j_fp32_policy()),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP),
                                         policy=j_fp32_policy()),
        schedule=JSchedule.create())
    params = randomize(jax.eval_shape(lambda r: jpipe.init_params(r, image_size=IMG),
                                      jax.random.PRNGKey(0)), 40)
    rng = np.random.default_rng(41)
    request = (torch.from_numpy(rng.integers(0, 100, (B, 77))),
               torch.zeros((B, 77), dtype=torch.int64),
               torch.from_numpy(rng.uniform(-1, 1, (B, IMG, IMG, 6)).astype(np.float32)),
               torch.from_numpy(rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)))
    noise = torch.from_numpy(_normal(rng, (B, IMG // 8, IMG // 8, 4)))
    images = {}
    for variant in ("im2col", "xshift"):
        pipe = _port_pipe(variant)
        load_jax_params(pipe, params)
        convs = [m for model in pipe.jax_modules().values() for m in model.modules()
                 if isinstance(m, QuantConv)]
        assert convs and all(m.conv_variant == variant for m in convs)
        images[variant] = pipe.generate(*request, num_steps=2, guidance_scale=9.0,
                                        init_noise=noise)
    assert images["im2col"].shape == (B, IMG, IMG, 3)
    assert torch.isfinite(images["im2col"]).all()
    assert torch.equal(images["xshift"], images["im2col"])
