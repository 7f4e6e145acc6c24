"""PyTorch port, training ops: K1-K4 made differentiable. Each wrapper's
gradient (x and the fp32 affine, or q, k and v) through its autograd
Function against `jax.vjp` of the JAX kernel function (Pallas in interpret
mode on the CPU; its `custom_vjp` recomputes through the JAX reference), at
fp32, bound 1e-5 of the largest gradient; the CPU dispatch of the
Functions; the chunked attention recompute; and gradient checkpointing of
the tiny UNet and ControlNet, bit-equal to the plain graph."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.ops import flash_attention as jfa
from prompt_diffusion_tpu.ops.fused_group_norm import fused_group_norm as j_fused_gn
from prompt_diffusion_tpu.ops.fused_layer_norm import fused_layer_norm as j_fused_ln
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.ops import flash_attention as fa
from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import fused_layer_norm
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy, random_init_
from tests.torch_port_util import TINY_UNET

torch.set_num_threads(2)

GRAD_BOUND = 1e-5  # of the largest gradient


def _normal(rng, shape, mean=0.0):
    return (rng.normal(size=shape) + mean).astype(np.float32)


def _port_grads(fn, arrays, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(g))


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, atol=GRAD_BOUND * np.abs(b).max(),
                                   rtol=0)


def test_k1_packed_attention_grad_matches_jax_vjp():
    rng = np.random.default_rng(10)
    b, n, h, d = 2, 1024, 4, 40
    q, k, v = (_normal(rng, (b, n, h * d)) for _ in range(3))
    g = _normal(rng, (b, n, h * d))
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention_packed(*a, h), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    calls = fa.flash_attention_packed.backward_calls
    _, got = _port_grads(lambda *a: fa.flash_attention_packed(*a, h), (q, k, v), g)
    assert fa.flash_attention_packed.backward_calls == calls + 1
    _assert_grads_close(got, want)


@pytest.mark.parametrize("shape", [(2, 1024, 2, 64), (1, 1100, 1, 128)])
def test_k2_attention_grad_matches_jax_vjp(shape):
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, shape) for _ in range(3))
    g = _normal(rng, shape)
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    calls = fa.flash_attention.backward_calls
    _, got = _port_grads(lambda *a: fa.flash_attention(*a), (q, k, v), g)
    assert fa.flash_attention.backward_calls == calls + 1
    _assert_grads_close(got, want)


@pytest.mark.parametrize("act", [False, True, "relu"])
@pytest.mark.parametrize("shape,eps,mean", [((2, 16, 16, 32), 1e-5, 0.0),
                                            ((2, 16, 16, 32), 1e-6, 3.0)])
def test_k3_group_norm_grad_matches_jax_vjp(shape, eps, mean, act):
    """x, scale and bias; the JAX function takes NHWC, the port NCHW."""
    rng = np.random.default_rng(12)
    x = _normal(rng, shape, mean)
    s, bias = 1 + 0.1 * _normal(rng, (shape[-1],)), _normal(rng, (shape[-1],))
    g = _normal(rng, shape)
    silu, relu = act is True, act == "relu"
    _, vjp = jax.vjp(lambda x_, s_, b_: j_fused_gn(x_, s_, b_, 8, eps, silu, relu),
                     jnp.asarray(x), jnp.asarray(s), jnp.asarray(bias))
    gx, gs, gb = vjp(jnp.asarray(g))
    calls = fused_group_norm.backward_calls
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    st, bt = torch.from_numpy(s).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    out = fused_group_norm(xt, st, bt, 8, eps, silu, relu)
    got = torch.autograd.grad(out, (xt, st, bt), torch.from_numpy(g).permute(0, 3, 1, 2))
    assert fused_group_norm.backward_calls == calls + 1
    _assert_grads_close((got[0].permute(0, 2, 3, 1), got[1], got[2]), (gx, gs, gb))


def test_k4_layer_norm_grad_matches_jax_vjp():
    rng = np.random.default_rng(13)
    x = _normal(rng, (2, 256, 320))
    s, b = 1 + 0.1 * _normal(rng, (320,)), _normal(rng, (320,))
    g = _normal(rng, x.shape)
    _, vjp = jax.vjp(lambda *a: j_fused_ln(*a, 1e-5), *map(jnp.asarray, (x, s, b)))
    want = vjp(jnp.asarray(g))
    calls = fused_layer_norm.backward_calls
    _, got = _port_grads(lambda *a: fused_layer_norm(*a, 1e-5), (x, s, b), g)
    assert fused_layer_norm.backward_calls == calls + 1
    _assert_grads_close(got, want)


def _wrappers():
    """(wrapper, inputs: bf16 activations and fp32 affines) of K1-K4."""
    rng = np.random.default_rng(14)
    bf = lambda *s: torch.from_numpy(_normal(rng, s)).to(torch.bfloat16)
    f32 = lambda *s: torch.from_numpy(_normal(rng, s))
    return {
        "K1": (lambda q, k, v: fa.flash_attention_packed(q, k, v, 2), fa.flash_attention_packed,
               (bf(2, 64, 32), bf(2, 64, 32), bf(2, 64, 32))),
        "K2": (fa.flash_attention, fa.flash_attention, (bf(1, 64, 2, 16),) * 3),
        "K3": (lambda x, s, b: fused_group_norm(x, s, b, 4, apply_silu=True), fused_group_norm,
               (bf(2, 16, 8, 8), f32(16), f32(16))),
        "K4": (fused_layer_norm, fused_layer_norm, (bf(2, 8, 16), f32(16), f32(16))),
    }


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4"])
def test_cpu_tensors_take_the_function_and_launch_nothing(name):
    """A CPU tensor goes through the autograd Function (its backward is
    counted), launches no kernel, and gets gradients in its own shape and
    dtype; an input that needs none gets none."""
    fn, wrapper, args = _wrappers()[name]
    inputs = [a.clone().requires_grad_(i != 1) for i, a in enumerate(args)]
    launches, calls = wrapper.launches, wrapper.backward_calls
    out = fn(*inputs)
    assert out.grad_fn is not None and out.dtype == args[0].dtype
    out.float().square().sum().backward()
    assert wrapper.launches == launches and wrapper.backward_calls == calls + 1
    for i, t in enumerate(inputs):
        if i == 1:
            assert t.grad is None
        else:
            assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
            assert torch.isfinite(t.grad).all()


def test_attention_recompute_in_chunks_of_samples(monkeypatch):
    """The recompute splits the batch where a chunk's fp32 logits would pass
    the byte budget; each sample's gradient is its unchunked value."""
    rng = np.random.default_rng(15)
    q, k, v = (_normal(rng, (5, 64, 48)) for _ in range(3))
    g = _normal(rng, q.shape)
    fn = lambda *a: fa.flash_attention_packed(*a, 3)
    _, whole = _port_grads(fn, (q, k, v), g)
    monkeypatch.setattr(fa, "_BWD_LOGIT_BYTES", 2 * 4 * 3 * 64 * 64)  # two samples a chunk
    _, chunked = _port_grads(fn, (q, k, v), g)
    for a, b in zip(chunked, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("model", ["unet", "controlnet"])
def test_use_checkpoint_gives_the_same_gradients(model):
    """`UNetConfig.use_checkpoint` recomputes each ResBlock and
    SpatialTransformer in the backward pass: every parameter's gradient is
    bit-equal to the plain graph's, and the output too."""
    rng = np.random.default_rng(16)
    cfgs = [UNetConfig(**TINY_UNET), dataclasses.replace(UNetConfig(**TINY_UNET),
                                                         use_checkpoint=True)]
    x = torch.from_numpy(_normal(rng, (2, 4, 16, 16)))
    t = torch.tensor([10, 700])
    ctx = torch.from_numpy(_normal(rng, (2, 7, 64)))
    pair, query = (torch.from_numpy(_normal(rng, (2, c, 128, 128))) for c in (6, 3))
    grads, outs = [], []
    for cfg in cfgs:
        torch.manual_seed(0)
        net = (UNetSD15(cfg, fp32_policy()) if model == "unet"
               else ControlNetSD15(cfg, 6, fp32_policy()))
        random_init_(net, torch.Generator().manual_seed(17))
        out = net(x, t, ctx) if model == "unet" else torch.cat(
            [o.flatten() for o in net(x, t, pair, query, ctx)])
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad for n, p in net.named_parameters()})
    assert torch.equal(outs[0], outs[1])
    assert set(grads[0]) == set(grads[1])
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
