"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Tiny SD1.5 configurations for both packages, random parameters drawn with
numpy (every leaf non-trivial, so zero-initialised convs carry signal), and
layout helpers. JAX runs on the CPU with 'highest' matmul precision
(tests/conftest.py); the port's CPU matmuls and convs are full fp32.
"""

import os

import numpy as np
import torch

torch.set_num_threads(2)

TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1,), num_heads=4, context_dim=64)
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
TINY_CLIP = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128)


def randomize(params, seed: int):
    """Same tree, every leaf redrawn from numpy: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1), biases N(0, 0.1), embeddings N(0, 0.5)."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = leaf.shape
        if name == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
            v = rng.normal(0.0, std, shape)
        elif name == "scale":
            v = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name == "bias":
            v = rng.normal(0.0, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.5, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def nchw(a) -> torch.Tensor:
    """NHWC numpy array -> NCHW channels_last torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def make_edit_root(root, groups=2, per_group=5, res=32,
                   tasks=("canny", "depth", "hed", "normal"), seed=0):
    """laion_nonhuman/<group>/<name>.jpg with every task's condition and a
    caption; the EditDataset and the meta dataset both read it."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = lambda: Image.fromarray(rng.integers(0, 255, (res, res, 3), dtype=np.uint8))
    for g in range(groups):
        base = os.path.join(root, "laion_nonhuman", f"group{g}")
        for t in tasks:
            os.makedirs(os.path.join(base, t), exist_ok=True)
        for i in range(per_group):
            img().save(os.path.join(base, f"img{i}.jpg"))
            for t in tasks:
                img().save(os.path.join(base, t, f"img{i}.jpg"))
            with open(os.path.join(base, f"img{i}.txt"), "w") as f:
                f.write(f"a photograph {g} {i}")
    return root


def jax_int8_attention(q, k, v, num_heads, scale):
    """The TPU kernel `_fa_packed_fullk_int8_kernel` in interpret mode on
    packed (B, N, H*D) JAX arrays, with the host-side K quantization of
    `flash_attention.py:391-395` written out (the public wrapper takes the
    bf16 kernel on a CPU backend). Any head width; Nk may differ from Nq."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from prompt_diffusion_tpu.ops import flash_attention as jflash

    b, n, hd = q.shape
    d = hd // num_heads
    nk = k.shape[1]
    kf = k.astype(jnp.float32).reshape(b, nk, num_heads, d)
    skh = jnp.maximum(jnp.max(jnp.abs(kf), axis=(1, 3)) / 127.0, 1e-8)
    ki = jnp.clip(jnp.round(kf / skh[:, None, :, None]), -127, 127).astype(jnp.int8)
    ki = ki.reshape(b, nk, hd)
    row = lambda i: (i, 0, 0)
    return pl.pallas_call(
        functools.partial(jflash._fa_packed_fullk_int8_kernel, scale=scale, num_heads=num_heads),
        out_shape=jax.ShapeDtypeStruct((b, n, hd), q.dtype),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, n, hd), row), pl.BlockSpec((1, nk, hd), row),
                  pl.BlockSpec((1, 1, num_heads), row), pl.BlockSpec((1, nk, hd), row)],
        out_specs=pl.BlockSpec((1, n, hd), row),
        interpret=True,
    )(q, ki, skh[:, None, :], v)


def jax_lab(name):
    """A JAX attention lab of `tools/` (no package), loaded by file path."""
    import importlib.util

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    spec = importlib.util.spec_from_file_location(f"jax_lab_{name}",
                                                  os.path.join(tools, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_lab_bhnd(kernel, qkv, block_q, **kw):
    """A lab kernel over (B, H, N, D) blocks of `block_q` query rows and the
    whole K and V in interpret mode, as `attn_variants.make_variant` builds
    it."""
    import functools

    import jax
    from jax.experimental import pallas as pl

    b, h, n, d = qkv[0].shape
    kv = pl.BlockSpec((1, 1, n, d), lambda i, j, qb: (i, j, 0, 0))
    return pl.pallas_call(
        functools.partial(kernel, **kw),
        out_shape=jax.ShapeDtypeStruct((b, h, n, d), qkv[0].dtype),
        grid=(b, h, n // block_q),
        in_specs=[pl.BlockSpec((1, 1, block_q, d), lambda i, j, qb: (i, j, qb, 0)), kv, kv],
        out_specs=pl.BlockSpec((1, 1, block_q, d), lambda i, j, qb: (i, j, qb, 0)),
        interpret=True,
    )(*qkv)
