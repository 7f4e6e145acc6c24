"""Flash attention kernels K1 and K2, their plain versions and wrappers.

Replaces `prompt_diffusion_tpu/ops/flash_attention.py`:
  * K1 `flash_attention_packed` (packed (B, N, H*D) self-attention);
  * K2 `flash_attention` ((B, N, H, D) attention, the VAE mid-block).
Both go through one hand-written CUDA kernel, `csrc/flash_attention.cu`
(its header says what bounds it and how it is laid out): packed memory is
the (B, N, H, D) layout, so the kernel reads either through strides.
Inputs on the card are bf16; logits and softmax are fp32, P is rounded to
bf16 before P.V, and P.V accumulates in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel


def _torch_attention(q, k, v, scale: float, mask=None):
    """Plain attention over (B, N, H, D) (`_xla_attention`): fp32 logits,
    fp32 softmax, probabilities cast to v's dtype, fp32
    accumulation of P.V, result in v's dtype. A boolean `mask`
    broadcastable to (B, H, Nq, Nk) keeps the True positions."""
    logits = torch.matmul(q.float().permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1))
    logits = logits * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float().permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3).to(v.dtype)


def _packed_ref(q, k, v, num_heads: int, scale: float):
    """Plain attention over packed (B, N, H*D) tensors."""
    b, nq, hd = q.shape
    d = hd // num_heads
    out = _torch_attention(q.unflatten(-1, (num_heads, d)), k.unflatten(-1, (num_heads, d)),
                           v.unflatten(-1, (num_heads, d)), scale)
    return out.reshape(b, nq, hd)


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """Run the CUDA kernel on (B, N, H, D) views; returns a contiguous
    (B, Nq, H, D) tensor."""
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    b, nq, h, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, h, d) or v.shape != (b, nk, h, d):
        raise ValueError(f"q/k/v shapes disagree: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"{name} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be dense and 16-byte aligned, strides {t.stride()}")
    if d % 8 or d > 512:
        raise ValueError(f"head dim {d} not supported (needs D % 8 == 0 and D <= 512)")
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        cuda_ext().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, nq, nk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), torch.cuda.current_stream().cuda_stream)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """K2: attention over (B, N, H, D) tensors, no mask."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q):
        return _torch_attention(q, k, v, float(scale))
    out = _launch(q, k, v, float(scale))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """K1: attention over packed (B, N, H*D) tensors, the projection
    layout, with no head transposes."""
    d = q.shape[-1] // num_heads
    if scale is None:
        scale = d ** -0.5
    if not use_kernel(q):
        return _packed_ref(q, k, v, num_heads, float(scale))
    out = _launch(q.unflatten(-1, (num_heads, d)), k.unflatten(-1, (num_heads, d)),
                  v.unflatten(-1, (num_heads, d)), float(scale))
    flash_attention_packed.launches += 1
    return out.view(q.shape)


flash_attention_packed.launches = 0
