"""The attention labs on the card: the four JAX labs of `tools/` in one
module, a section and a `--lab` name each.

    python3 -m prompt_diffusion_tpu_torch.tools.attn_lab [--lab variants|lab2|lab3|int8] [--iters N]

  variants  tools/attn_variants.py: online softmax (L1) and the
            no-softmax pass (L2) across query and key tiles, the full-K
            kernels (BHND and packed) as the two-pass mode (L3); SD1.5 64²
            self-attention, B=8, N=4096, H=8, D=40.
  lab2      tools/attn_lab2.py: the packed full-K kernel with the scale in
            the kernel, with q pre-scaled in bf16 (scale 1), across query
            tiles, and with the heads as a batch dimension.
  lab3      tools/attn_lab3.py: heads zero-padded to D' = 64 and 128; the
            first 40 columns are held against the D = 40 plain version.
  int8      tools/attn_int8_lab.py at the SD3 joint shape (2, 4250, 24, 64),
            q = k = v as the lab runs it: v1 and v3 are K9, v2 is K9 with
            per-row K scales (L4), beside K1 in bf16; scheme error against
            exact attention at N = 1178.

Every variant prints the kernel's median time over CUDA events (not the
JAX labs' scan method), its TFLOP/s over 4·B·H·N²·D (the labs' count), the
time of `scaled_dot_product_attention` on the same inputs for the softmax
variants, the least time the card could take (`tools/timing.py::roofline`)
and the max abs error against the plain version evaluated in fp32 on the
same bf16 inputs. L1, L2 and L3 run the warpgroup kernel
(`ops/csrc/attention_sm90_lab.cu`, `_lab_two_pass.cu`) at every tile it
instantiates at their D (`sm90_lab_tiles`); beside each, a `[parent]` line
gives the parent design (`flash_attention.cu`'s `fa_narrow_kernel`,
through `_parent_launch`) at the tile of `lab_parent_tile`: its time and
its error against the same plain version. L4 (v2) runs the warpgroup
kernel's int8 mode with per-key scales on K9's plan, its `[parent]` line
`int8_attention.cu`'s `int8_attn_kernel` (`_int8_parent_launch`, at
`int8_block_q` rows), both with their prologue. It needs one CUDA card;
without one it exits 2.

The TPU kernels' knobs and what stands for them here:
  * block_q 128-2048 -> L1, L2 and L3: 64 query rows per consumer
    warpgroup, 128 or 192 a block (two or three consumers; three at D <=
    64); L4: K9's plan (192 rows at the lab's N); the parent: 64 or 128
    (4 or 8 warps). A block's shared memory (227 KB) and registers hold
    far fewer rows than VMEM;
  * block_k -> L1, L2 and L3: 64 or 128 keys per tile; L4: 112 (K9's on
    three consumers); the parent 32, 64 or 128; the full-K kernels' whole
    logits row -> the two-pass mode;
  * dimension_semantics ("parallel") -> none: every grid axis of a CUDA
    launch runs in parallel over the 132 SMs;
  * vmem_limit_bytes -> the dynamic shared memory the launch asks for;
  * the row pad to 256 -> masked query and key tails in the kernel;
  * heads as an MXU batch dimension -> the kernel's (batch, head) grid.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
from prompt_diffusion_tpu_torch.ops.flash_attention import (
    _int8_parent_launch,
    _parent_launch,
    attention_no_softmax,
    flash_attention_packed,
    flash_attention_packed_int8,
    flash_attention_packed_int8_rowk,
    flash_attention_tiled,
    flash_attention_two_pass,
    int8_block_q,
    lab_parent_tile,
    sm90_lab_tiles,
)
from prompt_diffusion_tpu_torch.tools.timing import card, roofline, time_ms

LABS = ("variants", "lab2", "lab3", "int8")
B, N, H, D = 8, 4096, 8, 40  # the bf16 labs: SD1.5 64² self-attention, CFG batch 8
INT8_B, INT8_N, INT8_H, INT8_D = 2, 4096 + 154, 24, 64  # SD3 joint attention
INT8_CHECK_N = 1024 + 154  # attn_int8_lab.py's correctness length
INT8_PARENT_BLOCK_K = 64  # int8_attn_kernel's key tile (csrc/int8_attention.cu)


def _fp32(args):
    return tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
                 for a in args)


def measure(name, fn, args, work, iters, library=None, reference=None, parent=None):
    """One variant: kernel ms, TFLOP/s over `work` (bytes, int8 ops, bf16
    ops, lab FLOPs, exponentials), library ms, bound and max abs error
    against the plain version of `fn` in fp32 on the same inputs, or
    against `reference()` (run under `plain_ops`) over its columns. With
    `parent` (`_parent`, `_int8_parent`: a call on the same inputs, its
    tile and its kernel's name) also the parent design's ms and error,
    printed on a `[parent]` line."""
    nbytes, int8_ops, bf16_ops, flops, exps = work
    out = fn(*args)
    with plain_ops():
        ref = fn(*_fp32(args)) if reference is None else reference()
    err_of = lambda o: (o[..., :ref.shape[-1]].float() - ref.float()).abs().max().item()
    err, top = err_of(out), ref.abs().max().item()
    parent_err = None if parent is None else err_of(parent[0](*args))
    del out, ref
    ms = time_ms(lambda: fn(*args), iters=iters)
    lib_ms = None if library is None else time_ms(library, iters=iters)
    bound_ms, bound_by = roofline(nbytes, int8_ops, bf16_ops, exps)
    row = {"variant": name, "ms": ms, "tflops": flops / ms / 1e9, "sdpa_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
           "err_over_max": err / top}
    lib = "" if lib_ms is None else f" sdpa_ms={lib_ms:.4f}"
    print(f"[attn_lab] {name:40s} ms={ms:.4f} TFLOP/s={row['tflops']:.1f}{lib} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={err:.3g} "
          f"(/max {err / top:.3g})", flush=True)
    if parent is not None:
        call, tile, kernel = parent
        row.update(parent_tile=tile, parent_ms=time_ms(lambda: call(*args), iters=iters),
                   parent_max_abs_err=parent_err, parent_err_over_max=parent_err / top)
        print(f"[attn_lab] [parent] {name:31s} {kernel} bq{tile[0]} bk{tile[1]} "
              f"ms={row['parent_ms']:.4f} TFLOP/s={flops / row['parent_ms'] / 1e9:.1f} "
              f"max_abs_err={parent_err:.3g} (/max {parent_err / top:.3g})", flush=True)
    return row


def _parent(mode, tile, scale, view=lambda t: t):
    """The parent design beside the sm90 kernel's lab mode at `tile`: its
    `mode` at `lab_parent_tile(tile)` on the (B, N, H, D) `view` of the
    variant's arguments; (call, its tile, its kernel)."""
    ptile = lab_parent_tile(tile)
    return ((lambda q, k, v: _parent_launch(view(q), view(k), view(v), scale, mode, ptile)),
            ptile, "fa_narrow_kernel")


def _int8_parent(heads, scale, nq):
    """The parent design beside L4: `int8_attn_kernel` with per-row K at
    `int8_block_q(nq)` query rows (its tile: those rows and its 64-key
    tiles); (call, its tile, its kernel)."""
    return ((lambda q, k, v: _int8_parent_launch(q, k, v, heads, scale, True)),
            (int8_block_q(nq), INT8_PARENT_BLOCK_K), "int8_attn_kernel")


def _inputs(gen, shape, n=3, scale=1.0):
    return [(torch.randn(shape, generator=gen, device=gen.device) * scale).to(torch.bfloat16)
            for _ in range(n)]


def _bf16_work(b, n, h, d, softmax=True):
    flops = 4 * b * h * n * n * d
    return 8 * b * n * h * d, 0, flops, flops, b * h * n * n if softmax else 0


# ---- tools/attn_variants.py ------------------------------------------------


def lab_variants(gen, iters):
    """BHND inputs (B, H, N, D), read by the kernels as (B, N, H, D) views,
    then the packed full-K kernel (`--packed` in the JAX lab)."""
    scale = D ** -0.5
    q, k, v = _inputs(gen, (B, H, N, D))
    bnhd = [t.transpose(1, 2) for t in (q, k, v)]
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    work = _bf16_work(B, N, H, D)
    rows = []
    for tile in sm90_lab_tiles(D, "tiled"):
        rows.append(measure(f"online bq{tile[0]} bk{tile[1]}",
                            lambda q, k, v, tile=tile: flash_attention_tiled(q, k, v, scale, *tile),
                            bnhd, work, iters, sdpa, parent=_parent("online", tile, scale)))
    for tile in sm90_lab_tiles(D, "no_softmax"):
        rows.append(measure(f"online-nosoftmax bq{tile[0]} bk{tile[1]}",
                            lambda q, k, v, tile=tile: attention_no_softmax(q, k, v, scale, *tile),
                            bnhd, _bf16_work(B, N, H, D, softmax=False), iters,
                            parent=_parent("no_softmax", tile, scale)))
    for tile in sm90_lab_tiles(D, "two_pass"):
        rows.append(measure(f"fullk (two-pass) bq{tile[0]} bk{tile[1]}",
                            lambda q, k, v, tile=tile: flash_attention_two_pass(
                                q, k, v, scale, *tile),
                            bnhd, work, iters, sdpa, parent=_parent("two_pass", tile, scale)))
    packed = [t.transpose(1, 2).reshape(B, N, H * D) for t in (q, k, v)]
    heads = lambda t: t.view(B, N, H, D)
    for tile in ((128, 64), (192, 64)):
        rows.append(measure(f"fullk_packed (two-pass) bq{tile[0]} bk{tile[1]}",
                            lambda q, k, v, tile=tile: flash_attention_two_pass(
                                heads(q), heads(k), heads(v), scale, *tile),
                            packed, work, iters, sdpa,
                            parent=_parent("two_pass", tile, scale, heads)))
    rows.append(measure("current packed (K1)",
                        lambda q, k, v: flash_attention_packed(q, k, v, H, scale),
                        packed, work, iters, sdpa))
    return rows


# ---- tools/attn_lab2.py ----------------------------------------------------


def lab_lab2(gen, iters):
    """A: scale in the kernel; B, C: q pre-scaled in bf16 outside, the
    kernel at scale 1, at both query tiles; D: heads as a batch dimension,
    which on the card is the kernel's (batch, head) grid, so D is B's
    launch."""
    scale = D ** -0.5
    q, k, v = _inputs(gen, (B, N, H * D))
    q_scaled = q * torch.tensor(scale, dtype=torch.bfloat16, device=q.device)
    heads = lambda t: t.view(B, N, H, D)
    sdpa = lambda q_, s_: (lambda: F.scaled_dot_product_attention(
        *(heads(t).transpose(1, 2) for t in (q_, k, v)), scale=s_))
    work = _bf16_work(B, N, H, D)
    two_pass = lambda s_, tile: (lambda q_, k_, v_: flash_attention_two_pass(
        heads(q_), heads(k_), heads(v_), s_, *tile))
    runs = (("A  packed fullk bq128 (scale in kernel)", q, scale, (128, 64)),
            ("B  prescaled-q bq128", q_scaled, 1.0, (128, 64)),
            ("C  prescaled-q bq192", q_scaled, 1.0, (192, 64)),
            ("D  batched-heads bq128 (= B's grid)", q_scaled, 1.0, (128, 64)),
            ("D2 batched-heads bq192 (= C's grid)", q_scaled, 1.0, (192, 64)))
    return [measure(name, two_pass(s_, tile), (q_, k, v), work, iters, sdpa(q_, s_),
                    parent=_parent("two_pass", tile, s_, heads))
            for name, q_, s_, tile in runs]


# ---- tools/attn_lab3.py ----------------------------------------------------


def lab_lab3(gen, iters):
    """Heads zero-padded from D = 40 to D' = 64 or 128, q pre-scaled by
    40^-0.5, the kernel at scale 1; the first 40 columns of each head
    against the plain version of the unpadded problem (the padding adds
    nothing to the logits and only zero output columns)."""
    q, k, v = _inputs(gen, (B, N, H, D))
    q = q * torch.tensor(D ** -0.5, dtype=torch.bfloat16, device=q.device)
    rows = []
    for dp in (64, 128):
        padded = [F.pad(t, (0, dp - D)) for t in (q, k, v)]
        sdpa = lambda p=padded: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in p), scale=1.0)
        for tile in sm90_lab_tiles(dp, "two_pass"):
            rows.append(measure(
                f"P{dp} (two-pass) bq{tile[0]} bk{tile[1]}",
                lambda q_, k_, v_, tile=tile: flash_attention_two_pass(q_, k_, v_, 1.0, *tile),
                padded, (8 * B * N * H * dp, 0, 4 * B * H * N * N * dp, 4 * B * H * N * N * D,
                         B * H * N * N),
                iters, sdpa, reference=lambda: flash_attention_two_pass(*_fp32((q, k, v)), 1.0),
                parent=_parent("two_pass", tile, 1.0)))
    return rows


# ---- tools/attn_int8_lab.py ------------------------------------------------


def lab_int8(gen, iters):
    """v1 (the shipped kernel) and v3 (per-head K scales) are K9; v2 is
    K9 with per-row K scales; the bf16 baseline is K1. First the scheme
    error of v2 and v3 against exact attention at N = 1178."""
    b, n, h, d = INT8_B, INT8_N, INT8_H, INT8_D
    scale = d ** -0.5
    xs = _inputs(gen, (b, INT8_CHECK_N, h * d), n=1, scale=0.5)[0]
    with plain_ops():
        exact = flash_attention_packed(*_fp32((xs, xs, xs)), h, scale)
    for name, fn in (("v2 int8-QK/bf16-PV", flash_attention_packed_int8_rowk),
                     ("v3 +per-head K scale", flash_attention_packed_int8)):
        out = fn(xs, xs, xs, h, scale).float()
        rel = ((out - exact).norm() / exact.norm()).item()
        print(f"[attn_lab] {name}: rel l2 vs exact = {rel:.4f} at N={INT8_CHECK_N}", flush=True)
    x = _inputs(gen, (b, n, h * d), n=1, scale=0.5)[0]
    heads = lambda t: t.view(b, n, h, d).transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(heads(x), heads(x), heads(x), scale=scale)
    ops = 2 * b * n * n * h * d
    int8_work = (8 * b * n * h * d, ops, ops, 2 * ops, b * h * n * n)
    runs = (("v1 shipped int8 (K9)", flash_attention_packed_int8, int8_work, None),
            ("v2 int8-QK/bf16-PV (per-row K)", flash_attention_packed_int8_rowk, int8_work,
             _int8_parent(h, scale, n)),
            ("v3 +per-head K scale (K9)", flash_attention_packed_int8, int8_work, None),
            ("bf16 packed (K1, baseline)", flash_attention_packed, _bf16_work(b, n, h, d), None))
    return [measure(name, lambda q, k, v, fn=fn: fn(q, k, v, h, scale), (x, x, x), work, iters,
                    sdpa, parent=parent) for name, fn, work, parent in runs]


RUNS = {"variants": lab_variants, "lab2": lab_lab2, "lab3": lab_lab3, "int8": lab_int8}


def run(labs=LABS, iters=10, seed=0, device="cuda"):
    """Runs the named labs on `device` (the card); returns {lab: [row, ...]}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    results = {}
    for lab in labs:
        print(f"[attn_lab] --- {lab} ---", flush=True)
        results[lab] = RUNS[lab](gen, iters)
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lab", choices=LABS, action="append",
                    help="a lab to run (repeatable; all when not given)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_lab: no CUDA device", file=sys.stderr)
        return 2
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    cuda_ext()
    print(f"[attn_lab] {card()} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    run(args.lab or LABS, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
