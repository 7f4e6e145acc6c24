"""PyTorch port, K5 (GroupNorm(+SiLU) -> int8) and K7 (GEGLU -> int8) on the
card: the sites of one SD1.5 int8 denoise step and of the int8 VAE decode,
derived from the port's models; K5's launch plan (`ops/gn_quant.py::
gn_plan`) at each of them; an emulation of `csrc/gn_quant.cu`'s arithmetic
(its chunks, merges and endpoint amax) against the plain version; the
refusals of both launchers before any build; and the CPU routing. The
kernels themselves run only on the card (`chip_smoke.py`,
`tools/quant_tune.py --part check`)."""

import collections
import importlib
import pkgutil

import numpy as np
import pytest
import torch

import prompt_diffusion_tpu_torch.ops as port_ops
from prompt_diffusion_tpu_torch.ops import _build
from prompt_diffusion_tpu_torch.ops import gn_quant as gq
from prompt_diffusion_tpu_torch.ops import row_quant as rq
from prompt_diffusion_tpu_torch.ops.fused_act import fused_geglu_quant
from prompt_diffusion_tpu_torch.ops.fused_group_norm import (
    _torch_group_norm_quant,
    fused_group_norm_quant,
)

torch.set_num_threads(2)

# K5's calls of one SD1.5 int8 denoise step (ControlNet + UNet at 512², CFG
# batch 8 for a request of 4) as (C, H, SiLU, eps): count, 87 in all; the
# int8 VAE decode's at 512² (batch 4), 29; K7's rows (N tokens, 2I), 23.
SD15_K5 = {(1280, 8, True, 1e-5): 19, (320, 64, True, 1e-5): 11, (640, 32, True, 1e-5): 9,
           (1280, 16, True, 1e-5): 9, (320, 64, False, 1e-6): 7, (640, 32, False, 1e-6): 7,
           (1280, 16, False, 1e-6): 7, (2560, 8, True, 1e-5): 3, (320, 32, True, 1e-5): 2,
           (640, 16, True, 1e-5): 2, (1280, 8, False, 1e-6): 2, (2560, 16, True, 1e-5): 2,
           (640, 64, True, 1e-5): 2, (1920, 16, True, 1e-5): 1, (1920, 32, True, 1e-5): 1,
           (1280, 32, True, 1e-5): 1, (960, 32, True, 1e-5): 1, (960, 64, True, 1e-5): 1}
VAE_K5 = {(512, 64, True, 1e-6): 10, (512, 128, True, 1e-6): 6, (256, 256, True, 1e-6): 5,
          (128, 512, True, 1e-6): 5, (512, 64, False, 1e-6): 1, (512, 256, True, 1e-6): 1,
          (256, 512, True, 1e-6): 1}
SD15_K7 = {(4096, 2560): 7, (1024, 5120): 7, (256, 10240): 7, (64, 10240): 2}
BATCH = 8  # CFG batch of a request of 4
# the launcher's occupancy query as the CPU tests stand it in: blocks per SM
# by registers for K = 8, 4, 2, 1
OCCUPANCIES = {"occ2": lambda k, t, m: 2, "occ3-4": lambda k, t, m: 3 if k == 8 else 4,
               "occ1": lambda k, t, m: 1}


@pytest.fixture(scope="module")
def derived_sites():
    """The K5 and K7 calls of one SD1.5 int8 CFG denoise step and of the
    int8 VAE decode, recorded by `profile_sd15.k5_k7_calls` from the port's
    models at their default widths on the meta device (shapes only; every
    wrapper takes its plain version there)."""
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.tools.profile_sd15 import k5_k7_calls
    from prompt_diffusion_tpu_torch.utils.dtypes import int8_policy

    patch = pytest.MonkeyPatch()
    for info in pkgutil.iter_modules(port_ops.__path__):
        if info.name.startswith("_triton"):
            continue  # import triton at their top; they hold no wrapper
        mod = importlib.import_module(f"{port_ops.__name__}.{info.name}")
        if hasattr(mod, "use_kernel"):
            patch.setattr(mod, "use_kernel", lambda x: False)
    try:
        pipe = PromptDiffusionSD15.create(policy=int8_policy(), vae_int8=True, device="meta")
        meta = lambda *s: torch.zeros(s, device="meta")
        b = BATCH // 2
        ids = torch.zeros((b, 77), dtype=torch.long, device="meta")
        eps_fn = pipe.make_eps_fn(token_ids=ids, neg_token_ids=ids,
                                  example_pair=meta(b, 512, 512, 6), query=meta(b, 512, 512, 3),
                                  guidance_scale=9.0)
        x = meta(b, 4, 64, 64).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            k5, k7 = k5_k7_calls(lambda: eps_fn(
                x, torch.full((b,), 999, dtype=torch.int32, device="meta")))
            vae_k5, vae_k7 = k5_k7_calls(lambda: pipe.decode_latents(meta(b, 64, 64, 4)))
    finally:
        patch.undo()
    assert not vae_k7
    return k5, k7, vae_k5


def _count(sites):
    """{(C, H, SiLU, eps): calls} of {(B, C, H, W, SiLU, eps): calls}."""
    out = collections.Counter()
    for (_, c, h, _, silu, eps), n in sites.items():
        out[(c, h, silu, eps)] += n
    return dict(out)


def test_sd15_int8_step_sites_from_the_port_models(derived_sites):
    """87 K5 and 23 K7 calls per SD1.5 int8 denoise step, 29 K5 calls per
    int8 VAE decode, at the shapes listed above (the lists the plan tests
    below cover)."""
    step_k5, step_k7, vae_k5 = derived_sites
    assert sum(step_k5.values()) == 87 and sum(step_k7.values()) == 23
    assert sum(vae_k5.values()) == 29
    assert all(k[0] == BATCH and k[2] == k[3] for k in step_k5)
    assert _count(step_k5) == SD15_K5
    assert all(k[0] == BATCH // 2 for k in vae_k5) and _count(vae_k5) == VAE_K5
    assert step_k7 == {(BATCH * n, w): calls for (n, w), calls in SD15_K7.items()}


K5_SHAPES = sorted({(BATCH, c, h * h) for c, h, _, _ in SD15_K5}
                   | {(BATCH // 2, c, h * h) for c, h, _, _ in VAE_K5}
                   | {(2, 320, 4096), (1, 32, 5), (3, 40, 63), (2, 256, 1)})


def _covers(plan: gq.GnPlan):
    """The kernel's maps cover every (sample, pixel, channel) once: blocks
    split each sample's pixels in order, none empty and within one pixel of
    the same count, their chunks and the rows of a chunk split a block's
    pixels, and a pixel's threads its channels."""
    assert plan.cv * plan.rows <= plan.threads <= gq.MAX_THREADS and plan.threads % 32 == 0
    assert plan.threads - plan.cv * plan.rows < 32
    assert plan.cv * gq.THREAD_CHANNELS == plan.c
    assert plan.chunks * plan.rows * plan.k >= plan.hw > (plan.chunks - 1) * plan.rows * plan.k
    assert 1 <= plan.bps <= plan.chunks
    ranges = [plan.block_pixels(j) for j in range(plan.bps)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.hw
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert max(hi - lo for lo, hi in ranges) - min(hi - lo for lo, hi in ranges) <= 1
    assert min(hi - lo for lo, hi in ranges) >= 1
    pixels = []
    for j in range(plan.bps):
        for ch in range(plan.block_chunks(j)):
            chunk = [p for r in range(plan.rows) for p in plan.pixels(j, ch, r)]
            assert chunk, "a chunk without a pixel"
            pixels += chunk
    assert sorted(pixels) == list(range(plan.hw))
    channels = sorted(v * gq.THREAD_CHANNELS + e for v in range(plan.cv)
                      for e in range(gq.THREAD_CHANNELS))
    assert channels == list(range(plan.c))


@pytest.mark.parametrize("occ", list(OCCUPANCIES))
@pytest.mark.parametrize("shape", K5_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gn_plan_covers_every_value_once(shape, occ):
    """At every SD1.5 step and VAE site (and ragged ones), for bf16 and
    fp32: the plan covers each value once, its grid is resident at once,
    its shared buffers fit a block, and the workspace is a group partial
    (mean, M2) per block and group, a count and an amax per block."""
    batch, c, hw = shape
    for dtype in (torch.bfloat16, torch.float32):
        plan = gq.gn_plan(batch, c, hw, 32 if c % 32 == 0 else 8, dtype,
                          occupancy=OCCUPANCIES[occ])
        _covers(plan)
        assert plan.k in gq.KS[dtype]
        assert plan.grid == batch * plan.bps <= plan.blocks_per_sm * gq.SMS
        assert gq.static_smem(c, plan.rows, plan.groups) <= gq.SMEM_BLOCK
        assert plan.workspace == plan.grid * (2 * plan.groups + 2)


@pytest.mark.parametrize("shape,k,chunks,bps", [
    ((8, 320, 4096), 8, 86, 33),     # the 64² site: chunks of 6 x 8 pixels
    ((8, 2560, 64), 4, 16, 16),      # the 8² latents: ~one full block per SM
    ((8, 1280, 64), 4, 16, 16),
    ((8, 960, 4096), 8, 256, 33),    # the widest site, beyond the L2
    ((4, 128, 262144), 8, 2048, 66),  # the int8 VAE at 512²
])
def test_gn_plan_at_the_main_sites(shape, k, chunks, bps):
    """The plan at two blocks per SM: K = 8 where its chunks give half the
    SMs a block, else fewer vectors; every sample gets the same number of
    blocks."""
    plan = gq.gn_plan(*shape, 32, torch.bfloat16)
    assert (plan.k, plan.chunks, plan.bps) == (k, chunks, bps)


@pytest.mark.parametrize("args,match", [
    ((8, 320, 4096, 32, torch.float16), "bf16 or fp32"),
    ((8, 320, 4096, 32, torch.int8), "bf16 or fp32"),
    ((8, 320, 4096, 30, torch.bfloat16), "divisible"),
    ((8, 36, 4096, 4, torch.bfloat16), "multiple of 8"),
    ((8, 8192, 64, 32, torch.bfloat16), "exceed"),
    ((8, 8192, 64, 32, torch.float32), "exceed"),
    ((0, 320, 4096, 32, torch.bfloat16), "empty"),
    ((300, 320, 4096, 32, torch.bfloat16), "batch 300 exceeds"),
])
def test_gn_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        gq.gn_plan(*args, occupancy=lambda k, t, m: 1)


def test_gn_plan_refuses_a_forced_k_outside_the_kernels():
    with pytest.raises(ValueError, match="one of"):
        gq.gn_plan(8, 320, 4096, 32, torch.bfloat16, k=3)


def test_gn_plan_takes_at_most_4_fp32_pixels_a_thread():
    """K = 8 exists in bf16 only: 8 fp32 pixels are 16 vectors a thread.
    The fp32 plan picks from 4, 2 and 1, and at the same chunks the same
    bytes in flight as bf16's K = 8."""
    with pytest.raises(ValueError, match="one of"):
        gq.gn_plan(8, 320, 4096, 32, torch.float32, k=8)
    bf16 = gq.gn_plan(8, 320, 4096, 32, torch.bfloat16)
    fp32 = gq.gn_plan(8, 320, 4096, 32, torch.float32)
    assert (bf16.k, fp32.k) == (8, 4) and (bf16.cv, bf16.threads) == (fp32.cv, fp32.threads)


def _no_build(monkeypatch):
    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)


def _k5_refused(case):
    x = torch.zeros(2, 320, 8, 8, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.ones(320)
    cases = {
        "3-D": (x[0], w, w, 32),
        "groups do not divide C": (x, w, w, 30),
        "int8": (x.to(torch.int8), w, w, 32),
        "fp16": (x.half(), w, w, 32),
        "C not a multiple of 8": (torch.zeros(2, 36, 8, 8), torch.ones(36), torch.ones(36), 4),
        "affine width": (x, torch.ones(32), w, 32),
        "channels beyond the plan": (torch.zeros(1, 8192, 2, 2, dtype=torch.bfloat16),
                                     torch.ones(8192), torch.ones(8192), 32),
    }
    return cases[case]


@pytest.mark.parametrize("case", ["3-D", "groups do not divide C", "int8", "fp16",
                                  "C not a multiple of 8", "affine width",
                                  "channels beyond the plan"])
def test_gn_quant_refuses_before_build(case, monkeypatch):
    """What K5 refuses raises ValueError in the launcher, before the
    extension is built or a launch is queued: no fallback."""
    _no_build(monkeypatch)
    with pytest.raises(ValueError):
        gq.gn_quant(*_k5_refused(case), 1e-5, True)


@pytest.mark.parametrize("case", ["odd width", "I not a multiple of 8", "fp16", "int8",
                                  "rows not contiguous", "2I above 16384 bf16",
                                  "2I above 8192 fp32"])
def test_geglu_quant_refuses_before_build(case, monkeypatch):
    """What K7 refuses raises ValueError in the launcher, before any build."""
    _no_build(monkeypatch)
    proj = {
        "odd width": torch.zeros(4, 2561, dtype=torch.bfloat16),
        "I not a multiple of 8": torch.zeros(4, 2568, dtype=torch.bfloat16),
        "fp16": torch.zeros(4, 2560, dtype=torch.float16),
        "int8": torch.zeros(4, 2560, dtype=torch.int8),
        "rows not contiguous": torch.zeros(2560, 4, dtype=torch.bfloat16).t(),
        "2I above 16384 bf16": torch.zeros(4, 16400, dtype=torch.bfloat16),
        "2I above 8192 fp32": torch.zeros(4, 8208),
    }[case]
    with pytest.raises(ValueError):
        rq.geglu_quant(proj)


@pytest.mark.parametrize("which", ["K5 (8,320,64,64) bf16", "K5 (8,2048,8,8) fp32",
                                   "K7 (8,4096,2560)", "K7 (8,64,10240)"])
def test_launchers_accept_the_model_inputs(which, monkeypatch):
    """The model's inputs pass every check and reach the build (the
    refusals above are not vacuous)."""
    _no_build(monkeypatch)
    if which.startswith("K5"):
        dtype = torch.bfloat16 if which.endswith("bf16") else torch.float32
        shape = (8, 320, 64, 64) if "320" in which else (8, 2048, 8, 8)
        x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)
        call = lambda: gq.gn_quant(x, torch.ones(shape[1]), torch.zeros(shape[1]), 32, 1e-5, True)
    else:
        shape = (8, 4096, 2560) if "2560" in which else (8, 64, 10240)
        call = lambda: rq.geglu_quant(torch.zeros(shape, dtype=torch.bfloat16))
    with pytest.raises(AssertionError, match="was built"):
        call()


def test_cpu_tensors_never_reach_the_launchers(monkeypatch):
    """On the CPU both wrappers run their plain versions: the CUDA
    launchers are not called and no launch is counted."""
    import prompt_diffusion_tpu_torch.ops.fused_act as fa
    import prompt_diffusion_tpu_torch.ops.fused_group_norm as fg

    def launched(*args, **kwargs):
        raise AssertionError("a CUDA launcher was called for a CPU tensor")

    monkeypatch.setattr(fa, "geglu_quant", launched)
    monkeypatch.setattr(fg, "gn_quant", launched)
    before = (fused_geglu_quant.launches, fused_group_norm_quant.launches)
    q, s = fused_group_norm_quant(torch.randn(2, 64, 8, 8, dtype=torch.bfloat16),
                                  torch.ones(64), torch.zeros(64), 32, 1e-5, True)
    assert q.dtype == torch.int8 and s.shape == (2,)
    q, s = fused_geglu_quant(torch.randn(3, 5, 64, dtype=torch.bfloat16))
    assert q.shape == (3, 5, 32) and s.shape == (3, 5, 1)
    assert (fused_geglu_quant.launches, fused_group_norm_quant.launches) == before


# ---- an emulation of csrc/gn_quant.cu's arithmetic ------------------------


def _chan(a, b):
    """Chan's merge of (n, mean, m2) b into a, as phase 1 of the kernel
    merges a thread's chunks."""
    n, mean, m2 = a
    nb, mb, m2b = b
    if n == 0:
        return b
    nn = n + nb
    delta = mb - mean
    return nn, mean + delta * (nb / nn), m2 + m2b + delta * delta * (n * nb / nn)


def _tree(lanes):
    """The kernels' shuffle butterfly over a segment's lanes: at each step
    lane i adds lane i ^ off's sum (commutative adds: every lane ends with
    lane 0's bits)."""
    f32 = np.float32
    v = list(lanes)
    off = len(v) // 2
    while off:
        v = [f32(v[i] + v[i ^ off]) for i in range(len(v))]
        off //= 2
    return v[0]


def _block_parts(xs, plan, j, groups):
    """Phase 1 of block j on one sample's (hw, c) float32 values: per
    thread row and chunk a two-pass mean and M2 merged by Chan's formula,
    then the block's R x CG parts of each group (part i: row i // CG,
    channel i % CG of the group) over the segment's S lanes (lane i % S
    sums its parts in order, then the butterfly): the weighted mean of the
    parts' means, then their M2 plus n (mean_p - mean)^2. Returns [(n,
    mean, m2)] per group."""
    f32 = np.float32
    c = xs.shape[1]
    cg = c // groups
    rows = []
    for r in range(plan.rows):
        acc = (f32(0), np.zeros(c, f32), np.zeros(c, f32))
        for ch in range(plan.block_chunks(j)):
            pix = plan.pixels(j, ch, r)
            if not pix:
                continue
            vals = xs[pix]
            cm = vals.sum(0, dtype=f32) * (f32(1) / f32(len(pix)))
            acc = _chan(acc, (f32(len(pix)), cm, ((vals - cm) ** 2).sum(0, dtype=f32)))
        rows.append(acc)
    lo, hi = plan.block_pixels(j)
    cnt = f32((hi - lo) * cg)
    seg, parts = gq.merge_lanes(plan.threads, groups), plan.rows * cg
    out = []
    for g in range(groups):
        lanes = [f32(0)] * seg
        for i in range(parts):
            n, mean, _ = rows[i // cg]
            lanes[i % seg] = f32(lanes[i % seg] + n * mean[g * cg + i % cg])
        gm = f32(_tree(lanes) * (f32(1) / cnt))
        lanes = [f32(0)] * seg
        for i in range(parts):
            n, mean, m2 = rows[i // cg]
            cc = g * cg + i % cg
            lanes[i % seg] = f32(lanes[i % seg] + (m2[cc] + n * (mean[cc] - gm) ** 2))
        out.append((cnt, gm, _tree(lanes)))
    return out


def _sample_stats(parts, plan, groups, eps):
    """The sample's mean and rstd per group from its blocks' parts, as the
    kernels merge them: sums about block 0's mean, block j in lane j % S,
    then the butterfly."""
    f32 = np.float32
    mean_g, rstd_g = np.zeros(groups, f32), np.zeros(groups, f32)
    seg = gq.merge_lanes(plan.threads, groups)
    for g in range(groups):
        shift = parts[0][g][1]
        lanes = [[f32(0)] * 3 for _ in range(seg)]
        for j in range(plan.bps):
            n, m, m2 = parts[j][g]
            d = f32(m - shift)
            lane = lanes[j % seg]
            lane[0] = f32(lane[0] + n)
            lane[1] = f32(lane[1] + n * d)
            lane[2] = f32(lane[2] + (m2 + n * d * d))
        n, s1, s2 = (_tree([lane[i] for lane in lanes]) for i in range(3))
        d = f32(s1 / n)
        mean_g[g] = shift + d
        rstd_g[g] = f32(1) / np.sqrt(f32((s2 - s1 * d) / n) + f32(eps))
    return mean_g, rstd_g


def _silu(z):
    return z * (1.0 / (1.0 + np.exp(-z)))


def _emulate(x, gamma, beta, groups, eps, silu, plan):
    """The kernel's order of work in float32 numpy: each block's parts per
    group (`_block_parts`), the sample's blocks by sums about block 0's
    mean (`_sample_stats`); the amax
    from each channel's min and max of x (or from the values where SiLU's
    interior might win); the codes by IEEE quotient."""
    f32 = np.float32
    b_, c, h, w = x.shape
    xs = x.permute(0, 2, 3, 1).reshape(b_, h * w, c).numpy().astype(f32)
    cg = c // groups
    codes = np.zeros_like(xs, dtype=np.int8)
    scales = np.zeros(b_, dtype=f32)
    for b in range(b_):
        parts, lo, hi = [], [], []
        for j in range(plan.bps):
            parts.append(_block_parts(xs[b], plan, j, groups))
            block_px = [p for ch in range(plan.block_chunks(j)) for r in range(plan.rows)
                        for p in plan.pixels(j, ch, r)]
            lo.append(xs[b, block_px].min(0))
            hi.append(xs[b, block_px].max(0))
        mean_g, rstd_g = _sample_stats(parts, plan, groups, eps)
        sc = (gamma.numpy() * np.repeat(rstd_g, cg)).astype(f32)
        sh = (beta.numpy() - np.repeat(mean_g, cg) * sc).astype(f32)
        epi = (lambda z: _silu(z).astype(f32)) if silu else (lambda z: z)
        z = lambda v: epi((v * sc + sh).astype(f32))
        amaxes = []
        for j in range(plan.bps):
            a = max(np.abs(z(lo[j])).max(), np.abs(z(hi[j])).max())
            if silu and a < 0.28:
                px = [p for ch in range(plan.block_chunks(j)) for r in range(plan.rows)
                      for p in plan.pixels(j, ch, r)]
                a = np.abs(z(xs[b, px])).max()
            amaxes.append(a)
        s = max(f32(max(amaxes)) / f32(127), f32(1e-8))
        scales[b] = s
        codes[b] = np.clip(np.rint(z(xs[b]) / s), -127, 127).astype(np.int8)
    return (torch.from_numpy(codes).view(b_, h, w, c).permute(0, 3, 1, 2),
            torch.from_numpy(scales))


@pytest.mark.parametrize("case", ["silu", "no silu eps 1e-6", "mean 4", "silu interior",
                                  "fp32 ragged"])
def test_gn_quant_emulation_matches_the_plain_version(case):
    """The kernel's order of work, emulated on the CPU at a plan of many
    blocks and chunks per sample (sms=2, K=2), against the plain version:
    scales within 1e-6 relative, codes at most 1 apart and >= 99.9% equal
    (chip_smoke.py's bounds). "silu interior" shrinks the affine so that
    no endpoint reaches SiLU's minimum and the amax comes from the
    values."""
    rng = np.random.default_rng(10)
    shape, groups, eps, silu, mean, g = {
        "silu": ((2, 64, 24, 24), 8, 1e-5, True, 0.0, 1.0),
        "no silu eps 1e-6": ((2, 64, 24, 24), 8, 1e-6, False, 0.0, 1.0),
        "mean 4": ((2, 32, 40, 40), 8, 1e-6, True, 4.0, 1.0),
        "silu interior": ((2, 64, 24, 24), 8, 1e-5, True, 0.0, 0.02),
        "fp32 ragged": ((3, 40, 11, 13), 5, 1e-5, True, 0.5, 1.0),
    }[case]
    x = torch.from_numpy((rng.normal(size=shape) + mean).astype(np.float32))
    if case != "fp32 ragged":
        x = x.bfloat16().float()
    gamma = torch.from_numpy((g * (1 + 0.1 * rng.normal(size=shape[1]))).astype(np.float32))
    beta = torch.from_numpy((0.1 * g * rng.normal(size=shape[1])).astype(np.float32))
    plan = gq.gn_plan(shape[0], shape[1], shape[2] * shape[3], groups,
                      torch.bfloat16 if case != "fp32 ragged" else torch.float32,
                      occupancy=lambda k, t, m: 2, sms=2, k=2)
    assert plan.chunks > plan.bps and (plan.bps > 1 or case == "fp32 ragged")
    q, s = _emulate(x, gamma, beta, groups, eps, silu, plan)
    rq_, rs = _torch_group_norm_quant(x, groups, gamma, beta, eps, silu)
    if case == "silu interior":
        assert rs.max().item() < 0.28 / 127
    assert ((s - rs).abs() / rs).max().item() <= 1e-6
    diff = (q.int() - rq_.int()).abs()
    assert diff.max().item() <= 1 and (diff == 0).float().mean().item() >= 0.999
