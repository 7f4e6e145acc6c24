"""PyTorch port, K3 (GroupNorm(+SiLU or ReLU)) on the card: its sites on the
SD1.5 bf16 step at CFG batch 8, the SD1.5 and SD3 VAE decodes and the
DPT-Hybrid forward at batch 16, derived from the port's models; K3's launch
plan (`ops/gn_quant.py::gn_float_plan`) at each of them; an emulation of
`csrc/gn_quant.cu`'s K3 arithmetic against the plain version; the
refusals before any build; and `group_norm_auto`'s routing rule. The kernel itself runs only on the card (`chip_smoke.py`,
`tools/quant_tune.py --kernels K3`)."""

import collections
import importlib
import pkgutil

import numpy as np
import pytest
import torch
from test_torch_gn_quant import _block_parts, _no_build, _sample_stats, _silu

import prompt_diffusion_tpu_torch.ops as port_ops
import prompt_diffusion_tpu_torch.ops.fused_group_norm as fg
from prompt_diffusion_tpu_torch.ops import gn_quant as gq
from prompt_diffusion_tpu_torch.ops.norms import group_norm

torch.set_num_threads(2)

BATCH = 8  # CFG batch of an SD1.5 request of 4
# K3's calls as (C, H, W, epilogue, eps): count. One SD1.5 bf16 denoise step
# (ControlNet + UNet at 512², CFG batch 8), 88; the SD1.5 VAE decode at 512²
# (batch 4), 30; the SD3 VAE decode at 1024² (batch 1), 30; one DPT-Hybrid
# forward at 512² (batch 16), 52, 33 of them with ReLU.
SD15_K3 = {(1280, 8, 8, "silu", 1e-5): 19, (320, 64, 64, "silu", 1e-5): 12,
           (640, 32, 32, "silu", 1e-5): 9, (1280, 16, 16, "silu", 1e-5): 9,
           (320, 64, 64, "none", 1e-6): 7, (640, 32, 32, "none", 1e-6): 7,
           (1280, 16, 16, "none", 1e-6): 7, (2560, 8, 8, "silu", 1e-5): 3,
           (320, 32, 32, "silu", 1e-5): 2, (640, 16, 16, "silu", 1e-5): 2,
           (1280, 8, 8, "none", 1e-6): 2, (2560, 16, 16, "silu", 1e-5): 2,
           (640, 64, 64, "silu", 1e-5): 2, (1920, 16, 16, "silu", 1e-5): 1,
           (1920, 32, 32, "silu", 1e-5): 1, (1280, 32, 32, "silu", 1e-5): 1,
           (960, 32, 32, "silu", 1e-5): 1, (960, 64, 64, "silu", 1e-5): 1}
VAE_K3 = {(512, 64, 64, "silu", 1e-6): 10, (512, 128, 128, "silu", 1e-6): 6,
          (128, 512, 512, "silu", 1e-6): 6, (256, 256, 256, "silu", 1e-6): 5,
          (512, 64, 64, "none", 1e-6): 1, (512, 256, 256, "silu", 1e-6): 1,
          (256, 512, 512, "silu", 1e-6): 1}
# the same VAE at twice the size: the SD3 decoder at 1024² (z = 16)
SD3_VAE_K3 = {(c, 2 * h, 2 * w, act, eps): n for (c, h, w, act, eps), n in VAE_K3.items()}
DPT_K3 = {(256, 32, 32, "relu", 1e-5): 17, (1024, 32, 32, "none", 1e-5): 10,
          (128, 64, 64, "relu", 1e-5): 7, (64, 128, 128, "relu", 1e-5): 6,
          (512, 64, 64, "none", 1e-5): 5, (256, 128, 128, "none", 1e-5): 4,
          (64, 256, 256, "relu", 1e-5): 1, (128, 128, 128, "relu", 1e-5): 1,
          (256, 64, 64, "relu", 1e-5): 1}
OCCUPANCIES = {"occ2": lambda k, t, m: 2, "occ3-4": lambda k, t, m: 3 if k == 8 else 4,
               "occ1": lambda k, t, m: 1}


def _record(step):
    """Runs `step` once with every wrapper on its plain version (the meta
    device), recording the calls `group_norm_auto` sends to K3; returns
    {(B, C, H, W, epilogue, eps, dtype): calls}."""
    calls = collections.Counter()
    real = fg.fused_group_norm

    def record(x, scale, bias, num_groups, eps=1e-5, apply_silu=False, apply_relu=False):
        act = "silu" if apply_silu else "relu" if apply_relu else "none"
        calls[tuple(x.shape) + (act, eps, x.dtype)] += 1
        return real(x, scale, bias, num_groups, eps, apply_silu, apply_relu)

    patch = pytest.MonkeyPatch()
    patch.setattr(fg, "fused_group_norm", record)
    try:
        with torch.no_grad():
            step()
    finally:
        patch.undo()
    return dict(calls)


@pytest.fixture(scope="module")
def derived_sites():
    """K3's calls of one SD1.5 bf16 CFG denoise step and VAE decode, the
    SD3 VAE decode at 1024² and one DPT-Hybrid forward at batch 16, from
    the port's models at their default widths on the meta device."""
    from prompt_diffusion_tpu_torch.annotators.midas import DPTHybridDepth
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import SD3_VAE
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.utils.dtypes import default_policy

    patch = pytest.MonkeyPatch()
    for info in pkgutil.iter_modules(port_ops.__path__):
        if info.name.startswith("_triton"):
            continue  # import triton at their top; they hold no wrapper
        mod = importlib.import_module(f"{port_ops.__name__}.{info.name}")
        if hasattr(mod, "use_kernel"):
            patch.setattr(mod, "use_kernel", lambda x: False)
    meta = lambda *s: torch.zeros(s, device="meta")
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    try:
        pipe = PromptDiffusionSD15.create(device="meta")
        b = BATCH // 2
        ids = torch.zeros((b, 77), dtype=torch.long, device="meta")
        eps_fn = pipe.make_eps_fn(token_ids=ids, neg_token_ids=ids,
                                  example_pair=meta(b, 512, 512, 6), query=meta(b, 512, 512, 3),
                                  guidance_scale=9.0)
        t = torch.full((b,), 999, dtype=torch.int32, device="meta")
        sites = {"sd15 step": _record(lambda: eps_fn(cl(meta(b, 4, 64, 64)), t)),
                 "sd15 vae": _record(lambda: pipe.decode_latents(meta(b, 64, 64, 4)))}
        with torch.device("meta"):
            vae = AutoencoderKL(SD3_VAE).to(memory_format=torch.channels_last).eval()
            dpt = DPTHybridDepth(policy=default_policy()).eval()
        sites["sd3 vae"] = _record(lambda: vae.decode(cl(meta(1, 16, 128, 128))))
        sites["dpt"] = _record(lambda: dpt(meta(16, 3, 512, 512)))
    finally:
        patch.undo()
    return sites


def _count(sites):
    out = collections.Counter()
    for (_, c, h, w, act, eps, _), n in sites.items():
        out[(c, h, w, act, eps)] += n
    return dict(out)


@pytest.mark.parametrize("path,batch,expected,total", [
    ("sd15 step", BATCH, SD15_K3, 88), ("sd15 vae", BATCH // 2, VAE_K3, 30),
    ("sd3 vae", 1, SD3_VAE_K3, 30), ("dpt", 16, DPT_K3, 52)])
def test_k3_sites_from_the_port_models(derived_sites, path, batch, expected, total):
    """K3's calls on each path, at the shapes listed above (the lists the
    plan tests below cover): 88 per SD1.5 bf16 step (the GroupNorm sites
    where K5 runs under int8), 30 per VAE decode, 52 per DPT-Hybrid
    forward, 33 of them with ReLU; every one bf16 with C a multiple of 8,
    all of them taken by the kernel."""
    sites = derived_sites[path]
    assert sum(sites.values()) == total
    assert all(k[0] == batch and k[-1] == torch.bfloat16 and k[1] % 8 == 0 for k in sites)
    assert _count(sites) == expected
    if path == "dpt":
        assert sum(n for k, n in sites.items() if k[4] == "relu") == 33


SHAPES = sorted({(BATCH, c, h * w) for c, h, w, _, _ in SD15_K3}
                | {(BATCH // 2, c, h * w) for c, h, w, _, _ in VAE_K3}
                | {(1, c, h * w) for c, h, w, _, _ in SD3_VAE_K3}
                | {(16, c, h * w) for c, h, w, _, _ in DPT_K3}
                | {(2, 320, 4096), (1, 32, 5), (3, 40, 63), (2, 256, 1), (16, 64, 4096)})


def _covers(plan: gq.GnPlan, capacity: int):
    """The grid, every sample's blocks, is resident at once, and within a
    sample the blocks' chunks and the chunks' rows cover every pixel once
    and a pixel's threads every channel."""
    assert not plan.quant
    assert plan.grid == plan.batch * plan.bps <= capacity
    assert plan.cv * plan.rows <= plan.threads <= gq.MAX_THREADS and plan.threads % 32 == 0
    assert plan.threads - plan.cv * plan.rows < 32
    assert plan.chunks * plan.rows * plan.k >= plan.hw > (plan.chunks - 1) * plan.rows * plan.k
    assert 1 <= plan.bps <= plan.chunks
    ranges = [plan.block_pixels(j) for j in range(plan.bps)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.hw
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert 1 <= min(hi - lo for lo, hi in ranges) >= max(hi - lo for lo, hi in ranges) - 1
    pixels = [p for j in range(plan.bps) for ch in range(plan.block_chunks(j))
              for r in range(plan.rows) for p in plan.pixels(j, ch, r)]
    assert sorted(pixels) == list(range(plan.hw))
    assert plan.cv * gq.THREAD_CHANNELS == plan.c


@pytest.mark.parametrize("occ", list(OCCUPANCIES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gn_float_plan_covers_every_value_once(shape, occ):
    """At every site of the four paths (and ragged ones), for bf16 and
    fp32 (C up to 2560 in both): the plan covers each value once, its grid
    is resident at once, and the workspace holds a group partial (mean,
    M2) per sample, block and group and a count per block."""
    batch, c, hw = shape
    for dtype in (torch.bfloat16, torch.float32):
        plan = gq.gn_float_plan(batch, c, hw, 32 if c % 32 == 0 else 8, dtype,
                                occupancy=OCCUPANCIES[occ])
        _covers(plan, plan.blocks_per_sm * gq.SMS)
        assert plan.workspace == batch * plan.bps * (2 * plan.groups + 1)


@pytest.mark.parametrize("shape,dtype,k,bps", [
    ((8, 320, 4096), torch.bfloat16, 8, 33),     # the SD1.5 64² site: 21 MB
    ((8, 1280, 64), torch.bfloat16, 4, 16),      # the 8² latents: ~one full block per SM
    ((8, 2560, 64), torch.float32, 4, 16),       # the fp32 policy's widest 8² site
    ((16, 64, 65536), torch.bfloat16, 8, 16),    # the DPT stem: 134 MB
    ((16, 256, 1024), torch.bfloat16, 8, 16),    # the DPT stage 3: 8 MB in all
    ((1, 128, 1048576), torch.bfloat16, 8, 264),  # the SD3 VAE at 1024²: one 268 MB sample
    ((4, 128, 262144), torch.bfloat16, 8, 66),   # the SD1.5 VAE at 512²: 67 MB samples
])
def test_gn_float_plan_at_the_main_sites(shape, dtype, k, bps):
    """The plan at two blocks per SM: the whole batch in one grid; K and
    the blocks per sample as K5's plan chooses them."""
    plan = gq.gn_float_plan(*shape, 32, dtype)
    assert (plan.k, plan.bps) == (k, bps)
    assert plan.grid <= gq.ASSUMED_OCCUPANCY * gq.SMS


def test_gn_float_plan_refuses_a_batch_beyond_the_card():
    """A batch of more samples than the card holds blocks cannot be
    resident: K3's plan raises a RuntimeError naming the shape (K5's a
    ValueError)."""
    with pytest.raises(RuntimeError, match=r"fused_group_norm of \(300, 64, 16 pixels\).*"
                                           r"batch 300 exceeds"):
        gq.gn_float_plan(300, 64, 16, 32, torch.bfloat16, occupancy=lambda k, t, m: 1, sms=2)
    with pytest.raises(ValueError, match="batch 300 exceeds"):
        gq.gn_plan(300, 64, 16, 32, torch.bfloat16, occupancy=lambda k, t, m: 1, sms=2)


@pytest.mark.parametrize("args,match", [
    ((8, 320, 4096, 32, torch.float16), "bf16 or fp32"),
    ((8, 320, 4096, 30, torch.bfloat16), "divisible"),
    ((8, 36, 4096, 4, torch.bfloat16), "multiple of 8"),
    ((8, 8192, 64, 32, torch.bfloat16), "exceed"),
    ((0, 320, 4096, 32, torch.bfloat16), "empty"),
])
def test_gn_float_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        gq.gn_float_plan(*args, occupancy=lambda k, t, m: 1)


def test_gn_float_plan_refuses_a_grid_that_cannot_be_resident():
    """Where the occupancy query says no block fits an SM, the plan raises
    a RuntimeError that names the shape."""
    with pytest.raises(RuntimeError, match=r"fused_group_norm of \(8, 320, 4096 pixels\)"):
        gq.gn_float_plan(8, 320, 4096, 32, torch.bfloat16, occupancy=lambda k, t, m: 0)


def _k3_refused(case):
    x = torch.zeros(2, 320, 8, 8, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.ones(320)
    return {
        "3-D": (x[0], w, w, 32),
        "groups do not divide C": (x, w, w, 30),
        "int8": (x.to(torch.int8), w, w, 32),
        "fp16": (x.half(), w, w, 32),
        "C not a multiple of 8": (torch.zeros(2, 36, 8, 8), torch.ones(36), torch.ones(36), 4),
        "affine width": (x, torch.ones(32), w, 32),
        "channels beyond the plan": (torch.zeros(1, 8192, 2, 2, dtype=torch.bfloat16),
                                     torch.ones(8192), torch.ones(8192), 32),
    }[case]


@pytest.mark.parametrize("case", ["3-D", "groups do not divide C", "int8", "fp16",
                                  "C not a multiple of 8", "affine width",
                                  "channels beyond the plan", "epilogue"])
def test_gn_float_refuses_before_build(case, monkeypatch):
    """What K3 refuses raises ValueError in the launcher, before the
    extension is built or a launch is queued: no fallback."""
    _no_build(monkeypatch)
    if case == "epilogue":
        x = torch.zeros(2, 320, 8, 8, dtype=torch.bfloat16)
        args, act = (x, torch.ones(320), torch.ones(320), 32), 3
    else:
        args, act = _k3_refused(case), gq.ACT_SILU
    with pytest.raises(ValueError):
        gq.gn_float(*args, 1e-5, act)


def test_gn_float_refuses_a_k5_plan(monkeypatch):
    """Each launcher takes only its own kernel's plan."""
    _no_build(monkeypatch)
    x = torch.zeros(2, 64, 8, 8, dtype=torch.bfloat16)
    w = torch.ones(64)
    with pytest.raises(ValueError, match="the plan covers"):
        gq.gn_float(x, w, w, 32, 1e-5, gq.ACT_NONE, plan=gq.gn_plan(2, 64, 64, 32, x.dtype))
    with pytest.raises(ValueError, match="the plan covers"):
        gq.gn_quant(x, w, w, 32, 1e-5, False, plan=gq.gn_float_plan(2, 64, 64, 32, x.dtype))


@pytest.mark.parametrize("which", ["(8,320,64,64) bf16", "(16,64,256,256) bf16",
                                   "(8,2048,8,8) fp32", "(8,2560,8,8) fp32"])
def test_gn_float_accepts_the_model_inputs(which, monkeypatch):
    """The models' inputs pass every check and reach the build (the
    refusals above are not vacuous)."""
    _no_build(monkeypatch)
    dtype = torch.bfloat16 if which.endswith("bf16") else torch.float32
    shape = tuple(int(s) for s in which.split(")")[0][1:].split(","))
    x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)
    with pytest.raises(AssertionError, match="was built"):
        gq.gn_float(x, torch.ones(shape[1]), torch.zeros(shape[1]), 32, 1e-5, gq.ACT_RELU)


@pytest.mark.parametrize("case,kernel", [
    ("bf16 (8,320,64,64)", True), ("fp32 (8,320,64,64)", True), ("bf16 (8,2560,8,8)", True),
    ("fp32 (8,2560,8,8)", True), ("bf16 (1,64,64,32) below 2^18", False),
    ("bf16 (2,36,64,64) C % 8", True), ("fp16 (8,320,64,64)", True),
    ("bf16 (8,320,4096) 3-D", False), ("bf16 (8,320,64,64) groups 30", False)])
def test_group_norm_auto_routing_rule(case, kernel, monkeypatch):
    """`group_norm_auto` keeps the TPU package's rule and no other: the
    4-D activations of at least 2^18 elements whose channels split into
    the groups go to `fused_group_norm` (K3 on the card, which raises on a
    dtype or width it does not take), the rest to the plain version."""
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}[
        case.split()[0]]
    shape = tuple(int(s) for s in case.split("(")[1].split(")")[0].split(","))
    groups = 30 if case.endswith("groups 30") else 32 if shape[1] % 32 == 0 else 4
    x = torch.zeros(shape, dtype=dtype, device="meta")
    c = shape[1]
    routed = []
    monkeypatch.setattr(fg, "fused_group_norm", lambda *a, **k: routed.append(True))
    monkeypatch.setattr(fg, "_torch_group_norm", lambda *a, **k: routed.append(False))
    fg.group_norm_auto(x, groups, torch.ones(c), torch.zeros(c), 1e-5, apply_silu=True)
    assert routed == [kernel]


@pytest.mark.parametrize("case", ["fp16", "C not a multiple of 8", "channels beyond the plan"])
def test_fused_group_norm_raises_where_k3_refuses(case, monkeypatch):
    """A tensor on the card that K3 does not take raises ValueError in
    `fused_group_norm`, before any build: it is not sent to the plain
    version (the card is stood in for by making the wrapper take the
    kernel's route)."""
    _no_build(monkeypatch)
    monkeypatch.setattr(fg, "use_kernel", lambda t: True)
    monkeypatch.setattr(fg, "_torch_group_norm", lambda *a, **k: pytest.fail("plain version"))
    x, w, b, groups = _k3_refused(case)
    with pytest.raises(ValueError):
        fg.fused_group_norm(x, w, b, groups, 1e-5, apply_silu=True)


# ---- an emulation of csrc/gn_quant.cu's K3 arithmetic ------------------------


def _emulate_k3(x, gamma, beta, groups, eps, act, plan):
    """K3's order of work in float32 numpy: per block the statistics of
    K5's phase 1 (`_block_parts`), the sample's blocks as K5 merges them
    (`_sample_stats`), then y = act(x sc + sh) rounded to x's dtype."""
    f32 = np.float32
    b_, c, h, w = x.shape
    xs = x.float().permute(0, 2, 3, 1).reshape(b_, h * w, c).numpy()
    cg = c // groups
    out = np.zeros_like(xs)
    for b in range(b_):
        parts = [_block_parts(xs[b], plan, j, groups) for j in range(plan.bps)]
        mean_g, rstd_g = _sample_stats(parts, plan, groups, eps)
        sc = (gamma.numpy() * np.repeat(rstd_g, cg)).astype(f32)
        sh = (beta.numpy() - np.repeat(mean_g, cg) * sc).astype(f32)
        z = (xs[b] * sc + sh).astype(f32)
        out[b] = {"silu": lambda v: _silu(v).astype(f32), "relu": lambda v: np.maximum(v, 0),
                  "none": lambda v: v}[act](z)
    y = torch.from_numpy(out).view(b_, h, w, c).permute(0, 3, 1, 2)
    return y.to(x.dtype)


@pytest.mark.parametrize("case", ["silu", "relu", "none eps 1e-6", "mean 4",
                                  "fp32 ragged", "fp32 wide"])
def test_gn_float_emulation_matches_the_plain_version(case):
    """K3's order of work, emulated on the CPU at a plan of many blocks and
    chunks per sample (sms=2, K=2; "fp32 wide": 320 threads a pixel, C =
    2560), against the plain version: within one bf16 rounding (fp32:
    2e-5) of chip_smoke.py's fp32 reference."""
    rng = np.random.default_rng(11)
    shape, groups, eps, act, mean = {
        "silu": ((2, 64, 24, 24), 8, 1e-5, "silu", 0.0),
        "relu": ((2, 64, 20, 20), 8, 1e-5, "relu", 0.0),
        "none eps 1e-6": ((2, 64, 24, 24), 8, 1e-6, "none", 0.0),
        "mean 4": ((2, 32, 40, 40), 8, 1e-6, "silu", 4.0),
        "fp32 ragged": ((3, 40, 11, 13), 5, 1e-5, "silu", 0.5),
        "fp32 wide": ((1, 2560, 4, 5), 32, 1e-5, "silu", 0.0),
    }[case]
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    x = torch.from_numpy((rng.normal(size=shape) + mean).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy((1 + 0.1 * rng.normal(size=shape[1])).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.normal(size=shape[1])).astype(np.float32))
    plan = gq.gn_float_plan(shape[0], shape[1], shape[2] * shape[3], groups, dtype,
                            occupancy=lambda k, t, m: 2, sms=2, k=2)
    assert plan.chunks > plan.bps and (plan.bps > 1 or case == "fp32 ragged")
    y = _emulate_k3(x, gamma, beta, groups, eps, act, plan)
    ref = group_norm(x.float(), groups, gamma, beta, eps, act == "silu", act == "relu")
    bound = 2e-5 if dtype == torch.float32 else 2 ** -8 * ref.abs().max().item()
    assert (y.float() - ref).abs().max().item() <= bound
    assert (y.float() - group_norm(x, groups, gamma, beta, eps, act == "silu",
                                   act == "relu").float()).abs().max().item() <= bound
