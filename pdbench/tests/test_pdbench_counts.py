"""The op and byte counts against hand counts from the published widths."""

import pytest
import torch

from pdbench import spec
from pdbench.counts import layers
from pdbench.counts.work import count
from pdbench.families import sd3, sd15
from pdbench.reference import sd3 as ref3

BENCH = spec.benchmark()


def test_mmdit_and_controlnet_int8_linears_per_cfg_step():
    """The MMDiT's 24 JointBlocks and the ControlNet's 12 on the CFG batch
    of 2 at 1024² (4096 image and 77 + 256 text tokens): 12 C² multiply-adds
    a token a block (q, k, v, out; the 4C feed-forward), but the last
    MMDiT block's text side, which keeps only q, k and v. At 1,979 TOP/s
    that is PERF.md's 9.11 ms bound of G1."""
    cfg = spec.cell(BENCH, "sd3.int8.b1").config
    mc = cfg["mmdit"]
    c, img, txt = 1536, 4096, 77 + 256
    per_block = 12 * c * c * (img + txt)
    macs = 2 * (36 * per_block - 9 * c * c * txt)
    meta = lambda *s: torch.empty(*s, device="meta")
    x2, t2 = meta(2, 16, 128, 128), meta(2)
    ctx, pooled = meta(2, txt, 4096), meta(2, 2048)
    ccfg = dict(mc, num_layers=12)
    got = count(ref3.ControlNet, ccfg, True, lambda m: m(x2, t2, x2, x2, ctx, pooled))
    taps = [meta(2, img, c)] * 12
    got2 = count(ref3.MMDiT, mc, True, lambda m: m(x2, t2, ctx, pooled, taps))
    assert got["int8_ops"] + got2["int8_ops"] == 2 * macs
    ms = (got["int8_ops"] + got2["int8_ops"]) / layers.INT8_OPS_S * 1e3
    assert ms == pytest.approx(9.11, abs=0.01)


def test_sd15_request_work():
    """Per image of a 50-step request: the UNet (~0.80 TOP) and the
    ControlNet without its hint (~0.27 TOP) at each CFG evaluation, twice
    for the guidance; the int8 share is what the int8 sites carry."""
    cell = spec.cell(BENCH, "sd15.int8.b8")
    work = sd15.work(cell.config, dict(cell.traffic, batch=1))
    per_step = 2 * (0.8 + 0.27) * 1e12
    assert work["int8_ops"] + work["bf16_ops"] == pytest.approx(50 * per_step, rel=0.05)
    assert 0.8 < work["int8_ops"] / (work["int8_ops"] + work["bf16_ops"]) < 0.95
    bf16 = sd15.work(cell.config, dict(cell.traffic, batch=1, policy="bf16"))
    assert bf16["int8_ops"] == 0
    assert bf16["bf16_ops"] == pytest.approx(work["int8_ops"] + work["bf16_ops"])


def test_sd3_request_work_scales_with_steps():
    cell = spec.cell(BENCH, "sd3.int8.b1")
    a = sd3.work(cell.config, cell.traffic)
    b = sd3.work(cell.config, dict(cell.traffic, steps=29))
    step = (b["int8_ops"] + b["bf16_ops"]) - (a["int8_ops"] + a["bf16_ops"])
    assert step == pytest.approx(2 * 9.11e-3 * layers.INT8_OPS_S, rel=0.25)


def test_layer_bounds_by_hand():
    # (1024, 1536) x (1536 -> 6144): 2 * 1024 * 1536 * 6144 int8 operations
    ops = 2 * 1024 * 1536 * 6144
    assert layers.int8_dense_s((1024, 1536), 6144, 1) == pytest.approx(ops / 1979e12)
    # a skinny one is bound by its bytes: 8 rows, codes in, weight codes, bf16 out
    nbytes = 8 * 4096 + 4096 * 4096 + 8 * 4096 * 2
    assert layers.int8_dense_s((8, 4096), 4096, 1) == pytest.approx(nbytes / 3.35e12)
    # 3x3 conv, stride 1, pad 1, 64x64 -> 64x64
    ops = 2 * 8 * 64 * 64 * 320 * 320 * 9
    assert layers.int8_conv_s((8, 320, 64, 64), 320, 3, 1, 1, 1) == pytest.approx(ops / 1979e12)
    # attention at D = 40 is bound by its exponentials: 8 * 8 * 4096^2 of them
    exps = 8 * 8 * 4096 * 4096
    assert layers.attention_s(8, 4096, 4096, 8, 40) == pytest.approx(exps / 3.9e12)
    # at D = 64 by its operations
    ops = 4 * 2 * 24 * 4429 * 4429 * 64
    assert layers.attention_s(2, 4429, 4429, 24, 64) == pytest.approx(ops / 989e12)
