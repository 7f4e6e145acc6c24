"""Timing on the card and the least time the card could take for a piece of
work, shared by `chip_smoke.py`, the attention lab and the profiles.

The bound is the largest of the bytes the function must move (each input
read once, each output written once) over the memory rate, its
tensor-core operations over their dense peak, and its exponentials over
the special-function units' rate, from the published peaks of one NVIDIA
H100 SXM at its 700 W limit (NVIDIA's data sheet; ~3.9e12 exponentials/s
from the FlashAttention-3 paper, Shah et al. 2024, §1: 132 SMs x 16
special-function results per clock). A softmax takes one exponential per
logit, which at small head dimensions outweighs the tensor work. A card
set to a lower power limit runs slower: print `card()` beside every
number.
"""

from __future__ import annotations

import statistics
import subprocess

HBM_BYTES_S, BF16_OPS_S, INT8_OPS_S, EXP_S = 3.35e12, 989e12, 1979e12, 3.9e12


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2):
    """Median milliseconds of one call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def roofline(nbytes, int8_ops=0.0, bf16_ops=0.0, exps=0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory rate,
    the tensor-core operations over their dense peaks and the exponentials
    over the special-function rate; bound_by is "bytes", "operations" or
    "exponentials"."""
    times = {"bytes": nbytes / HBM_BYTES_S,
             "operations": int8_ops / INT8_OPS_S + bf16_ops / BF16_OPS_S,
             "exponentials": exps / EXP_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by
