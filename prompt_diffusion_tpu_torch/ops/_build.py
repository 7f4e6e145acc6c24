"""Builds the port's CUDA sources on first use.

`torch.utils.cpp_extension.load` compiles `csrc/*.cu` for Hopper
(`sm_90a`) and the small pybind11 binding in `csrc/binding.cpp` into
`build/torch_ext/` at the repository root (listed in `.gitignore`), and
caches the result by content. The binding includes pybind11 only, not
`torch/extension.h`: the kernels take raw device pointers, and keeping
PyTorch's headers out keeps the build to seconds. A failed build raises.
"""

from __future__ import annotations

import functools
import os

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "torch_ext")

_CUDA_FLAGS = [
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    # load() forbids the implicit bf16/half conversions; the kernels use
    # the intrinsics, but mma.h's bf16 fragments need the conversions
    "-U__CUDA_NO_HALF_OPERATORS__",
    "-U__CUDA_NO_HALF_CONVERSIONS__",
    "-U__CUDA_NO_BFLOAT16_CONVERSIONS__",
    "-U__CUDA_NO_HALF2_OPERATORS__",
]


@functools.lru_cache(maxsize=None)
def cuda_ext():
    """The compiled extension module (built once per process)."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    return load(
        name="pd_torch_kernels",
        sources=[os.path.join(_CSRC, name)
                 for name in ("binding.cpp", "flash_attention.cu", "attention_sm90.cu",
                              "attention_sm90_bf16.cu", "attention_sm90_int8.cu",
                              "attention_sm90_lab.cu", "attention_sm90_lab_two_pass.cu",
                              "attention_sm90_wide.cu",
                              "int8_conv.cu", "int8_attention.cu", "row_quant.cu",
                              "gn_quant.cu")],
        build_directory=BUILD_DIR,
        extra_cflags=["-O3", "-std=c++17"],
        extra_cuda_cflags=_CUDA_FLAGS,
        verbose=False,
    )
