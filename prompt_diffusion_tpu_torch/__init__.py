"""Prompt-Diffusion for PyTorch and CUDA (NVIDIA Hopper).

A port of `prompt_diffusion_tpu` beside it: the same models and sampler,
with its Pallas kernels rewritten by hand for the H100 (CUDA C++ and
Triton). The JAX package is the reference the port is tested against; the
port itself never imports JAX.
"""
