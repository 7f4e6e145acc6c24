"""Carries the JAX package's parameters over to the PyTorch port.

The port's attribute names follow the Flax parameter paths, so the mapping
is mechanical:
  * `a/b/c/kernel` of rank 4 (HWIO conv) -> `a.b.c.weight`, OIHW;
  * `a/b/c/kernel` of rank 2 (Dense, (in, out)) -> `a.b.c.weight`, (out, in);
  * `scale` and `embedding` -> `weight`; `bias` and other leaves keep their
    names (CLIP's `position_embedding`, T5's `relative_attention_bias`,
    the DPT models' top-level `cls_token` and `pos_embed`);
  * a `GroupNorm_0` scope (the MiDaS backbone's bare GroupNorm affine) is
    dropped: `stem_norm/GroupNorm_0/scale` -> `stem_norm.weight`;
  * a transposed-conv kernel (Flax `ConvTranspose`: (kh, kw, in, out),
    spatially flipped against torch, `annotators/midas.py::convt_kernel`)
    -> unflipped (in, out, kh, kw), at the paths the caller names.
Each pipeline names its namespaces (`jax_modules()`): SD1.5 {"unet",
"controlnet", "vae", "clip"}, SD3 {"transformer", "controlnet", "down_proj",
"vae", "clip_l", "clip_g"} and "t5" when it holds a T5 encoder. A single
model's tree (the DPT annotators) goes through `load_jax_model`.
Needs numpy only. A reference `.ckpt` reaches the port through the JAX
package's importer (`tools/torch_import.py`), then through this bridge.
"""

from __future__ import annotations

from typing import Collection, Dict, Mapping

import numpy as np
import torch
from torch import nn

def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert(path, value: np.ndarray, convt: Collection[str] = ()):
    *mods, leaf = path
    mods = [m for m in mods if m != "GroupNorm_0"]
    a = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
        if a.ndim == 4 and ".".join(mods) in convt:
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"kernel of rank {a.ndim} at {'/'.join(path)}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_jax(params: Mapping, convt: Collection[str] = ()) -> Dict[str, torch.Tensor]:
    """One namespace's Flax tree ({"params": {...}}) -> a torch state dict;
    `convt` names the modules whose kernels are transposed convs. Raises if
    two leaves map onto one key."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params["params"]):
        key, tensor = _convert(path, value, convt)
        if key in out:
            raise ValueError(f"two JAX leaves map onto {key!r}")
        out[key] = tensor
    return out


def load_jax_params(pipe, tree: Mapping) -> None:
    """Loads the JAX package's parameter dict into a port pipeline,
    strictly: the tree's namespaces are those of `pipe.jax_modules()`,
    every module parameter gets a value and every JAX leaf lands in exactly
    one parameter (values are cast to each parameter's dtype)."""
    modules = pipe.jax_modules()
    if set(tree) != set(modules):
        raise ValueError(f"the tree's namespaces {sorted(tree)} are not the pipeline's "
                         f"{sorted(modules)}")
    for name, module in modules.items():
        module.load_state_dict(state_dict_from_jax(tree[name]), strict=True)


def load_jax_model(module: nn.Module, params: Mapping) -> None:
    """Loads one model's Flax tree ({"params": {...}}, no namespaces) into
    `module`, strictly, with the flip rule at its `nn.ConvTranspose2d`s."""
    convt = {name for name, m in module.named_modules() if isinstance(m, nn.ConvTranspose2d)}
    module.load_state_dict(state_dict_from_jax(params, convt), strict=True)
