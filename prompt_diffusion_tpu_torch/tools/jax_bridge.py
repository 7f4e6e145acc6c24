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
`jax_params_from_module` is the inverse: a module's state dict -> the
Flax-named tree, each `weight` named by the module that owns it.

A pipeline loads every namespace, or exactly the subset its caller names
(`namespaces=`): `load_jax_params` for Flax trees, `load_state_dicts` for
the port's own state dicts (what the checkpoint importers of
`tools/torch_import.py` and `tools/diffusers_import.py` give). The latter
also fills modules built on the meta device, so that a pipeline is built
from a file without a random initialisation first.
"""

from __future__ import annotations

from typing import Collection, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_name(path) -> str:
    """The port's state-dict key of a Flax leaf path (a tuple of names)."""
    *mods, leaf = path
    mods = [m for m in mods if m != "GroupNorm_0"]
    if leaf in ("kernel", "scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf])


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
    return torch_name(path), torch.from_numpy(np.ascontiguousarray(a))


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


def pipeline_modules(pipe, names: Collection[str],
                     namespaces: Optional[Collection[str]] = None) -> Dict[str, nn.Module]:
    """{namespace: module} for the namespaces a tree or a set of state
    dicts holds (`names`): all of the pipeline's, or, when the caller names
    `namespaces`, exactly those (a subset of the pipeline's)."""
    modules = pipe.jax_modules()
    if namespaces is None:
        if set(names) != set(modules):
            raise ValueError(f"the tree's namespaces {sorted(names)} are not the pipeline's "
                             f"{sorted(modules)}")
        return modules
    want = set(namespaces)
    if not want <= set(modules):
        raise ValueError(f"namespaces {sorted(want - set(modules))} are not the pipeline's "
                         f"{sorted(modules)}")
    if set(names) != want:
        raise ValueError(f"the tree's namespaces {sorted(names)} are not the named "
                         f"{sorted(want)}")
    return {name: m for name, m in modules.items() if name in want}


def load_jax_params(pipe, tree: Mapping, namespaces: Optional[Collection[str]] = None) -> None:
    """Loads the JAX package's parameter dict into a port pipeline,
    strictly: the tree's namespaces are those of `pipe.jax_modules()` (or
    exactly the subset `namespaces` names), every module parameter gets a
    value and every JAX leaf lands in exactly one parameter (values are
    cast to each parameter's dtype)."""
    for name, module in pipeline_modules(pipe, tree, namespaces).items():
        module.load_state_dict(state_dict_from_jax(tree[name]), strict=True)


def load_module_state(module: nn.Module, sd: Mapping[str, torch.Tensor],
                      device: Optional[torch.device | str] = None) -> None:
    """Loads a port state dict into `module`, strictly (no key missing or
    left over, every shape equal). Each value is copied into a new tensor
    with the dtype and the strides (channels_last where the module has it)
    of the tensor it replaces, on `device` (default: where the module's
    tensors are; required when they are on the meta device); the module
    then holds the new tensors. The copy never aliases `sd` (a mapped
    file), and a quantized layer's int8 cache, keyed by storage, is
    renewed."""
    own = module.state_dict()
    missing, unexpected = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or unexpected:
        raise RuntimeError(f"{type(module).__name__}: missing keys {missing[:8]}, "
                           f"unexpected keys {unexpected[:8]}")
    new = {}
    for key, ref in own.items():
        src = sd[key]
        if tuple(src.shape) != tuple(ref.shape):
            raise RuntimeError(f"{type(module).__name__}: {key} has shape {tuple(src.shape)}, "
                               f"the module's is {tuple(ref.shape)}")
        dev = torch.device(device) if device is not None else ref.device
        if dev.type == "meta":
            raise ValueError(f"{type(module).__name__} is on the meta device: name the device "
                             "to load it onto")
        new[key] = torch.empty_strided(ref.shape, ref.stride(), dtype=ref.dtype,
                                       device=dev).copy_(src)
    module.load_state_dict(new, strict=True, assign=True)


def load_state_dicts(pipe, sds: Mapping[str, Mapping[str, torch.Tensor]],
                     namespaces: Optional[Collection[str]] = None,
                     device: Optional[torch.device | str] = None) -> None:
    """Loads {namespace: port state dict} into a pipeline through
    `load_module_state`, with `load_jax_params`' rule on namespaces."""
    for name, module in pipeline_modules(pipe, sds, namespaces).items():
        load_module_state(module, sds[name], device)


def check_materialized(pipe) -> None:
    """Raises if a module of the pipeline still has a tensor on the meta
    device (a namespace that no file filled)."""
    empty = [name for name, m in pipe.jax_modules().items()
             if any(t.is_meta for t in m.state_dict().values())]
    if empty:
        raise ValueError(f"no weights were loaded for {empty}: give those modules loaded, or "
                         "a checkpoint that holds them")


def jax_params_from_module(module: nn.Module) -> dict:
    """The inverse of `load_jax_model`: {"params": Flax-named tree} of
    fp32 numpy arrays. A `weight` becomes `kernel` under a linear layer
    (transposed back to (in, out)), a conv (OIHW back to HWIO) or a
    transposed conv (flipped back), `embedding` under an `nn.Embedding`
    and `scale` under any other module (the norms); biases and bare
    parameters (CLIP's `position_embedding`, T5's
    `relative_attention_bias`) keep their names. A dropped `GroupNorm_0`
    scope is not restored."""
    owners = dict(module.named_modules())
    tree: dict = {}
    for key, t in module.state_dict().items():
        mod_name, _, leaf = key.rpartition(".")
        owner = owners[mod_name]
        a = t.detach().float().cpu().numpy()
        if leaf == "weight":
            if isinstance(owner, nn.ConvTranspose2d):
                a, leaf = a.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
            elif isinstance(owner, nn.Conv2d):
                a, leaf = a.transpose(2, 3, 1, 0), "kernel"
            elif isinstance(owner, nn.Linear):
                a, leaf = a.T, "kernel"
            elif isinstance(owner, nn.Embedding):
                leaf = "embedding"
            else:
                leaf = "scale"
        node = tree
        for part in mod_name.split(".") if mod_name else ():
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}
def load_jax_model(module: nn.Module, params: Mapping) -> None:
    """Loads one model's Flax tree ({"params": {...}}, no namespaces) into
    `module`, strictly, with the flip rule at its `nn.ConvTranspose2d`s."""
    convt = {name for name, m in module.named_modules() if isinstance(m, nn.ConvTranspose2d)}
    module.load_state_dict(state_dict_from_jax(params, convt), strict=True)
