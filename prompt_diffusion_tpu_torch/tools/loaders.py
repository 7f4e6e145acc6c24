"""Pipeline-level weight loaders: single file, diffusers folder, LoRA and
textual inversion, for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/tools/loaders.py` (the reference
pipeline's `TextualInversionLoaderMixin, LoraLoaderMixin,
FromSingleFileMixin`, pipeline_prompt_diffusion.py:145,155-156). The JAX
package transforms parameter trees; the port's modules hold their weights,
so these loaders change the pipeline in place:

  * `from_single_file(path)` builds the SD1.5 models on the meta device
    (nothing is initialised) and fills them from a reference `.ckpt` or
    `.safetensors` (`tools/torch_import.py`); `from_diffusers_folder` does
    the same from a diffusers folder (`tools/diffusers_import.py`).
  * `load_lora_weights(pipe, file, scale)` folds scale * B @ A into the
    weights it targets (diffusers' `fuse_lora`): computed in fp64, rounded
    to fp32 and then to the parameter's dtype, written with an in-place copy,
    which bumps the parameter's version, so a quantized layer's int8 cache
    is renewed.
  * `load_textual_inversion(text_encoder, tokenizer, file)` appends the
    learned rows to CLIP's token table, in the table's dtype and on its
    device, and registers the placeholder token(s) with the tokenizer.

LoRA layouts: the diffusers/peft key scheme (`unet.<module>.lora_A.weight`
/ `lora_B.weight`, optional `.alpha`) and the legacy diffusers scheme
(`<module>.lora.down.weight` / `.up.weight`, also `_lora.down/up`);
`text_encoder.<module>...` pairs fold into CLIP. The kohya `lora_unet_*`
underscore flattening is ambiguous to invert and is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from prompt_diffusion_tpu_torch.tools import safetensors_io
from prompt_diffusion_tpu_torch.tools.diffusers_import import (
    diffusers_unet_rules,
    import_diffusers_folder,
)
from prompt_diffusion_tpu_torch.tools.jax_bridge import check_materialized, load_state_dicts
from prompt_diffusion_tpu_torch.tools.torch_import import (
    clip_key_rules,
    import_ldm_checkpoint,
    rule_keys,
)


def _load_state_dict(path_or_sd) -> dict:
    """torch .pt/.ckpt (its "state_dict" payload where it has one),
    .safetensors, or an in-memory dict -> a dict of tensors; nested dicts
    (the A1111 textual-inversion layout) and non-tensor entries ("name")
    are kept."""
    if isinstance(path_or_sd, dict):
        return path_or_sd
    if str(path_or_sd).endswith(".safetensors"):
        return safetensors_io.load_file(str(path_or_sd))
    obj = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    return obj.get("state_dict", obj) if isinstance(obj, dict) else obj


# --------------------------------------------------------------------------
# single file / folder
# --------------------------------------------------------------------------

def build_on_meta(cls, device, create_kwargs, **kw):
    """`cls.create(**kw)` on the meta device, so that no weight is
    initialised, and the namespaces left to load. A model in
    `create_kwargs` built on the meta device takes the default's place; a
    loaded one is kept (moved to `device`, prepared as `create` prepares
    its models, its serving options among them) and its namespace is not
    loaded."""
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import set_serving_options

    loaded = {k: m for k, m in create_kwargs.items()
              if isinstance(m, nn.Module) and not any(t.is_meta for t in m.state_dict().values())}
    pipe = cls.create(device="meta", **kw,
                      **{k: v for k, v in create_kwargs.items() if k not in loaded})
    for attr, m in loaded.items():
        m.to(device=device, memory_format=torch.channels_last).eval().requires_grad_(False)
        denoiser = attr in ("unet", "controlnet")
        set_serving_options(m, kw.get("conv_variant"),
                            kw.get("int8_attention") if denoiser else None,
                            kw.get("fused_geglu") if denoiser else None)
        setattr(pipe, attr, m)
    kept = {id(m) for m in loaded.values()}
    return pipe, {n for n, m in pipe.jax_modules().items() if id(m) not in kept}


def _sd15(device, create_kwargs, **options):
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15

    return build_on_meta(PromptDiffusionSD15, device, create_kwargs, **options)


def from_single_file(path: str, policy=None, vae_int8: bool = False,
                     device: torch.device | str = "cuda", conv_variant: str = "im2col",
                     int8_attention: bool = False, fused_geglu: bool = True,
                     **create_kwargs):
    """An SD1.5 PromptDiffusionSD15 from a reference-format `.ckpt` or
    `.safetensors` (`cldm/model.py` loader semantics): built through
    `create` on the meta device (`create_kwargs`: models built on the meta
    device, e.g. other widths, loaded models to keep, a `schedule`), then
    every other namespace loaded onto `device`, strictly; the rule tables
    follow the models' configs. `conv_variant`, `int8_attention` and
    `fused_geglu` are `PromptDiffusionSD15.create`'s serving options."""
    pipe, todo = _sd15(device, create_kwargs, policy=policy, vae_int8=vae_int8,
                       conv_variant=conv_variant, int8_attention=int8_attention,
                       fused_geglu=fused_geglu)
    sds = import_ldm_checkpoint(path, unet_cfg=pipe.unet.config,
                                vae_ch_mult=pipe.vae.config.ch_mult,
                                vae_num_res_blocks=pipe.vae.config.num_res_blocks,
                                clip_layers=pipe.text_encoder.config.num_layers)
    load_state_dicts(pipe, {n: sds[n] for n in todo}, namespaces=todo, device=device)
    return pipe


def from_diffusers_folder(root: str, policy=None, vae_int8: bool = False,
                          device: torch.device | str = "cuda", conv_variant: str = "im2col",
                          int8_attention: bool = False, fused_geglu: bool = True,
                          **create_kwargs):
    """An SD1.5 PromptDiffusionSD15 from a prompt-diffusion-diffusers
    folder, built as `from_single_file` builds it. A folder without
    text_encoder/ loads the other three namespaces only; its CLIP must
    then come loaded in `create_kwargs` (`text_encoder=`), else this
    raises."""
    pipe, todo = _sd15(device, create_kwargs, policy=policy, vae_int8=vae_int8,
                       conv_variant=conv_variant, int8_attention=int8_attention,
                       fused_geglu=fused_geglu)
    sds = import_diffusers_folder(root, unet_cfg=pipe.unet.config)
    sds = {n: sd for n, sd in sds.items() if n in todo}
    load_state_dicts(pipe, sds, namespaces=set(sds), device=device)
    check_materialized(pipe)
    return pipe


# --------------------------------------------------------------------------
# LoRA
# --------------------------------------------------------------------------

_LORA_SUFFIXES = (
    (".lora_A.weight", ".lora_B.weight"),  # peft
    (".lora.down.weight", ".lora.up.weight"),  # legacy diffusers
    (".lora_down.weight", ".lora_up.weight"),
)


def _collect_lora_pairs(sd) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, Optional[float]]]:
    """{module path: (down, up, alpha)} from any supported layout."""
    if any(k.startswith(("lora_unet_", "lora_te_")) for k in sd):
        raise ValueError(
            "kohya-style 'lora_unet_*' keys detected — convert to the "
            "diffusers key scheme first (underscore-flattened module paths "
            "are ambiguous to invert)"
        )
    pairs: Dict[str, list] = {}
    for k, v in sd.items():
        for down_sfx, up_sfx in _LORA_SUFFIXES:
            if k.endswith(down_sfx):
                pairs.setdefault(k[: -len(down_sfx)], [None, None, None])[0] = v
                break
            if k.endswith(up_sfx):
                pairs.setdefault(k[: -len(up_sfx)], [None, None, None])[1] = v
                break
        if k.endswith(".alpha"):
            pairs.setdefault(k[: -len(".alpha")], [None, None, None])[2] = float(v)
    out = {}
    for mod, (down, up, alpha) in pairs.items():
        if down is None or up is None:
            raise ValueError(f"LoRA pair incomplete for module {mod!r}")
        out[mod] = (down, up, alpha)
    return out


def _lora_delta(down: torch.Tensor, up: torch.Tensor, alpha: Optional[float],
               device=None) -> torch.Tensor:
    """dW = (alpha / rank) * up @ down in fp64, in the torch layout of the
    target (linear (out, in); conv (out, in, kh, kw) with a 1x1 `up`)."""
    rank = down.shape[0]
    d = down.to(device=device, dtype=torch.float64)
    u = up.to(device=device, dtype=torch.float64).reshape(up.shape[0], rank)
    delta = torch.einsum("or,r...->o...", u, d)
    return delta * (alpha / rank) if alpha is not None else delta


def _lora_targets(pipe) -> Dict[str, Tuple[str, Dict[str, str]]]:
    """{file prefix: (namespace, {module path + ".weight": port key})}."""
    unet = dict(rule_keys(diffusers_unet_rules(pipe.unet.config)))
    clip = {k[len("transformer."):]: v
            for k, v in rule_keys(clip_key_rules(pipe.text_encoder.config.num_layers))}
    return {"unet.": ("unet", unet), "text_encoder.": ("clip", clip), "": ("unet", unet)}


@torch.no_grad()
def load_lora_weights(pipe, path_or_sd, scale: float = 1.0) -> Dict[str, list]:
    """Folds a diffusers-format LoRA into the pipeline's UNet and CLIP, in
    place: W <- W + scale * dW, each sum formed in fp64, then rounded to
    fp32 and (a bf16 weight) to W's dtype. A bare module path (no "unet." / "text_encoder." prefix)
    targets the UNet. Raises, before changing any weight, on a layout it
    does not know, an incomplete pair, a module it cannot place or a shape
    that does not match. Returns {namespace: [port keys folded]}."""
    pairs = _collect_lora_pairs(_load_state_dict(path_or_sd))
    if not pairs:
        raise ValueError("no LoRA A/B pairs found in the state dict")
    targets = _lora_targets(pipe)
    modules = pipe.jax_modules()
    params = {name: dict(modules[name].named_parameters()) for name in ("unet", "clip")}
    plan, unknown = [], {"unet": 0, "clip": 0}
    for mod, (down, up, alpha) in pairs.items():
        prefix = next(p for p in ("unet.", "text_encoder.", "") if mod.startswith(p))
        name, keys = targets[prefix]
        key = keys.get(mod[len(prefix):] + ".weight")
        if key not in params[name]:  # no rule, or a block these widths do not build
            unknown[name] += 1
            continue
        param = params[name][key]
        delta = _lora_delta(down, up, alpha, param.device)
        if delta.shape != param.shape:
            raise ValueError(f"LoRA for {mod!r}: delta {tuple(delta.shape)} does not match "
                             f"{key} {tuple(param.shape)}")
        plan.append((name, key, param, delta))
    if unknown["unet"]:
        raise ValueError(f"{unknown['unet']} unet LoRA modules did not match any known "
                         "parameter (diffusers unet key scheme expected)")
    if unknown["clip"]:
        raise ValueError(f"{unknown['clip']} text-encoder LoRA modules did not match any "
                         "known parameter")
    folded: Dict[str, list] = {}
    for name, key, param, delta in plan:
        # fp64 -> fp32 -> the weight's dtype, the same two roundings on any device
        param.copy_((param.double() + scale * delta).float())
        folded.setdefault(name, []).append(key)
    return folded


# --------------------------------------------------------------------------
# textual inversion
# --------------------------------------------------------------------------

@torch.no_grad()
def load_textual_inversion(text_encoder, tokenizer, path_or_sd,
                           token: Optional[str] = None) -> Tuple[str, list]:
    """Appends learned embedding row(s) to the CLIP token table and
    registers the placeholder with the tokenizer (a multi-vector embedding
    expands to consecutive ids, diffusers TextualInversionLoaderMixin
    semantics). Reads the A1111 `.pt` layout ({"string_to_param": {"*":
    (n, D)}, "name": tok}), the diffusers layout ({token: (D,) or (n, D)})
    and safetensors {"emb_params": (n, D)}. The table grows in its dtype,
    on its device, and the encoder's config records the new vocabulary.
    Returns (token, ids)."""
    data = _load_state_dict(path_or_sd)
    if "string_to_param" in data or any(k.startswith("string_to_param.") for k in data):
        emb = data.get("string_to_param.*")
        if emb is None:
            emb = data["string_to_param"]["*"]
        name = data.get("name")
        token = token or (str(name) if name is not None else None)
    elif "emb_params" in data:
        emb = data["emb_params"]
    else:
        arrays = {k: v for k, v in data.items() if isinstance(v, torch.Tensor)}
        if len(arrays) != 1:
            raise ValueError(f"ambiguous textual-inversion file: keys {sorted(data)}")
        (file_token, emb), = arrays.items()
        token = token or file_token
    if token is None:
        raise ValueError("pass token=... (file does not name its placeholder)")
    emb = emb.float()
    if emb.ndim == 1:
        emb = emb[None]
    table = text_encoder.token_embedding.weight
    if emb.shape[1] != table.shape[1]:
        raise ValueError(f"embedding dim {emb.shape[1]} != CLIP dim {table.shape[1]}")
    ids = list(range(table.shape[0], table.shape[0] + emb.shape[0]))
    grown = torch.cat([table.detach(), emb.to(device=table.device, dtype=table.dtype)])
    text_encoder.token_embedding.weight = nn.Parameter(grown, requires_grad=False)
    text_encoder.token_embedding.num_embeddings = grown.shape[0]
    text_encoder.config = dataclasses.replace(text_encoder.config, vocab_size=grown.shape[0])
    tokenizer.add_tokens({token: ids})
    return token, ids
