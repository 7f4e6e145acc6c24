"""Reference ldm checkpoints (`.ckpt`, `.safetensors`) in and out of the
PyTorch port.

Counterpart of `prompt_diffusion_tpu/tools/torch_import.py`, which turns a
reference checkpoint into Flax trees. Here each reference key maps straight
onto the port's state-dict key, in torch layout: the rule tables list the
same (torch prefix, Flax path, kind) triples as the JAX package's, and the
port's key of a Flax path comes from the bridge's naming rule
(`jax_bridge.torch_name`), since the port's modules carry the Flax names.
Conv (O, I, kh, kw) and linear (out, in) weights already have the port's
layout, so import and export only rename, and export is the exact inverse.
Values keep their dtype (bf16 and fp16 included) until the pipeline's
loader copies them into its parameters (`jax_bridge.load_state_dicts`).

Four reference namespaces: model.diffusion_model.* -> unet ;
control_model.* -> controlnet ; first_stage_model.* -> vae ;
cond_stage_model.* -> clip. Replaces the reference's `cldm/model.py:12-21`
load_state_dict and `tool_add_control.py:27-77` (a UNet's encoder copied
into a ControlNet).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig
from prompt_diffusion_tpu_torch.tools import safetensors_io
from prompt_diffusion_tpu_torch.tools.jax_bridge import torch_name

StateDict = Dict[str, torch.Tensor]

# the Flax leaf that holds a rule's `.weight`, by kind
LEAF = {"conv": "kernel", "linear": "kernel", "norm": "scale", "norm_ln": "scale",
        "embed": "embedding"}
CLIP_POSITION = "transformer.text_model.embeddings.position_embedding.weight"


def load_torch_state_dict(path: str) -> StateDict:
    """A torch `.ckpt`/`.pth`/`.bin` (its "state_dict" payload where it has
    one; loaded with `weights_only`, memory-mapped) or a `.safetensors`
    file -> {key: torch tensor}, dtypes kept."""
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v) for k, v in sd.items()}


# --------------------------------------------------------------------------
# key-mapping tables. Each entry: (torch prefix, Flax path, kind), kind in
# {conv, linear, norm, norm_ln, embed}; the prefix's .weight and .bias map
# onto the path's weight leaf (LEAF[kind]) and bias.
# --------------------------------------------------------------------------

def _res_map(tprefix: str, fprefix: str):
    return [
        (f"{tprefix}.in_layers.0", f"{fprefix}/in_norm", "norm"),
        (f"{tprefix}.in_layers.2", f"{fprefix}/in_conv", "conv"),
        (f"{tprefix}.emb_layers.1", f"{fprefix}/emb_proj", "linear"),
        (f"{tprefix}.out_layers.0", f"{fprefix}/out_norm", "norm"),
        (f"{tprefix}.out_layers.3", f"{fprefix}/out_conv", "conv"),
        (f"{tprefix}.skip_connection", f"{fprefix}/skip", "conv"),
    ]


def _attn_map(tprefix: str, fprefix: str, depth: int = 1):
    rules = [
        (f"{tprefix}.norm", f"{fprefix}/norm", "norm"),
        (f"{tprefix}.proj_in", f"{fprefix}/proj_in", "conv"),
        (f"{tprefix}.proj_out", f"{fprefix}/proj_out", "conv"),
    ]
    for dd in range(depth):
        tb = f"{tprefix}.transformer_blocks.{dd}"
        fb = f"{fprefix}/block_{dd}"
        for a in ("attn1", "attn2"):
            rules += [
                (f"{tb}.{a}.to_q", f"{fb}/{a}/to_q", "linear"),
                (f"{tb}.{a}.to_k", f"{fb}/{a}/to_k", "linear"),
                (f"{tb}.{a}.to_v", f"{fb}/{a}/to_v", "linear"),
                (f"{tb}.{a}.to_out.0", f"{fb}/{a}/to_out", "linear"),
            ]
        rules += [
            (f"{tb}.ff.net.0.proj", f"{fb}/ff/proj", "linear"),
            (f"{tb}.ff.net.2", f"{fb}/ff/out", "linear"),
            (f"{tb}.norm1", f"{fb}/norm1", "norm"),
            (f"{tb}.norm2", f"{fb}/norm2", "norm"),
            (f"{tb}.norm3", f"{fb}/norm3", "norm"),
        ]
    return rules


def unet_key_rules(cfg: UNetConfig, is_controlnet: bool = False):
    """(torch prefix, Flax path, kind) rules for the ldm UNet / ControlNet."""
    rules = [
        ("time_embed.0", "time_embed/fc1", "linear"),
        ("time_embed.2", "time_embed/fc2", "linear"),
    ]
    enc_plan, _, _, ds = cfg.encoder_plan()
    for i, (kind, _, has_attn) in enumerate(enc_plan):
        if kind == "conv":
            rules.append((f"input_blocks.{i}.0", f"input_blocks_{i}_conv", "conv"))
        elif kind == "res":
            rules += _res_map(f"input_blocks.{i}.0", f"input_blocks_{i}_res")
            if has_attn:
                rules += _attn_map(
                    f"input_blocks.{i}.1", f"input_blocks_{i}_attn", cfg.transformer_depth
                )
        elif kind == "down":
            rules.append((f"input_blocks.{i}.0.op", f"input_blocks_{i}_down/conv", "conv"))

    rules += _res_map("middle_block.0", "middle_block_0")
    rules += _attn_map("middle_block.1", "middle_block_1", cfg.transformer_depth)
    rules += _res_map("middle_block.2", "middle_block_2")

    if is_controlnet:
        for i in range(len(enc_plan)):
            rules.append((f"zero_convs.{i}.0", f"zero_convs_{i}", "conv"))
        rules.append(("middle_block_out.0", "middle_block_out", "conv"))
        for blk in ("input_hint_block", "input_cond_block"):
            for j in range(7):
                rules.append((f"{blk}.{2 * j}", f"{blk}/conv_{j}", "conv"))
            rules.append((f"{blk}.14", f"{blk}/conv_out", "conv"))
    else:
        # the port's decoder plan takes the final downsampling factor only
        for i, (_, _, has_attn, has_up) in enumerate(cfg.decoder_plan(ds)):
            rules += _res_map(f"output_blocks.{i}.0", f"output_blocks_{i}_res")
            up_idx = 1
            if has_attn:
                rules += _attn_map(
                    f"output_blocks.{i}.1", f"output_blocks_{i}_attn", cfg.transformer_depth
                )
                up_idx = 2
            if has_up:
                rules.append(
                    (f"output_blocks.{i}.{up_idx}.conv", f"output_blocks_{i}_up/conv", "conv")
                )
        rules.append(("out.0", "out_norm", "norm"))
        rules.append(("out.2", "out_conv", "conv"))
    return rules


def vae_key_rules(ch_mult: Tuple[int, ...] = (1, 2, 4, 4), num_res_blocks: int = 2):
    rules = [("quant_conv", "quant_conv", "conv"), ("post_quant_conv", "post_quant_conv", "conv")]

    def vres(tp, fp):
        return [
            (f"{tp}.norm1", f"{fp}/norm1", "norm"),
            (f"{tp}.conv1", f"{fp}/conv1", "conv"),
            (f"{tp}.norm2", f"{fp}/norm2", "norm"),
            (f"{tp}.conv2", f"{fp}/conv2", "conv"),
            (f"{tp}.nin_shortcut", f"{fp}/nin_shortcut", "conv"),
        ]

    def vattn(tp, fp):
        return [
            (f"{tp}.norm", f"{fp}/norm", "norm"),
            (f"{tp}.q", f"{fp}/q", "conv"),
            (f"{tp}.k", f"{fp}/k", "conv"),
            (f"{tp}.v", f"{fp}/v", "conv"),
            (f"{tp}.proj_out", f"{fp}/proj_out", "conv"),
        ]

    for side in ("encoder", "decoder"):
        rules.append((f"{side}.conv_in", f"{side}/conv_in", "conv"))
        rules.append((f"{side}.conv_out", f"{side}/conv_out", "conv"))
        rules.append((f"{side}.norm_out", f"{side}/norm_out", "norm"))
        rules += vres(f"{side}.mid.block_1", f"{side}/mid_block_1")
        rules += vattn(f"{side}.mid.attn_1", f"{side}/mid_attn_1")
        rules += vres(f"{side}.mid.block_2", f"{side}/mid_block_2")
    for lv in range(len(ch_mult)):
        for i in range(num_res_blocks):
            rules += vres(f"encoder.down.{lv}.block.{i}", f"encoder/down_{lv}_block_{i}")
        if lv != len(ch_mult) - 1:
            rules.append(
                (f"encoder.down.{lv}.downsample.conv", f"encoder/down_{lv}_downsample", "conv")
            )
        for i in range(num_res_blocks + 1):
            rules += vres(f"decoder.up.{lv}.block.{i}", f"decoder/up_{lv}_block_{i}")
        if lv != 0:
            rules.append((f"decoder.up.{lv}.upsample.conv", f"decoder/up_{lv}_upsample", "conv"))
    return rules


def clip_key_rules(num_layers: int = 12):
    tm = "transformer.text_model"
    rules = [
        (f"{tm}.embeddings.token_embedding", "token_embedding", "embed"),
        (f"{tm}.final_layer_norm", "final_layer_norm", "norm_ln"),
    ]
    for i in range(num_layers):
        tp = f"{tm}.encoder.layers.{i}"
        fp = f"layers_{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rules.append((f"{tp}.self_attn.{proj}", f"{fp}/self_attn/{proj}", "linear"))
        rules += [
            (f"{tp}.layer_norm1", f"{fp}/layer_norm1", "norm_ln"),
            (f"{tp}.layer_norm2", f"{fp}/layer_norm2", "norm_ln"),
            (f"{tp}.mlp.fc1", f"{fp}/fc1", "linear"),
            (f"{tp}.mlp.fc2", f"{fp}/fc2", "linear"),
        ]
    return rules


# --------------------------------------------------------------------------
# applying rules, both ways
# --------------------------------------------------------------------------

def rule_keys(rules):
    """[(reference key, port key)] for every .weight and .bias the rules
    name; the port key is the bridge's name of the Flax path's leaf."""
    pairs = []
    for tprefix, fpath, kind in rules:
        path = tuple(fpath.split("/"))
        pairs.append((f"{tprefix}.weight", torch_name(path + (LEAF[kind],))))
        pairs.append((f"{tprefix}.bias", torch_name(path + ("bias",))))
    return pairs


def apply_rules(sd: Mapping[str, torch.Tensor], rules, strip_prefix: str = "") -> StateDict:
    """A reference state dict -> one namespace's port state dict, through
    `rules`, after `strip_prefix`. Keys the rules name but the file lacks
    are skipped (e.g. absent skip connections); CLIP's bare position
    embedding maps directly."""
    n = len(strip_prefix)
    sd = {k[n:]: v for k, v in sd.items() if k.startswith(strip_prefix)}
    out: StateDict = {}
    for ref_key, key in rule_keys(rules):
        if ref_key in sd:
            out[key] = sd[ref_key]
    if CLIP_POSITION in sd:
        out["position_embedding"] = sd[CLIP_POSITION]
    return out


def export_rules(sd: Mapping[str, torch.Tensor], rules, prefix: str = "") -> StateDict:
    """One namespace's port state dict -> reference keys (with `prefix`),
    through the same rule tables as the import: its exact inverse. Values
    are contiguous CPU tensors of their own dtype."""
    out: StateDict = {}

    def put(key, value):
        out[f"{prefix}{key}"] = value.detach().to("cpu").contiguous()

    for ref_key, key in rule_keys(rules):
        if key in sd:
            put(ref_key, sd[key])
    if "position_embedding" in sd:
        put(CLIP_POSITION, sd["position_embedding"])
    return out


def _namespace_rules(unet_cfg: UNetConfig, vae_ch_mult, vae_num_res_blocks, clip_layers):
    """{namespace: (reference prefix, rules)} of an SD1.5 checkpoint."""
    return {
        "unet": ("model.diffusion_model.", unet_key_rules(unet_cfg)),
        "controlnet": ("control_model.", unet_key_rules(unet_cfg, is_controlnet=True)),
        "vae": ("first_stage_model.", vae_key_rules(vae_ch_mult, vae_num_res_blocks)),
        "clip": ("cond_stage_model.", clip_key_rules(clip_layers)),
    }


def import_ldm_checkpoint(
    path: str,
    unet_cfg: UNetConfig = UNetConfig(),
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
    vae_num_res_blocks: int = 2,
    clip_layers: int = 12,
) -> Dict[str, StateDict]:
    """A reference `.ckpt`/`.safetensors` -> {"unet", "controlnet", "vae",
    "clip"} port state dicts, for `jax_bridge.load_state_dicts`."""
    sd = load_torch_state_dict(path)
    return {name: apply_rules(sd, rules, prefix) for name, (prefix, rules) in
            _namespace_rules(unet_cfg, vae_ch_mult, vae_num_res_blocks, clip_layers).items()}


def export_ldm_checkpoint(
    state_dicts: Mapping[str, Mapping[str, torch.Tensor]],
    path: str,
    unet_cfg: UNetConfig = UNetConfig(),
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
    vae_num_res_blocks: int = 2,
    clip_layers: int = 12,
) -> None:
    """{"unet", "controlnet", "vae", "clip"} port state dicts (any subset;
    `PromptDiffusionSD15.state_dicts()`) -> a reference checkpoint in the
    four namespaces: a torch file with a "state_dict" payload, loadable by
    `cldm/model.py:12-28`, or, for a path ending in `.safetensors`, the
    flat dict through `safetensors_io`. The inverse of
    `import_ldm_checkpoint`; each tensor keeps its dtype."""
    sd: StateDict = {}
    for name, (prefix, rules) in _namespace_rules(
            unet_cfg, vae_ch_mult, vae_num_res_blocks, clip_layers).items():
        if name in state_dicts:
            sd.update(export_rules(state_dicts[name], rules, prefix))
    if path.endswith(".safetensors"):
        safetensors_io.save_file(sd, path)
    else:
        torch.save({"state_dict": sd}, path)


def controlnet_init_from_unet(unet_sd: Mapping[str, torch.Tensor],
                              controlnet_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """`tool_add_control.py`: a ControlNet state dict whose modules that
    the UNet also has (the shared encoder: time embedding, input and middle
    blocks) are the UNet's; the hint encoders and zero convs keep theirs."""
    top = lambda key: key.split(".", 1)[0]
    shared = {top(k) for k in unet_sd} & {top(k) for k in controlnet_sd}
    out = {k: v for k, v in controlnet_sd.items() if top(k) not in shared}
    out.update({k: v for k, v in unet_sd.items() if top(k) in shared})
    return out


def _fit(src, dst_shape):
    """`src` resized to `dst_shape` cyclically: out[i] = src[i % src.shape]
    on every axis, by one modular index per axis."""
    if tuple(src.shape) == tuple(dst_shape):
        return src
    if len(src.shape) != len(dst_shape):
        raise ValueError(f"cannot fit rank {len(src.shape)} into rank {len(dst_shape)}")
    out = src
    for axis, (d, s) in enumerate(zip(dst_shape, src.shape)):
        if d != s:
            idx = np.arange(d) % s
            out = (out.index_select(axis, torch.from_numpy(idx).to(out.device))
                   if isinstance(out, torch.Tensor) else np.take(out, idx, axis=axis))
    return out


def make_it_fit(imported, template):
    """Cyclic weight resizing for shape-mismatched imports (the
    `make_it_fit` surgery of ddpm.py:209-270, for a checkpoint loaded into
    a model with widened or narrowed layers): every mismatched axis is
    filled by cycling the source values, matching leaves pass through, a
    leaf missing from `imported` is None. Nested or flat dicts of torch
    tensors or numpy arrays; `template`'s leaves need only a shape."""
    if isinstance(template, Mapping):
        return {k: make_it_fit(imported.get(k), v) if isinstance(imported, Mapping) else None
                for k, v in template.items()}
    if imported is None:
        return None
    return _fit(imported, tuple(template.shape))


def validate_tree_shapes(imported, reference, path: str = "") -> list:
    """Compare two (nested or flat) dicts' leaf shapes; returns a list of
    mismatch strings."""
    errs = []
    if isinstance(reference, Mapping):
        for k, v in reference.items():
            if not isinstance(imported, Mapping) or k not in imported:
                errs.append(f"missing {path}/{k}")
            else:
                errs += validate_tree_shapes(imported[k], v, f"{path}/{k}")
    else:
        ish = getattr(imported, "shape", None)
        rsh = getattr(reference, "shape", None)
        if ish is not None:
            ish = tuple(ish)
        if rsh is not None:
            rsh = tuple(rsh)
        if ish != rsh:
            errs.append(f"shape mismatch {path}: {ish} vs {rsh}")
    return errs
