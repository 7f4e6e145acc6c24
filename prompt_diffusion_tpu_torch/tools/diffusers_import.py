"""HF-diffusers checkpoint folders in and out of the PyTorch port.

Counterpart of `prompt_diffusion_tpu/tools/diffusers_import.py`. The
reference publishes diffusers `save_pretrained` folders
(`zhendongw/prompt-diffusion-diffusers`, README.md:84-85): one
`diffusion_pytorch_model.safetensors` (or `model.safetensors`, or a `.bin`)
per component. The rule tables are the JAX package's; as in
`tools/torch_import.py` each key maps straight onto the port's state-dict
key in torch layout:

  * UNet2DConditionModel -> models.unet_sd15.UNetSD15
  * PromptDiffusionControlNetModel (promptdiffusioncontrolnet.py:31-391)
    -> models.controlnet_sd15.ControlNetSD15 (its two conditioning
    embeddings onto the two HintEncoders)
  * AutoencoderKL -> models.vae.AutoencoderKL (the Linear attention of
    diffusers reshaped to the port's 1x1 convs; both key schemes)
  * CLIPTextModel -> models.clip_text.CLIPTextModel
  * SD3: the MMDiT, the SD3 ControlNet (with `down_proj`), the z=16 VAE,
    CLIP-L, CLIP-bigG and T5 (`import_sd3_folder`).
`.safetensors` is read and written by `tools/safetensors_io.py`.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import torch

from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig
from prompt_diffusion_tpu_torch.tools import safetensors_io
from prompt_diffusion_tpu_torch.tools.torch_import import (
    StateDict,
    apply_rules,
    clip_key_rules,
    export_rules,
)


def load_component_state(folder: str) -> StateDict:
    """A diffusers component folder's weights (safetensors preferred)."""
    st = os.path.join(folder, "diffusion_pytorch_model.safetensors")
    if not os.path.exists(st):
        st = os.path.join(folder, "model.safetensors")
    if os.path.exists(st):
        return safetensors_io.load_file(st)
    bin_path = os.path.join(folder, "diffusion_pytorch_model.bin")
    if not os.path.exists(bin_path):
        bin_path = os.path.join(folder, "pytorch_model.bin")
    return dict(torch.load(bin_path, map_location="cpu", weights_only=True))


# ---------------------------------------------------------------------------
# diffusers UNet / ControlNet encoder keys -> ldm-style sequential indices
# ---------------------------------------------------------------------------

def _res_rules(tp: str, fp: str):
    return [
        (f"{tp}.norm1", f"{fp}/in_norm", "norm"),
        (f"{tp}.conv1", f"{fp}/in_conv", "conv"),
        (f"{tp}.time_emb_proj", f"{fp}/emb_proj", "linear"),
        (f"{tp}.norm2", f"{fp}/out_norm", "norm"),
        (f"{tp}.conv2", f"{fp}/out_conv", "conv"),
        (f"{tp}.conv_shortcut", f"{fp}/skip", "conv"),
    ]


def _attn_rules(tp: str, fp: str, depth: int = 1):
    rules = [
        (f"{tp}.norm", f"{fp}/norm", "norm"),
        (f"{tp}.proj_in", f"{fp}/proj_in", "conv"),
        (f"{tp}.proj_out", f"{fp}/proj_out", "conv"),
    ]
    for d in range(depth):
        tb, fb = f"{tp}.transformer_blocks.{d}", f"{fp}/block_{d}"
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


def diffusers_unet_rules(cfg: UNetConfig = UNetConfig(), encoder_only: bool = False):
    """Rules in apply_rules format for a diffusers UNet2DConditionModel."""
    rules = [
        ("conv_in", "input_blocks_0_conv", "conv"),
        ("time_embedding.linear_1", "time_embed/fc1", "linear"),
        ("time_embedding.linear_2", "time_embed/fc2", "linear"),
    ]
    n = cfg.num_res_blocks
    levels = len(cfg.channel_mult)
    for lv in range(levels):
        for i in range(n):
            seq = 1 + lv * (n + 1) + i
            rules += _res_rules(f"down_blocks.{lv}.resnets.{i}", f"input_blocks_{seq}_res")
            rules += _attn_rules(
                f"down_blocks.{lv}.attentions.{i}", f"input_blocks_{seq}_attn",
                cfg.transformer_depth,
            )
        if lv != levels - 1:
            seq = (lv + 1) * (n + 1)
            rules.append(
                (f"down_blocks.{lv}.downsamplers.0.conv", f"input_blocks_{seq}_down/conv", "conv")
            )
    rules += _res_rules("mid_block.resnets.0", "middle_block_0")
    rules += _attn_rules("mid_block.attentions.0", "middle_block_1", cfg.transformer_depth)
    rules += _res_rules("mid_block.resnets.1", "middle_block_2")
    if encoder_only:
        return rules

    for lv in range(levels):  # up_blocks index 0 = deepest level
        for i in range(n + 1):
            seq = lv * (n + 1) + i
            rules += _res_rules(f"up_blocks.{lv}.resnets.{i}", f"output_blocks_{seq}_res")
            rules += _attn_rules(
                f"up_blocks.{lv}.attentions.{i}", f"output_blocks_{seq}_attn",
                cfg.transformer_depth,
            )
        if lv != levels - 1:
            seq = lv * (n + 1) + n
            rules.append(
                (f"up_blocks.{lv}.upsamplers.0.conv", f"output_blocks_{seq}_up/conv", "conv")
            )
    rules += [("conv_norm_out", "out_norm", "norm"), ("conv_out", "out_conv", "conv")]
    return rules


def _hint_rules(tprefix: str, fprefix: str):
    """ControlNetConditioningEmbedding -> HintEncoder: conv_in + blocks.0-5
    + conv_out map onto conv_0..conv_6 + conv_out."""
    rules = [(f"{tprefix}.conv_in", f"{fprefix}/conv_0", "conv")]
    for j in range(6):
        rules.append((f"{tprefix}.blocks.{j}", f"{fprefix}/conv_{j + 1}", "conv"))
    rules.append((f"{tprefix}.conv_out", f"{fprefix}/conv_out", "conv"))
    return rules


def diffusers_controlnet_rules(cfg: UNetConfig = UNetConfig()):
    rules = diffusers_unet_rules(cfg, encoder_only=True)
    rules += _hint_rules("controlnet_cond_embedding", "input_hint_block")
    rules += _hint_rules("controlnet_query_cond_embedding", "input_cond_block")
    n_taps = 1 + len(cfg.channel_mult) * cfg.num_res_blocks + (len(cfg.channel_mult) - 1)
    for i in range(n_taps):
        rules.append((f"controlnet_down_blocks.{i}", f"zero_convs_{i}", "conv"))
    rules.append(("controlnet_mid_block", "middle_block_out", "conv"))
    return rules


def diffusers_vae_rules(ch_mult=(1, 2, 4, 4), num_res_blocks=2):
    def vres(tp, fp):
        return [
            (f"{tp}.norm1", f"{fp}/norm1", "norm"),
            (f"{tp}.conv1", f"{fp}/conv1", "conv"),
            (f"{tp}.norm2", f"{fp}/norm2", "norm"),
            (f"{tp}.conv2", f"{fp}/conv2", "conv"),
            (f"{tp}.conv_shortcut", f"{fp}/nin_shortcut", "conv"),
        ]

    rules = [("quant_conv", "quant_conv", "conv"), ("post_quant_conv", "post_quant_conv", "conv")]
    for side, blocks_name in (("encoder", "down_blocks"), ("decoder", "up_blocks")):
        rules += [
            (f"{side}.conv_in", f"{side}/conv_in", "conv"),
            (f"{side}.conv_out", f"{side}/conv_out", "conv"),
            (f"{side}.conv_norm_out", f"{side}/norm_out", "norm"),
        ]
        rules += vres(f"{side}.mid_block.resnets.0", f"{side}/mid_block_1")
        rules += vres(f"{side}.mid_block.resnets.1", f"{side}/mid_block_2")
        # the VAE attention is Linear-based in diffusers: `_vae_attention`
        levels = len(ch_mult)
        for bl in range(levels):
            # decoder's up_blocks.0 = deepest level => ldm up_{levels-1-bl}
            fl = bl if side == "encoder" else levels - 1 - bl
            n = num_res_blocks if side == "encoder" else num_res_blocks + 1
            for i in range(n):
                rules += vres(f"{side}.{blocks_name}.{bl}.resnets.{i}",
                              f"{side}/{'down' if side == 'encoder' else 'up'}_{fl}_block_{i}")
            if side == "encoder" and bl != levels - 1:
                rules.append((f"encoder.down_blocks.{bl}.downsamplers.0.conv",
                              f"encoder/down_{fl}_downsample", "conv"))
            if side == "decoder" and fl != 0:
                rules.append((f"decoder.up_blocks.{bl}.upsamplers.0.conv",
                              f"decoder/up_{fl}_upsample", "conv"))
    return rules


def _vae_attention(out: StateDict, sd: Mapping[str, torch.Tensor], side: str) -> None:
    """diffusers' Linear (or 1x1-conv) attention -> the port's 1x1-conv
    VAEAttnBlock entries of `side`, added to `out`."""
    tp = f"{side}.mid_block.attentions.0"
    if f"{tp}.to_q.weight" in sd:  # diffusers >= 0.18 Attention
        names = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out"}
    elif f"{tp}.query.weight" in sd:  # diffusers <= 0.17 AttentionBlock
        names = {"query": "q", "key": "k", "value": "v", "proj_attn": "proj_out"}
    else:
        raise KeyError(
            f"unrecognized VAE attention key scheme under '{tp}.*' — "
            "expected to_q/... (diffusers>=0.18) or query/... (<=0.17); "
            f"sample keys: {[k for k in sd if k.startswith(tp)][:4]}")
    fp = f"{side}.mid_attn_1"
    out[f"{fp}.norm.weight"] = sd[f"{tp}.group_norm.weight"]
    out[f"{fp}.norm.bias"] = sd[f"{tp}.group_norm.bias"]
    for tname, fname in names.items():
        w = sd[f"{tp}.{tname}.weight"]  # (C, C) linear, or (C, C, 1, 1)
        out[f"{fp}.{fname}.weight"] = w.reshape(w.shape[0], w.shape[1], 1, 1)
        out[f"{fp}.{fname}.bias"] = sd[f"{tp}.{tname}.bias"]


def _export_vae(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The port's VAE state dict -> diffusers keys, the attention in the
    diffusers >= 0.18 scheme with Linear (C, C) weights."""
    out = export_rules(sd, diffusers_vae_rules())
    names = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0"}
    for side in ("encoder", "decoder"):
        fp, tp = f"{side}.mid_attn_1", f"{side}.mid_block.attentions.0"
        out[f"{tp}.group_norm.weight"] = sd[f"{fp}.norm.weight"].detach().cpu().contiguous()
        out[f"{tp}.group_norm.bias"] = sd[f"{fp}.norm.bias"].detach().cpu().contiguous()
        for fname, tname in names.items():
            w = sd[f"{fp}.{fname}.weight"]
            out[f"{tp}.{tname}.weight"] = w.detach().cpu().reshape(w.shape[0], w.shape[1]).contiguous()
            out[f"{tp}.{tname}.bias"] = sd[f"{fp}.{fname}.bias"].detach().cpu().contiguous()
    return out


def _import_vae(sd: Mapping[str, torch.Tensor]) -> StateDict:
    out = apply_rules(sd, diffusers_vae_rules())
    _vae_attention(out, sd, "encoder")
    _vae_attention(out, sd, "decoder")
    return out


def _import_clip(sd: Mapping[str, torch.Tensor], num_layers: int) -> StateDict:
    return apply_rules({f"transformer.{k}": v for k, v in sd.items()}, clip_key_rules(num_layers))


def import_diffusers_folder(root: str, unet_cfg: UNetConfig = UNetConfig()) -> Dict[str, StateDict]:
    """A prompt-diffusion-diffusers folder -> {"unet", "controlnet", "vae"
    and, when the folder has text_encoder/, "clip"} port state dicts."""
    sds = {
        "unet": apply_rules(load_component_state(os.path.join(root, "unet")),
                            diffusers_unet_rules(unet_cfg)),
        "controlnet": apply_rules(load_component_state(os.path.join(root, "controlnet")),
                                  diffusers_controlnet_rules(unet_cfg)),
        "vae": _import_vae(load_component_state(os.path.join(root, "vae"))),
    }
    te_dir = os.path.join(root, "text_encoder")
    if os.path.isdir(te_dir):
        sds["clip"] = _import_clip(load_component_state(te_dir), 12)
    return sds


# ---------------------------------------------------------------------------
# SD3 (MMDiT)
# ---------------------------------------------------------------------------

def sd3_block_rules(i: int, context_pre_only: bool):
    tb, fb = f"transformer_blocks.{i}", f"blocks_{i}"
    rules = [
        (f"{tb}.norm1.linear", f"{fb}/norm1/proj", "linear"),
        (f"{tb}.norm1_context.linear", f"{fb}/norm1_context/proj", "linear"),
        (f"{tb}.attn.to_q", f"{fb}/to_q", "linear"),
        (f"{tb}.attn.to_k", f"{fb}/to_k", "linear"),
        (f"{tb}.attn.to_v", f"{fb}/to_v", "linear"),
        (f"{tb}.attn.add_q_proj", f"{fb}/add_q_proj", "linear"),
        (f"{tb}.attn.add_k_proj", f"{fb}/add_k_proj", "linear"),
        (f"{tb}.attn.add_v_proj", f"{fb}/add_v_proj", "linear"),
        (f"{tb}.attn.to_out.0", f"{fb}/to_out", "linear"),
        (f"{tb}.ff.net.0.proj", f"{fb}/ff_in", "linear"),
        (f"{tb}.ff.net.2", f"{fb}/ff_out", "linear"),
    ]
    if not context_pre_only:
        rules += [
            (f"{tb}.attn.to_add_out", f"{fb}/to_add_out", "linear"),
            (f"{tb}.ff_context.net.0.proj", f"{fb}/ff_context_in", "linear"),
            (f"{tb}.ff_context.net.2", f"{fb}/ff_context_out", "linear"),
        ]
    return rules


def sd3_transformer_rules(num_layers: int = 24):
    rules = [
        ("pos_embed.proj", "pos_embed/proj", "conv"),
        ("time_text_embed.timestep_embedder.linear_1", "time_text_embed/timestep_fc1", "linear"),
        ("time_text_embed.timestep_embedder.linear_2", "time_text_embed/timestep_fc2", "linear"),
        ("time_text_embed.text_embedder.linear_1", "time_text_embed/text_fc1", "linear"),
        ("time_text_embed.text_embedder.linear_2", "time_text_embed/text_fc2", "linear"),
        ("context_embedder", "context_embedder", "linear"),
        ("norm_out.linear", "norm_out_proj", "linear"),
        ("proj_out", "proj_out", "linear"),
    ]
    for i in range(num_layers):
        rules += sd3_block_rules(i, context_pre_only=(i == num_layers - 1))
    return rules


def sd3_controlnet_rules(num_layers: int = 12):
    rules = [
        ("pos_embed.proj", "pos_embed/proj", "conv"),
        ("pos_embed_input.proj", "pos_embed_input", "conv"),
        ("down_proj", "down_proj", "conv"),  # its own module (namespace) in the port
        ("time_text_embed.timestep_embedder.linear_1", "time_text_embed/timestep_fc1", "linear"),
        ("time_text_embed.timestep_embedder.linear_2", "time_text_embed/timestep_fc2", "linear"),
        ("time_text_embed.text_embedder.linear_1", "time_text_embed/text_fc1", "linear"),
        ("time_text_embed.text_embedder.linear_2", "time_text_embed/text_fc2", "linear"),
        ("context_embedder", "context_embedder", "linear"),
    ]
    for i in range(num_layers):
        rules += sd3_block_rules(i, context_pre_only=False)
        rules.append((f"controlnet_blocks.{i}", f"controlnet_blocks_{i}", "linear"))
    return rules


# ---------------------------------------------------------------------------
# export to diffusers folders (save_pretrained-compatible weight files)
# ---------------------------------------------------------------------------

def save_component(sd: Mapping[str, torch.Tensor], folder: str,
                   name: str = "diffusion_pytorch_model.safetensors") -> None:
    """Writes a component folder's weights file (`model.safetensors` for
    the text encoders)."""
    os.makedirs(folder, exist_ok=True)
    safetensors_io.save_file(sd, os.path.join(folder, name))


def export_diffusers_controlnet(controlnet_sd: Mapping[str, torch.Tensor], folder: str,
                                cfg: UNetConfig = UNetConfig()) -> None:
    """The ControlNet's port state dict -> a diffusers weights file that
    the reference's PromptDiffusionControlNetModel.from_pretrained reads
    (the trainer's save_pretrained hook output,
    train_promptdiffusion_sd15.py:801-827). Inverse of the import rules."""
    save_component(export_rules(controlnet_sd, diffusers_controlnet_rules(cfg)), folder)


def export_sd3_controlnet(state_dicts: Mapping[str, Mapping[str, torch.Tensor]], folder: str,
                          num_layers: int = 12) -> None:
    """{"controlnet", optional "down_proj"} port state dicts -> diffusers
    weights for the reference SD3PromptDiffusionModel (inverse of the
    sd3_controlnet_rules import)."""
    sd = dict(state_dicts["controlnet"])
    sd.update(state_dicts.get("down_proj", {}))
    save_component(export_rules(sd, sd3_controlnet_rules(num_layers)), folder)


def t5_params_from_state_dict(sd: Mapping[str, torch.Tensor], num_layers: int) -> StateDict:
    """HF `T5EncoderModel` state dict -> the port's T5Encoder state dict
    (the reference loads T5 as text_encoder_3, train_promptdiffusion_sd3.py:
    871-906). T5 linears carry no bias and keep their (out, in) layout;
    RMSNorms carry a scale only; the relative-position bucket table lives
    on block 0's attention."""
    out = {"token_embedding.weight": sd["shared.weight"],
           "final_norm.weight": sd["encoder.final_layer_norm.weight"]}
    for i in range(num_layers):
        e, b = f"encoder.block.{i}", f"blocks_{i}"
        out[f"{b}.ln_attn.weight"] = sd[f"{e}.layer.0.layer_norm.weight"]
        out[f"{b}.ln_ff.weight"] = sd[f"{e}.layer.1.layer_norm.weight"]
        for n in ("q", "k", "v", "o"):
            out[f"{b}.attn.{n}.weight"] = sd[f"{e}.layer.0.SelfAttention.{n}.weight"]
        for n in ("wi_0", "wi_1", "wo"):
            out[f"{b}.{n}.weight"] = sd[f"{e}.layer.1.DenseReluDense.{n}.weight"]
        rb = sd.get(f"{e}.layer.0.SelfAttention.relative_attention_bias.weight")
        if rb is not None:
            out[f"{b}.attn.relative_attention_bias"] = rb
    return out


def hf_t5_state_dict(sd: Mapping[str, torch.Tensor], num_layers: int) -> StateDict:
    """The inverse of `t5_params_from_state_dict`: the port's T5Encoder
    state dict -> HF `T5EncoderModel` keys."""
    hf_key = t5_params_from_state_dict({k: k for k in _hf_t5_keys(num_layers)}, num_layers)
    return {hf_key[k]: v.detach().cpu().contiguous() for k, v in sd.items()}


def _hf_t5_keys(num_layers: int):
    keys = ["shared.weight", "encoder.final_layer_norm.weight"]
    for i in range(num_layers):
        e = f"encoder.block.{i}"
        keys += [f"{e}.layer.0.layer_norm.weight", f"{e}.layer.1.layer_norm.weight"]
        keys += [f"{e}.layer.0.SelfAttention.{n}.weight" for n in ("q", "k", "v", "o")]
        keys += [f"{e}.layer.1.DenseReluDense.{n}.weight" for n in ("wi_0", "wi_1", "wo")]
    keys.append("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
    return keys


def export_sd3_folder(state_dicts: Mapping[str, Mapping[str, torch.Tensor]], root: str,
                      num_layers: int = 24, controlnet_layers: int = 12) -> None:
    """The inverse of `import_sd3_folder`: {"transformer", "controlnet",
    "down_proj", "vae", "clip_l", "clip_g", "t5"} port state dicts (any
    subset; `PromptDiffusionSD3.jax_modules()`'s) -> an SD3 diffusers
    folder, one component folder each, through the same rule tables."""
    sds = state_dicts
    if "transformer" in sds:
        save_component(export_rules(sds["transformer"], sd3_transformer_rules(num_layers)),
                       os.path.join(root, "transformer"))
    if "controlnet" in sds:
        export_sd3_controlnet(sds, os.path.join(root, "controlnet"), controlnet_layers)
    if "vae" in sds:
        save_component(_export_vae(sds["vae"]), os.path.join(root, "vae"))
    for name, te in (("clip_l", "text_encoder"), ("clip_g", "text_encoder_2")):
        if name in sds:
            layers = _layers(sds[name], "layers_", 0, 0)
            sd = export_rules(sds[name], clip_key_rules(layers))
            save_component({k[len("transformer."):]: v for k, v in sd.items()},
                           os.path.join(root, te), "model.safetensors")
    if "t5" in sds:
        layers = _layers(sds["t5"], "blocks_", 0, 0)
        save_component(hf_t5_state_dict(sds["t5"], layers),
                       os.path.join(root, "text_encoder_3"), "model.safetensors")


def _layers(sd, prefix: str, position: int, default: int) -> int:
    """1 + the largest layer index at dotted `position` of keys under
    `prefix` (a trailing "_<index>" of that part for the port's keys)."""
    index = lambda part: int(part.rsplit("_", 1)[-1])
    return max((index(k.split(".")[position]) for k in sd if k.startswith(prefix)),
               default=default - 1) + 1


def import_sd3_folder(root: str, num_layers: int = 24,
                      controlnet_layers: int = 12) -> Dict[str, StateDict]:
    """An SD3 diffusers folder (transformer/, controlnet/, vae/,
    text_encoder/, text_encoder_2/, text_encoder_3/) -> port state dicts
    for PromptDiffusionSD3 (promptdiffusioncontrolnet_sd3.py checkpoint
    layout), one per folder present: "transformer", "controlnet" and
    "down_proj", "vae", "clip_l", "clip_g", "t5". A missing folder's
    namespaces are left out."""
    sds: Dict[str, StateDict] = {}
    tdir = os.path.join(root, "transformer")
    if os.path.isdir(tdir):
        sds["transformer"] = apply_rules(load_component_state(tdir),
                                         sd3_transformer_rules(num_layers))
    cdir = os.path.join(root, "controlnet")
    if os.path.isdir(cdir):
        sd = apply_rules(load_component_state(cdir), sd3_controlnet_rules(controlnet_layers))
        down = {k: sd.pop(k) for k in [k for k in sd if k.startswith("down_proj.")]}
        sds["controlnet"] = sd
        if down:
            sds["down_proj"] = down
    vdir = os.path.join(root, "vae")
    if os.path.isdir(vdir):
        sds["vae"] = _import_vae(load_component_state(vdir))
    for te, name in (("text_encoder", "clip_l"), ("text_encoder_2", "clip_g")):
        d = os.path.join(root, te)
        if os.path.isdir(d):
            sd = load_component_state(d)
            sds[name] = _import_clip(sd, _layers(sd, "text_model.encoder.layers.", 3, 12))
    d3 = os.path.join(root, "text_encoder_3")
    if os.path.isdir(d3):
        sd = load_component_state(d3)
        sds["t5"] = t5_params_from_state_dict(sd, _layers(sd, "encoder.block.", 2, 24))
    return sds
