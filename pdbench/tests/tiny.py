"""Tiny configurations of the two families, for the CPU tests: the
published structure at widths a test run holds."""

from __future__ import annotations

import copy

from pdbench import spec

CLIP = {"vocab_size": 49408, "hidden_size": 32, "num_layers": 2, "num_heads": 2,
        "intermediate_size": 64, "max_positions": 77, "layer_norm_eps": 1e-05,
        "activation": "quick_gelu", "eot_token_id": 49407}
VAE = {"in_channels": 3, "out_channels": 3, "z_channels": 4, "ch": 32, "ch_mult": [1, 1, 1, 1],
       "num_res_blocks": 1, "double_z": True, "scale_factor": 0.18215, "shift_factor": 0.0}

SD15 = {
    "family": "sd15",
    "unet": {"in_channels": 4, "out_channels": 4, "model_channels": 32, "num_res_blocks": 1,
             "attention_resolutions": [1, 2], "channel_mult": [1, 2], "num_heads": 2,
             "transformer_depth": 1, "context_dim": 32},
    "controlnet": {"hint_channels": 6},
    "vae": VAE,
    "clip": CLIP,
    "schedule": {"timesteps": 1000, "linear_start": 0.00085, "linear_end": 0.012},
}
SD3 = {
    "family": "sd3",
    "mmdit": {"sample_size": 8, "patch_size": 2, "in_channels": 16, "num_layers": 2,
              "attention_head_dim": 16, "num_attention_heads": 2, "joint_attention_dim": 128,
              "caption_projection_dim": 32, "pooled_projection_dim": 80, "out_channels": 16,
              "pos_embed_max_size": 8},
    "controlnet": {"num_layers": 2},
    "vae": dict(VAE, z_channels=16, scale_factor=1.5305, shift_factor=0.0609),
    "clip_l": CLIP,
    "clip_g": dict(CLIP, hidden_size=48, num_heads=3, intermediate_size=96, activation="gelu"),
    "t5": {"vocab_size": 32128, "d_model": 128, "d_kv": 16, "d_ff": 64, "num_layers": 2,
           "num_heads": 2, "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128, "layer_norm_eps": 1e-06},
}


def tiny_cell(name: str, steps: int = 4) -> spec.Cell:
    """The benchmark's cell `name` with a tiny configuration of its family
    and its traffic cut to 64² images, batch 2 and `steps` steps; its own
    limits."""
    bench = spec.benchmark()
    cell = spec.cell(bench, name)
    cfg = copy.deepcopy(SD15 if cell.config["family"] == "sd15" else SD3)
    traffic = dict(cell.traffic, batch=2, size=64, steps=steps, t5_len=16)
    return spec.Cell(name, cfg, traffic, cell.limits, cell.end_to_end, cell.per_layer)
