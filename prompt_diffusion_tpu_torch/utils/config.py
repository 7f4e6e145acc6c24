"""Config system: a reference-format YAML → the port's SD1.5 pipeline.

Counterpart of `prompt_diffusion_tpu/utils/config.py`: `create_model(path)`
reads a reference model YAML (e.g. models/cldm_v15.yaml: `ControlLDM` with
its `unet_config`, `control_stage_config` and `first_stage_config`) and
builds `PromptDiffusionSD15` with the same configurations and noise
schedule, on the card unless the caller asks for the CPU. The YAML reader
is a copy of the JAX package's: pyyaml when it is installed, else a small
indentation-based parser of the subset the reference configs use (nested
maps, lists, scalars). The card's machine has no pyyaml, so there the
fallback parser is what runs. One repair: the JAX fallback drops a block
list written at its key's own indent, as models/cldm_v15.yaml writes the
VAE's `ch_mult` (an empty `ch_mult` builds a VAE with no levels); the
port's keeps it, as pyyaml does.
"""

from __future__ import annotations

from typing import Any


def _minimal_yaml(text: str):
    """Parse the subset of YAML the reference configs use (nested maps,
    lists, scalars) without an external dependency."""
    try:
        import yaml  # pyyaml ships with many images

        return yaml.safe_load(text)
    except ImportError:
        pass
    # fallback: indentation-based parser for map/list/scalars
    root: dict = {}
    stack = [(-1, root)]
    lines = [l for l in text.splitlines() if l.strip() and not l.strip().startswith("#")]
    i = 0
    while i < len(lines):
        raw = lines[i]
        indent = len(raw) - len(raw.lstrip())
        line = raw.strip()
        # a "- " item at its key's own indent (the reference YAMLs' style,
        # `ch_mult:` then `- 1` below it) belongs to that key's list; the
        # JAX package's parser pops the list there and drops the items
        while stack and (indent < stack[-1][0] or (indent == stack[-1][0] and not (
                line.startswith("- ") and isinstance(stack[-1][1], list)))):
            stack.pop()
        parent = stack[-1][1]
        if line.startswith("- "):
            val = _scalar(line[2:])
            if isinstance(parent, list):
                parent.append(val)
            i += 1
            continue
        key, _, rest = line.partition(":")
        key = key.strip()
        rest = rest.strip()
        if rest:
            parent[key] = _scalar(rest)
        else:
            # look ahead: list or map
            child: Any
            if i + 1 < len(lines) and lines[i + 1].strip().startswith("- "):
                child = []
            else:
                child = {}
            parent[key] = child
            stack.append((indent, child))
        i += 1
    return root


def _scalar(s: str):
    s = s.split(" #")[0].strip().strip('"').strip("'")
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    return s


def load_yaml(path: str):
    with open(path) as f:
        return _minimal_yaml(f.read())


def create_model(config_path: str, policy=None, device="cuda"):
    """Reference-format model YAML → PromptDiffusionSD15 on `device`
    (cldm/model.py:24-28 `create_model` equivalent). `policy` (default
    bf16) applies to all four models, as in the JAX package's
    `create_model`; the weights are the models' initial values: load a
    checkpoint or a JAX tree, or fill them with `random_init_`."""
    import torch

    from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextModel
    from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
    from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.schedulers.schedules import DiffusionSchedule
    from prompt_diffusion_tpu_torch.utils.dtypes import default_policy

    policy = policy or default_policy()
    cfg = load_yaml(config_path)
    m = cfg["model"]["params"]

    def unet_cfg(section) -> UNetConfig:
        p = section["params"]
        return UNetConfig(
            in_channels=p.get("in_channels", 4),
            out_channels=p.get("out_channels", p.get("in_channels", 4)),
            model_channels=p.get("model_channels", 320),
            num_res_blocks=p.get("num_res_blocks", 2),
            attention_resolutions=tuple(p.get("attention_resolutions", (4, 2, 1))),
            channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
            num_heads=p.get("num_heads", 8),
            transformer_depth=p.get("transformer_depth", 1),
            context_dim=p.get("context_dim", 768),
            use_checkpoint=bool(p.get("use_checkpoint", False)),
        )

    dd = m["first_stage_config"]["params"]["ddconfig"]
    vae_cfg = VAEConfig(
        in_channels=dd.get("in_channels", 3),
        out_channels=dd.get("out_ch", 3),
        z_channels=dd.get("z_channels", 4),
        ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        double_z=bool(dd.get("double_z", True)),
        scale_factor=m.get("scale_factor", 0.18215),
    )
    schedule = DiffusionSchedule.create(
        schedule="linear",
        timesteps=m.get("timesteps", 1000),
        linear_start=m.get("linear_start", 0.00085),
        linear_end=m.get("linear_end", 0.0120),
    )
    control_params = m["control_stage_config"]["params"]
    with torch.device(device):
        models = dict(
            unet=UNetSD15(unet_cfg(m["unet_config"]), policy),
            controlnet=ControlNetSD15(unet_cfg(m["control_stage_config"]),
                                      control_params.get("hint_channels", 6), policy),
            vae=AutoencoderKL(vae_cfg, policy),
            text_encoder=CLIPTextModel(policy=policy),
        )
    return PromptDiffusionSD15.create(**models, schedule=schedule, device=device)
