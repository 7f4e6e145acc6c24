"""SD1.5 Prompt-Diffusion: the program's pipeline built from a configuration
file, its request, the capture of its timed path, the comparison with the
plain reference, and the work a request needs."""

from __future__ import annotations

import torch

from pdbench.families.common import (
    Capture,
    guidance_readings,
    materialize,
    modes,
    reference,
    require_sampler,
)
from pdbench.reference import sd15 as ref15
from pdbench.reference.common import rel_l2, set_mode
from pdbench.reference.samplers import cfg as guide
from pdbench.reference.samplers import ddim_table, ddim_update
from pdbench.reference.text import CLIPText
from pdbench.reference.vae import AutoencoderKL

TAGS = ("unet", "controlnet", "vae", "clip")
SAMPLER = "ddim"  # the update `check` follows (eta 0); other traffic is refused
_NCHW = (0, 3, 1, 2)


def build(cfg: dict, traffic: dict, seed: int, device):
    """`PromptDiffusionSD15.create` over modules of the configuration's
    widths under the traffic's policy, with the seed's weights."""
    from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
    from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL as PortVAE
    from prompt_diffusion_tpu_torch.models.vae import VAEConfig
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.schedulers.schedules import DiffusionSchedule
    from prompt_diffusion_tpu_torch.utils.dtypes import default_policy, int8_policy

    require_sampler(traffic, SAMPLER)
    policy = int8_policy() if traffic["policy"] == "int8" else default_policy()
    u = dict(cfg["unet"])
    ucfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in u.items()})
    vcfg = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["vae"].items()})
    with torch.device("meta"):
        models = dict(unet=UNetSD15(ucfg, policy),
                      controlnet=ControlNetSD15(ucfg, cfg["controlnet"]["hint_channels"], policy),
                      vae=PortVAE(vcfg), text_encoder=CLIPTextModel(CLIPTextConfig(**cfg["clip"])))
    tag = {"unet": "unet", "controlnet": "controlnet", "vae": "vae", "text_encoder": "clip"}
    models = {k: materialize(m, seed, tag[k], device) for k, m in models.items()}
    s = cfg["schedule"]
    return PromptDiffusionSD15.create(
        **models, device=device,
        schedule=DiffusionSchedule.create(timesteps=s["timesteps"], linear_start=s["linear_start"],
                                          linear_end=s["linear_end"]))


def generate(pipe, inputs: dict, traffic: dict, steps: int | None = None):
    return pipe.generate(**inputs, num_steps=steps or traffic["steps"],
                         guidance_scale=traffic["guidance"], sampler=traffic["sampler"],
                         eta=traffic.get("eta", 0.0))


def stages(pipe) -> list:
    """(module, stage) pairs whose calls the coarse trace marks; a
    ControlNet call with `hint_only` is the hint encode."""
    return [(pipe.text_encoder, "text_encode"), (pipe.controlnet, "denoise"),
            (pipe.unet, "denoise"), (pipe.vae.post_quant_conv, "vae_decode"),
            (pipe.vae.decoder, "vae_decode")]


def stage_of(module_stage: str, kwargs: dict) -> str:
    return "hint_encode" if kwargs.get("hint_only") else module_stage


def denoisers(pipe) -> list:
    return [pipe.controlnet, pipe.unet]


def capture(pipe, batch: int, device) -> Capture:
    cap = Capture(batch, device)
    cap.on_denoiser(pipe.unet, 0, 1)
    cap.take_first(pipe.unet, lambda a, k: {"context": a[2]})
    cap.take_first(pipe.controlnet, lambda a, k, out: {"hint": out},
                   when=lambda a, k: k.get("hint_only", False), output=True)
    cap.take_first(pipe.vae.post_quant_conv, lambda a, k: {"z": a[0]})
    return cap


def check(cfg: dict, traffic: dict, seed: int, inputs: dict, cap: Capture, images,
          steps: list, device, control: bool = False) -> dict:
    """The readings of one request: each a relative L2 gap of the tested
    side (the program's captured outputs, or with `control` the reference
    one precision lower at the same states) from the reference."""
    ref, low = modes(traffic["policy"], False), modes(traffic["policy"], True)
    b = traffic["batch"]
    nchw = lambda t: t.permute(_NCHW).contiguous()
    out = {}

    clip = reference(CLIPText, cfg["clip"], seed, "clip", device, ref["text"])
    ids2 = torch.cat([inputs["neg_token_ids"], inputs["token_ids"]])
    ctx = clip(ids2)[0]
    test_ctx = set_mode(clip, low["text"])(ids2)[0] if control else cap.first["context"]
    out["text"] = rel_l2(test_ctx, ctx)
    del clip

    dcfg = dict(cfg["unet"], hint_channels=cfg["controlnet"]["hint_channels"])
    cn = reference(ref15.ControlNet, dcfg, seed, "controlnet", device, ref["hint"])
    unet = reference(ref15.UNet, dcfg, seed, "unet", device, ref["denoise"])
    pair2 = nchw(torch.cat([inputs["example_pair"]] * 2))
    query2 = nchw(torch.cat([inputs["query"]] * 2))
    hint = cn.hint(pair2, query2)
    test_hint = set_mode(cn, low["hint"]).hint(pair2, query2) if control else cap.first["hint"]
    out["hint"] = rel_l2(test_hint, hint)

    def eps_pair(x, t, c, h, mode):
        set_mode(cn, mode), set_mode(unet, mode)
        x2, t2 = torch.cat([x, x]), t.repeat(2 * b)
        return unet(x2, t2, c, cn(x2, t2, c, h))

    gaps, guided = [], []
    for s in steps:
        x, t = cap.x[s], cap.t[s]
        want = eps_pair(x, t, ctx, hint, ref["denoise"])
        got = eps_pair(x, t, test_ctx, test_hint, low["denoise"]) if control else cap.out[s]
        gaps.append(rel_l2(got, want))
        guided.append(guidance_readings(got, want))
    out["denoise"] = max(gaps)
    out.update({k: max(g[k] for g in guided) for k in guided[0]})
    del cn, unet

    vae = reference(AutoencoderKL, cfg["vae"], seed, "vae", device, ref["decode"])
    ts, alphas, prev = ddim_table(traffic["steps"], cfg["schedule"]["timesteps"],
                                  cfg["schedule"]["linear_start"], cfg["schedule"]["linear_end"])
    n = len(ts)
    finals = cap.x[1:] + [(cap.first["z"] - cfg["vae"]["shift_factor"])
                          * cfg["vae"]["scale_factor"]]
    gaps = [float("inf")] if len(cap.x) != n else []
    for i in range(min(n, len(cap.x))):
        idx = n - 1 - i
        if int(cap.t[i].item()) != int(ts[idx]):
            gaps.append(float("inf"))
            continue
        eps = guide(cap.out[i], traffic["guidance"])
        want = ddim_update(cap.x[i], eps, alphas[idx], prev[idx])
        got = (ddim_update(cap.x[i], eps, alphas[idx], prev[idx], round_bf16=True) if control
               else finals[i])
        gaps.append(rel_l2(got - cap.x[i], want - cap.x[i]))
    out["step"] = max(gaps)

    z = cap.first["z"]
    img = vae.decode(z)
    test_img = set_mode(vae, low["decode"]).decode(z) if control else images.to(device)
    out["decode"] = rel_l2(test_img, img)
    return out


def work(cfg: dict, traffic: dict) -> dict:
    """{"int8_ops", "bf16_ops"} one request needs, counted on the
    reference at the configuration's shapes (meta tensors): CLIP over the
    prompt and the negative, the hint encoders once per image, ControlNet +
    UNet on the CFG batch at every step, the VAE decode once per image."""
    from pdbench.counts.work import count

    b, size, steps = traffic["batch"], traffic["size"], traffic["steps"]
    h = size // 8
    dcfg = dict(cfg["unet"], hint_channels=cfg["controlnet"]["hint_channels"])
    int8 = traffic["policy"] == "int8"
    total = {"int8_ops": 0.0, "bf16_ops": 0.0}

    def add(parts, times=1):
        for k in total:
            total[k] += parts[k] * times

    ctx = torch.empty(2 * b, 77, cfg["unet"]["context_dim"], device="meta")
    add(count(CLIPText, cfg["clip"], False,
              lambda m: m(torch.zeros(2 * b, 77, dtype=torch.long, device="meta"))))
    add(count(ref15.ControlNet, dcfg, False, lambda m: m.hint(
        torch.empty(b, dcfg["hint_channels"], size, size, device="meta"),
        torch.empty(b, 3, size, size, device="meta"))))
    x2 = torch.empty(2 * b, cfg["unet"]["in_channels"], h, h, device="meta")
    t2 = torch.zeros(2 * b, device="meta")
    hint = torch.empty(2 * b, dcfg["model_channels"], h, h, device="meta")
    for cls in (ref15.ControlNet, ref15.UNet):
        def fwd(m, cls=cls):
            if cls is ref15.ControlNet:
                return m(x2, t2, ctx, hint)
            ctrl = [torch.empty(2 * b, c, hh, hh, device="meta") for c, hh in _taps(dcfg, h)]
            return m(x2, t2, ctx, ctrl)
        add(count(cls, dcfg, int8, fwd), steps)
    add(count(AutoencoderKL, cfg["vae"], False, lambda m: m.decode(
        torch.empty(b, cfg["vae"]["z_channels"], h, h, device="meta"))))
    return total


def _taps(dcfg: dict, h: int) -> list:
    """(channels, side) of the ControlNet's 13 residuals, in its order."""
    plan, chans, mid, ds = ref15.encoder_plan(dcfg)
    sides, side = [], h
    for kind, _, _ in plan:
        if kind == "down":
            side //= 2
        sides.append(side)
    return list(zip(chans, sides)) + [(mid, side)]
