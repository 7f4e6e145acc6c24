"""SD3 Prompt-Diffusion: the program's pipeline built from a configuration
file (T5-XXL resident, encoding inside each request), its request, the
capture of its timed path, the comparison with the plain reference, and
the work a request needs."""

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
from pdbench.reference import sd3 as ref3
from pdbench.reference.common import rel_l2, set_mode
from pdbench.reference.samplers import cfg as guide
from pdbench.reference.samplers import euler_update, flow_sigmas
from pdbench.reference.text import CLIPText, T5Encoder
from pdbench.reference.vae import AutoencoderKL

TAGS = ("transformer", "controlnet", "down_proj", "vae", "clip_l", "clip_g", "t5")
SAMPLER = "flow_match_euler"  # the pipeline's only sampler, the update `check` follows
_NCHW = (0, 3, 1, 2)


def t5_std(cfg: dict):
    """T5's published initialisation (HF `T5PreTrainedModel._init_weights`,
    factor 1): q at (d_model * d_kv)^-1/2, k and v at d_model^-1/2, o at
    (heads * d_kv)^-1/2, wi at d_model^-1/2, wo at d_ff^-1/2, the token
    table at 1 and the position bias at d_model^-1/2. With a flat 0.02
    every logit of T5's unscaled attention has a spread of ~13, the softmax
    picks one key, and rounding flips the pick: the encoder's output then
    moves by ~40% under bf16 alone."""
    d, kv, heads, ff = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["d_ff"]
    rules = {"attn.q.weight": (d * kv) ** -0.5, "attn.k.weight": d ** -0.5,
             "attn.v.weight": d ** -0.5, "attn.o.weight": (heads * kv) ** -0.5,
             "wi_0.weight": d ** -0.5, "wi_1.weight": d ** -0.5, "wo.weight": ff ** -0.5,
             "token_embedding.weight": 1.0, "relative_attention_bias": d ** -0.5}
    return lambda name: next((v for k, v in rules.items() if name.endswith(k)), None)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build(cfg: dict, traffic: dict, seed: int, device):
    """`PromptDiffusionSD3.create` over modules of the configuration's
    widths, the transformer and ControlNet under the traffic's policy, T5
    passed in, with the seed's weights."""
    from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from prompt_diffusion_tpu_torch.models.controlnet_sd3 import (
        SD3ControlNet,
        SupportPairDownProj,
    )
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
    from prompt_diffusion_tpu_torch.models.t5_text import T5Config
    from prompt_diffusion_tpu_torch.models.t5_text import T5Encoder as PortT5
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL as PortVAE
    from prompt_diffusion_tpu_torch.models.vae import VAEConfig
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
    from prompt_diffusion_tpu_torch.utils.dtypes import default_policy, int8_policy

    require_sampler(traffic, SAMPLER)
    policy = int8_policy() if traffic["policy"] == "int8" else default_policy()
    mcfg = MMDiTConfig(**_tuples(cfg["mmdit"]))
    ccfg = MMDiTConfig(**_tuples(dict(cfg["mmdit"], num_layers=cfg["controlnet"]["num_layers"])))
    with torch.device("meta"):
        models = dict(transformer=SD3Transformer(mcfg, policy),
                      controlnet=SD3ControlNet(ccfg, policy),
                      down_proj=SupportPairDownProj(),
                      vae=PortVAE(VAEConfig(**_tuples(cfg["vae"]))),
                      clip_l=CLIPTextModel(CLIPTextConfig(**cfg["clip_l"])),
                      clip_g=CLIPTextModel(CLIPTextConfig(**cfg["clip_g"])),
                      t5=PortT5(T5Config(**cfg["t5"])))
    models = {k: materialize(m, seed, k, device, t5_std(cfg["t5"]) if k == "t5" else None)
              for k, m in models.items()}
    return PromptDiffusionSD3.create(**models, device=device)


def generate(pipe, inputs: dict, traffic: dict, steps: int | None = None):
    return pipe.generate(**inputs, num_steps=steps or traffic["steps"],
                         guidance_scale=traffic["guidance"], shift=traffic["shift"])


def stages(pipe) -> list:
    return [(pipe.clip_l, "text_encode"), (pipe.clip_g, "text_encode"),
            (pipe.t5, "text_encode"), (pipe.down_proj, "vae_encode"),
            (pipe.vae.encoder, "vae_encode"), (pipe.vae.quant_conv, "vae_encode"),
            (pipe.controlnet, "denoise"), (pipe.transformer, "denoise"),
            (pipe.vae.post_quant_conv, "vae_decode"), (pipe.vae.decoder, "vae_decode")]


def stage_of(module_stage: str, kwargs: dict) -> str:
    return module_stage


def denoisers(pipe) -> list:
    return [pipe.controlnet, pipe.transformer]


def capture(pipe, batch: int, device) -> Capture:
    b = batch
    cap = Capture(batch, device)
    cap.on_denoiser(pipe.controlnet, 0, 1, output=False)
    cap.handles.append(pipe.transformer.register_forward_hook(
        lambda m, a, out: cap.out.append(cap.keep(out))))
    cap.take_first(pipe.controlnet, lambda a, k: {"cond": a[2][:b], "pair": a[3][:b],
                                                  "context": a[4], "pooled": a[5]})
    cap.take_first(pipe.vae.post_quant_conv, lambda a, k: {"z": a[0]})
    return cap


def _encode_text(cfg, seed, device, ids, low, control):
    """(joint sequence, pooled) of the reference, and of its control with
    `control`, for the (uncond || cond) ids."""
    joint = cfg["mmdit"]["joint_attention_dim"]
    ref_out, low_out = [], []
    for tag in ("clip_l", "clip_g"):
        m = reference(CLIPText, cfg[tag], seed, tag, device)
        key = tag[-1]
        ref_out.append(m(ids[key], hidden_layer=2))
        if control:
            low_out.append(set_mode(m, low)(ids[key], hidden_layer=2))
        del m
    t5 = reference(T5Encoder, cfg["t5"], seed, "t5", device, std=t5_std(cfg["t5"]))
    seq_ref = t5(ids["t5"])
    seq_low = set_mode(t5, low)(ids["t5"]) if control else None
    del t5

    def join(outs, t5_seq):
        (_, pool_l, hid_l), (_, pool_g, hid_g) = outs
        clip = torch.cat([hid_l, hid_g], dim=-1)
        clip = torch.nn.functional.pad(clip, (0, joint - clip.shape[-1]))
        return torch.cat([clip, t5_seq], dim=1), torch.cat([pool_l, pool_g], dim=-1)

    return join(ref_out, seq_ref), (join(low_out, seq_low) if control else None)


def check(cfg: dict, traffic: dict, seed: int, inputs: dict, cap: Capture, images,
          steps: list, device, control: bool = False) -> dict:
    """The readings of one request, as `sd15.check` takes them."""
    ref, low = modes(traffic["policy"], False), modes(traffic["policy"], True)
    b = traffic["batch"]
    nchw = lambda t: t.permute(_NCHW).contiguous()
    out = {}

    ids = {k: torch.cat([inputs["neg_prompt_ids"][k], inputs["prompt_ids"][k]])
           for k in ("l", "g", "t5")}
    (ctx, pooled), lowtext = _encode_text(cfg, seed, device, ids, low["text"], control)
    test_ctx, test_pooled = lowtext if control else (cap.first["context"], cap.first["pooled"])
    out["text"] = max(rel_l2(test_ctx, ctx), rel_l2(test_pooled, pooled))

    down = reference(ref3.SupportPairDownProj, {}, seed, "down_proj", device)
    vae = reference(AutoencoderKL, cfg["vae"], seed, "vae", device)

    def encodes(mode):
        set_mode(down, mode), set_mode(vae, mode)
        pair = vae.encode(down(nchw(inputs["support_cond"]), nchw(inputs["support_image"])),
                          inputs["pair_noise"])
        return vae.encode(nchw(inputs["control_image"]), inputs["cond_noise"]), pair

    cond, pair = encodes(ref["hint"])
    test_cond, test_pair = encodes(low["hint"]) if control else (cap.first["cond"],
                                                                 cap.first["pair"])
    out["hint"] = max(rel_l2(test_cond, cond), rel_l2(test_pair, pair))
    set_mode(vae, ref["decode"])

    ccfg = dict(cfg["mmdit"], num_layers=cfg["controlnet"]["num_layers"])
    cn = reference(ref3.ControlNet, ccfg, seed, "controlnet", device)
    mmdit = reference(ref3.MMDiT, cfg["mmdit"], seed, "transformer", device)

    def velocity_pair(x, t, c, p, cd, pr, mode):
        set_mode(cn, mode), set_mode(mmdit, mode)
        x2, t2 = torch.cat([x, x]), t.float().repeat(2 * b)
        cd2, pr2 = torch.cat([cd, cd]), torch.cat([pr, pr])
        return mmdit(x2, t2, c, p, cn(x2, t2, cd2, pr2, c, p))

    gaps, guided = [], []
    for s in steps:
        x, t = cap.x[s], cap.t[s]
        want = velocity_pair(x, t, ctx, pooled, cond, pair, ref["denoise"])
        got = (velocity_pair(x, t, test_ctx, test_pooled, test_cond, test_pair, low["denoise"])
               if control else cap.out[s])
        gaps.append(rel_l2(got, want))
        guided.append(guidance_readings(got, want))
    out["denoise"] = max(gaps)
    out.update({k: max(g[k] for g in guided) for k in guided[0]})
    del cn, mmdit

    n = traffic["steps"]
    timesteps, sigmas = flow_sigmas(n, traffic["shift"])
    finals = cap.x[1:] + [(cap.first["z"] - cfg["vae"]["shift_factor"])
                          * cfg["vae"]["scale_factor"]]
    gaps = [float("inf")] if len(cap.x) != n else []
    for i in range(min(n, len(cap.x))):
        if float(cap.t[i].item()) != float(torch.tensor(timesteps[i], dtype=torch.float32)):
            gaps.append(float("inf"))
            continue
        v = guide(cap.out[i], traffic["guidance"])
        want = euler_update(cap.x[i], v, sigmas[i], sigmas[i + 1])
        got = (euler_update(cap.x[i], v, sigmas[i], sigmas[i + 1], round_bf16=True) if control
               else finals[i])
        gaps.append(rel_l2(got - cap.x[i], want - cap.x[i]))
    out["step"] = max(gaps)

    z = cap.first["z"]
    img = vae.decode(z)
    test_img = set_mode(vae, low["decode"]).decode(z) if control else images.to(device)
    out["decode"] = rel_l2(test_img, img)
    return out


def work(cfg: dict, traffic: dict) -> dict:
    """{"int8_ops", "bf16_ops"} one request needs at the configuration's
    shapes: the three text encoders over the prompt and the negative, the
    support pair's down projection and the two VAE encodes once per image,
    ControlNet + MMDiT on the CFG batch at every step, the VAE decode once
    per image."""
    from pdbench.counts.work import count

    b, size, steps = traffic["batch"], traffic["size"], traffic["steps"]
    h, z = size // 8, cfg["vae"]["z_channels"]
    meta = lambda *s: torch.empty(*s, device="meta")
    ids = lambda n: torch.zeros(2 * b, n, dtype=torch.long, device="meta")
    int8 = traffic["policy"] == "int8"
    total = {"int8_ops": 0.0, "bf16_ops": 0.0}

    def add(parts, times=1):
        for k in total:
            total[k] += parts[k] * times

    for tag in ("clip_l", "clip_g"):
        add(count(CLIPText, cfg[tag], False, lambda m: m(ids(77), hidden_layer=2)))
    add(count(T5Encoder, cfg["t5"], False, lambda m: m(ids(traffic["t5_len"]))))
    add(count(ref3.SupportPairDownProj, {}, False,
              lambda m: m(meta(b, 3, size, size), meta(b, 3, size, size))))
    add(count(AutoencoderKL, cfg["vae"], False,
              lambda m: m.encode(meta(b, 3, size, size), meta(b, z, h, h))), 2)
    mc = cfg["mmdit"]
    ccfg = dict(mc, num_layers=cfg["controlnet"]["num_layers"])
    n_ctx = 77 + traffic["t5_len"]
    x2, t2 = meta(2 * b, mc["in_channels"], h, h), meta(2 * b)
    ctx, pooled = meta(2 * b, n_ctx, mc["joint_attention_dim"]), meta(2 * b, mc["pooled_projection_dim"])
    lat = meta(2 * b, z, h, h)
    add(count(ref3.ControlNet, ccfg, int8, lambda m: m(x2, t2, lat, lat, ctx, pooled)), steps)
    taps = [meta(2 * b, (h // mc["patch_size"]) ** 2, ref3.hidden_size(mc))] * ccfg["num_layers"]
    add(count(ref3.MMDiT, mc, int8, lambda m: m(x2, t2, ctx, pooled, taps)), steps)
    add(count(AutoencoderKL, cfg["vae"], False, lambda m: m.decode(meta(b, z, h, h))))
    return total
