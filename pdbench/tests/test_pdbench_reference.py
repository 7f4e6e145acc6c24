"""The frozen reference against the port's plain path on the CPU at small
widths: the same parameter names and shapes (so the seed gives both the
same weights), and the same numbers in fp32."""


import pytest
import torch

from pdbench import spec, weights
from pdbench.families.common import materialize, reference
from pdbench.reference import sd3 as ref3
from pdbench.reference import sd15 as ref15
from pdbench.reference.common import rel_l2, set_mode
from pdbench.reference.text import CLIPText, T5Encoder
from pdbench.reference.vae import AutoencoderKL
from pdbench.tests.tiny import SD3, SD15

SEED = 3_123_456_789_012


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _port_models(cfg, policy):
    """{tag: (port module on meta, reference class, reference config)}."""
    from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL as PortVAE
    from prompt_diffusion_tpu_torch.models.vae import VAEConfig

    out = {}
    with torch.device("meta"):
        if cfg["family"] == "sd15":
            from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
            from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15

            u = UNetConfig(**_tuples(cfg["unet"]))
            d = dict(cfg["unet"], hint_channels=cfg["controlnet"]["hint_channels"])
            out["unet"] = (UNetSD15(u, policy), ref15.UNet, d)
            out["controlnet"] = (ControlNetSD15(u, d["hint_channels"], policy), ref15.ControlNet, d)
            out["clip"] = (CLIPTextModel(CLIPTextConfig(**cfg["clip"]), policy), CLIPText, cfg["clip"])
        else:
            from prompt_diffusion_tpu_torch.models.controlnet_sd3 import (
                SD3ControlNet,
                SupportPairDownProj,
            )
            from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
            from prompt_diffusion_tpu_torch.models.t5_text import T5Config
            from prompt_diffusion_tpu_torch.models.t5_text import T5Encoder as PortT5

            c = dict(cfg["mmdit"], num_layers=cfg["controlnet"]["num_layers"])
            out["transformer"] = (SD3Transformer(MMDiTConfig(**_tuples(cfg["mmdit"])), policy),
                                  ref3.MMDiT, cfg["mmdit"])
            out["controlnet"] = (SD3ControlNet(MMDiTConfig(**_tuples(c)), policy),
                                 ref3.ControlNet, c)
            out["down_proj"] = (SupportPairDownProj(policy), ref3.SupportPairDownProj, {})
            out["t5"] = (PortT5(T5Config(**cfg["t5"]), policy), T5Encoder, cfg["t5"])
            for tag in ("clip_l", "clip_g"):
                out[tag] = (CLIPTextModel(CLIPTextConfig(**cfg[tag]), policy), CLIPText, cfg[tag])
        out["vae"] = (PortVAE(VAEConfig(**_tuples(cfg["vae"])), policy), AutoencoderKL,
                      cfg["vae"])
    return out


def _full(name):
    return spec.cell(spec.benchmark(), name).config


@pytest.mark.parametrize("cfg", [SD15, SD3, _full("sd15.int8.b8"), _full("sd3.int8.b1")],
                         ids=["sd15-tiny", "sd3-tiny", "sd15", "sd3"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_same_parameter_names_and_shapes(cfg, int8):
    from prompt_diffusion_tpu_torch.utils.dtypes import default_policy, int8_policy

    for tag, (port, cls, rcfg) in _port_models(cfg, int8_policy() if int8
                                               else default_policy()).items():
        with torch.device("meta"):
            ref = cls(rcfg)
        assert weights.plan(port) == weights.plan(ref), tag


def test_weights_repeat_and_differ_by_seed():
    lin = lambda: torch.nn.Linear(300, 200)
    a, b, c = (materialize(lin().to("meta"), s, "x", "cpu") for s in (1, 1, 2))
    assert torch.equal(a.weight, b.weight) and not torch.equal(a.weight, c.weight)
    assert torch.equal(a.weight, a.weight.bfloat16().float())  # bf16 values
    assert torch.all(a.bias == 0)


def _inputs(tag, cfg, gen):
    """Call arguments of the port module and of the reference for `tag`."""
    r = lambda *s: torch.randn(*s, generator=gen)
    if cfg["family"] == "sd15" and tag in ("unet", "controlnet"):
        u = cfg["unet"]
        x, t, ctx = r(2, 4, 8, 8), torch.tensor([999, 500]), r(2, 77, u["context_dim"])
        hint = r(2, u["model_channels"], 8, 8)
        if tag == "controlnet":
            return (x, t), dict(context=ctx, guided_hint=hint), (x, t, ctx, hint)
        from pdbench.families.sd15 import _taps

        ctrl = [r(2, c, h, h) for c, h in _taps(dict(u, hint_channels=6), 8)]
        return (x, t, ctx), dict(control=ctrl), (x, t, ctx, ctrl)
    if tag in ("clip", "clip_l", "clip_g"):
        ids = torch.randint(0, 49407, (2, 77), generator=gen)
        ids[:, 40] = 49407
        return (ids,), {}, (ids,)
    if tag == "t5":
        ids = torch.randint(0, 32128, (2, 16), generator=gen)
        return (ids,), {}, (ids,)
    if tag == "down_proj":
        a, b = r(1, 3, 16, 16), r(1, 3, 16, 16)
        return (a, b), {}, (a, b)
    m = cfg["mmdit"]
    x, t = r(2, m["in_channels"], 8, 8), torch.tensor([700.0, 10.0])
    ctx, pooled = r(2, 93, m["joint_attention_dim"]), r(2, m["pooled_projection_dim"])
    if tag == "transformer":
        taps = [r(2, 16, m["num_attention_heads"] * m["attention_head_dim"])
                for _ in range(cfg["controlnet"]["num_layers"])]
        return ((x, t, ctx, pooled), dict(block_controlnet_hidden_states=taps),
                (x, t, ctx, pooled, taps))
    cond, pair = r(2, m["in_channels"], 8, 8), r(2, m["in_channels"], 8, 8)
    return (x, t, cond, pair, ctx, pooled), {}, (x, t, cond, pair, ctx, pooled)


def _first(tag, out):
    """The output compared: the ControlNets' taps stacked, CLIP's final
    states, the others' one tensor."""
    if tag == "controlnet":
        return torch.cat([o.float().flatten() for o in out])
    if isinstance(out, dict):
        return out["last_hidden_state"]
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("cfg", [SD15, SD3], ids=["sd15", "sd3"])
def test_reference_matches_the_port_in_fp32(cfg):
    from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy

    gen = torch.Generator().manual_seed(0)
    for tag, (port, cls, rcfg) in _port_models(cfg, fp32_policy()).items():
        port = materialize(port, SEED, tag, "cpu")
        ref = reference(cls, rcfg, SEED, tag, "cpu")
        with torch.no_grad():
            if tag == "vae":
                z = torch.randn(1, cfg["vae"]["z_channels"], 8, 8, generator=gen)
                got, want = port.decode(z).permute(0, 2, 3, 1), ref.decoder(
                    ref.post_quant_conv(z)).permute(0, 2, 3, 1)
                x = torch.rand(1, 3, 32, 32, generator=gen) * 2 - 1
                assert rel_l2(port.encode_moments(x), ref.quant_conv(ref.encoder(x))) < 1e-5
            else:
                args, kwargs, rargs = _inputs(tag, cfg, gen)
                got, want = _first(tag, port(*args, **kwargs)), _first(tag, ref(*rargs))
        assert rel_l2(got.float(), want) < 1e-5, tag


def _int8_pair(cfg, tag, seed):
    """(port under int8 with fp32 activations, the reference, the port's
    args, kwargs and the reference's args) for `tag`."""
    from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy

    port, cls, rcfg = _port_models(cfg, DTypePolicy(compute_dtype=torch.float32,
                                                    quant="int8"))[tag]
    args, kwargs, rargs = _inputs(tag, cfg, torch.Generator().manual_seed(seed))
    return materialize(port, SEED, tag, "cpu"), reference(cls, rcfg, SEED, tag, "cpu"), args, \
        kwargs, rargs


@pytest.mark.parametrize("cfg,tag", [(SD15, "controlnet"), (SD3, "transformer"),
                                     (SD3, "controlnet")],
                         ids=["sd15-controlnet", "sd3-transformer", "sd3-controlnet"])
def test_w8a8_reference_matches_the_port_int8_path(cfg, tag):
    """The reference's W8A8 arithmetic is the port's, site by site: with
    fp32 activations on both sides (so no code flips) the two agree to
    fp32 rounding, far inside what W8A8 moves the output from fp32."""
    from pdbench.reference.common import Mode

    port, ref, args, kwargs, rargs = _int8_pair(cfg, tag, 0)
    with torch.no_grad():
        got = _first(tag, port(*args, **kwargs)).float()
        want = _first(tag, set_mode(ref, Mode(site_bits=8))(*rargs))
    assert rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_w8a8_turns_rounding_into_its_own_noise(seed):
    """Why the bf16 program reads W8A8's whole noise against the W8A8
    reference in the SD1.5 UNet: rounding its inputs to bf16 moves the
    fp32 reference by under 0.2% but the W8A8 reference by about as far as
    W8A8 lies from fp32, since each rounding near a code's edge flips the
    code, and the flips feed the next site's."""
    from pdbench.reference.common import FLOAT, Mode

    _, ref, _, _, rargs = _int8_pair(SD15, "unet", seed)
    bf16 = [a.bfloat16().float() if a.is_floating_point() else a for a in rargs[:3]]
    rounded = (*bf16, rargs[3])
    with torch.no_grad():
        f32, f32_r = (set_mode(ref, FLOAT)(*a) for a in (rargs, rounded))
        w8, w8_r = (set_mode(ref, Mode(site_bits=8))(*a) for a in (rargs, rounded))
    assert rel_l2(f32_r, f32) < 2e-3
    assert rel_l2(w8_r, w8) > 0.5 * rel_l2(w8, f32) > 10 * rel_l2(f32_r, f32)
