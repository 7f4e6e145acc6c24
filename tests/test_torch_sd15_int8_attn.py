"""PyTorch port, SD1.5's two int8 serving options against the JAX package on
the CPU: `int8_attention` (the JAX package's `PD_SD15_INT8_ATTN`: the
kernel-eligible self-attention through K9, int8 Q.K^T) and
`fused_geglu=False` (`PD_SD15_FUSED_GEGLU=0`: the GEGLU in the compute dtype,
then `out`'s per-tensor quantization, no K7). Plain K9 and K9p's plain
version at SD1.5's head widths (D = 40 and 80) against the TPU kernel in
interpret mode and JAX's quantization; `CrossAttention` and
`GEGLUFeedForward` with each option against their Flax modules through the
weight bridge; a tiny int8 pipeline (32² latents, so the eligibility rule
holds at the top level) under each option against JAX `jit_generate` with
injected noise; `create`'s refusals and the options' plumbing through the
loaders and the entries.

The JAX switches are module attributes read at call time, set here by
`monkeypatch` (no JAX file changes): `layers._SD15_INT8_ATTN`,
`layers._SD15_FUSED_GEGLU`, `ops.attention._flash_eligible` (the port's
rule: on a CPU backend JAX's own sends nothing to a kernel) and
`ops.flash_attention.flash_attention_packed_int8` (the TPU kernel in
interpret mode: on a CPU backend the public wrapper takes the bf16 kernel).
Inputs come from numpy seeds; each test states its bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import layers as jl
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.ops import attention as jattention
from prompt_diffusion_tpu.ops import flash_attention as jflash
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.utils.dtypes import DTypePolicy as JPolicy
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch import serve
from prompt_diffusion_tpu_torch.models import layers as pl
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.ops import flash_attention as fa
from prompt_diffusion_tpu_torch.ops.attention import _flash_eligible
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools import profile_sd15
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, fp32_policy, int8_policy
from tests.torch_port_util import (
    TINY_CLIP,
    TINY_UNET,
    TINY_VAE,
    jax_int8_attention,
    randomize,
)

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
J_INT8_F32 = JPolicy(compute_dtype=jnp.float32, quant="int8")
INT8_F32 = DTypePolicy(compute_dtype=torch.float32, quant="int8")
F32 = DTypePolicy(compute_dtype=torch.float32)
# a module with an option against its Flax module with the switch: the two
# compute the same int8 function and differ by fp32 rounding, which can
# move a value across a code's rounding boundary (one code a step off, as
# the kernels' bound allows: 1.4e-4 at 8 heads of 40); the bound holds a
# few such codes
MODULE_REL = 1e-3
# the option must move the output well above that: its own effect in JAX
# (0.011-0.036 in these tests)
OPTION_REL = 5e-3


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_switches(mp, int8_attention=False, fused_geglu=True):
    """JAX's SD1.5 switches as its environment would set them, and the two
    CPU stand-ins of the chip's routing (the module docstring)."""
    mp.setattr(jl, "_SD15_INT8_ATTN", int8_attention)
    mp.setattr(jl, "_SD15_FUSED_GEGLU", fused_geglu)
    mp.setattr(jattention, "_flash_eligible", _flash_eligible)
    mp.setattr(jflash, "flash_attention_packed_int8", jax_int8_attention)


# ---- K9 and K9p at SD1.5's head widths ------------------------------------


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d,nq,nk", [(40, 200, 200), (40, 77, 260), (80, 150, 150),
                                     (80, 130, 300)])
def test_plain_k9_matches_the_tpu_kernel_at_sd15_heads(d, nq, nk, dtype, atol):
    """Plain K9 (`_torch_int8_attention`, what a CPU tensor takes) at D = 40
    and 80 against `_fa_packed_fullk_int8_kernel` in interpret mode: fp32
    within 1e-5, bf16 within 2e-2 (one bf16 step of P and of the output)."""
    rng = np.random.default_rng(d + nq + nk)
    heads = 2
    q, k, v = (_normal(rng, (2, n, heads * d)) for n in (nq, nk, nk))
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    scale = d ** -0.5
    ref = jax_int8_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), heads, scale)
    got = fa.flash_attention_packed_int8(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                         heads)
    assert got.dtype == tdt and got.shape == (2, nq, heads * d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=atol)


def _jax_quant_k_per_head(k, num_heads):
    """JAX's host-side K quantization (`flash_attention.py:391-394`)."""
    b, n, hd = k.shape
    kf = k.astype(jnp.float32).reshape(b, n, num_heads, hd // num_heads)
    skh = jnp.maximum(jnp.max(jnp.abs(kf), axis=(1, 3)) / 127.0, 1e-8)
    ki = jnp.clip(jnp.round(kf / skh[:, None, :, None]), -127, 127).astype(jnp.int8)
    return ki.reshape(b, n, hd), skh


@pytest.mark.parametrize("case", ["64² bf16", "32² bf16", "ties D=40", "zero head D=80"])
def test_quant_k_per_head_at_sd15_heads_bit_equals_jax(case):
    """K9p's plain version `_quant_k_per_head` at SD1.5's heads (8 of 40 at
    64², 8 of 80 at 32², K of the CFG batch's shape cut in length),
    bit-equal in codes and scales to JAX's quantization: bf16 inputs,
    values on .5 code ties (each head's amax 127, so skh = 1), an all-zero
    head (the 1e-8 clamp)."""
    rng = np.random.default_rng(17)
    d = 40 if "D=40" in case or "64²" in case else 80
    b, n, heads = 2, 300, 8
    k = _normal(rng, (b, n, heads * d), 2.0)
    if case == "ties D=40":
        k = (rng.integers(-60, 60, size=k.shape) + 0.5).astype(np.float32)
        k[:, 5, ::d] = 127.0
    if case == "zero head D=80":
        k[1, :, 3 * d:4 * d] = 0.0
    dtype = torch.bfloat16 if "bf16" in case else torch.float32
    kt = torch.from_numpy(k).to(dtype)
    codes, scales = fa._quant_k_per_head(kt, heads)
    jcodes, jscales = _jax_quant_k_per_head(jnp.asarray(kt.float().numpy()), heads)
    assert torch.equal(codes, torch.from_numpy(np.asarray(jcodes)))
    assert torch.equal(scales, torch.from_numpy(np.asarray(jscales)))


# ---- the modules with each option ------------------------------------------


def _port_module(module, params):
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module.eval()


@pytest.mark.parametrize("heads,dim_head", [(8, 40), (4, 8)])
def test_cross_attention_int8_attention_matches_jax(heads, dim_head, monkeypatch):
    """`CrossAttention` under the int8 policy (fp32 compute) on 1024 tokens,
    where the self-attention takes a kernel: with `int8_attention` within
    MODULE_REL relative L2 of the Flax module with `PD_SD15_INT8_ATTN`, and
    without it of the module without; the switch moves JAX's output by
    more than OPTION_REL. Under a non-int8 policy the option changes
    nothing."""
    rng = np.random.default_rng(heads)
    width = 32
    x = _normal(rng, (2, 1024, width))
    jm = jl.CrossAttention(heads=heads, dim_head=dim_head, policy=J_INT8_F32)
    params = randomize(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), 50 + heads)
    port = _port_module(pl.CrossAttention(width, width, heads, dim_head, INT8_F32), params)
    ref, got = {}, {}
    for option in (False, True):
        _jax_switches(monkeypatch, int8_attention=option)
        ref[option] = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
        port.int8_attention = option
        with torch.no_grad():
            got[option] = port(torch.from_numpy(x)).numpy()
        assert _rel(got[option], ref[option]) <= MODULE_REL, option
    assert _rel(ref[True], ref[False]) > OPTION_REL
    plain = _port_module(pl.CrossAttention(width, width, heads, dim_head, F32), params)
    with torch.no_grad():
        before = plain(torch.from_numpy(x))
        plain.int8_attention = True
        assert torch.equal(plain(torch.from_numpy(x)), before)


def test_geglu_unfused_matches_jax(monkeypatch):
    """`GEGLUFeedForward` under the int8 policy (fp32 compute): with
    `fused_geglu` cleared within MODULE_REL relative L2 of the Flax module
    with `PD_SD15_FUSED_GEGLU=0` (the GEGLU in fp32, `out`'s per-tensor
    quantization), with it of the fused module (K7's per-row codes); the
    switch moves JAX's output by more than OPTION_REL; without the fusion
    no K7 call is made."""
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 64, 32))
    jm = jl.GEGLUFeedForward(policy=J_INT8_F32)
    params = randomize(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), 60)
    port = _port_module(pl.GEGLUFeedForward(32, INT8_F32), params)
    calls = []
    real = pl.fused_geglu_quant
    monkeypatch.setattr(pl, "fused_geglu_quant", lambda p: calls.append(p.shape) or real(p))
    ref, got = {}, {}
    for fused in (True, False):
        _jax_switches(monkeypatch, fused_geglu=fused)
        ref[fused] = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
        port.fused_geglu = fused
        with torch.no_grad():
            got[fused] = port(torch.from_numpy(x)).numpy()
        assert _rel(got[fused], ref[fused]) <= MODULE_REL, fused
        assert len(calls) == 1  # the fused call only
    assert _rel(ref[True], ref[False]) > OPTION_REL


# ---- a tiny int8 pipeline under each option ------------------------------------

B, IMG, STEPS = 2, 256, 2  # 32² latents: the top level's 1024 tokens take a kernel


def _jpipe(jpol):
    ucfg = junet.UNetConfig(**TINY_UNET)
    return JPipe(
        unet=junet.UNetSD15(config=ucfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=j_fp32_policy()),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP),
                                         policy=j_fp32_policy()),
        schedule=JSchedule.create())


def _jgenerate(jpipe, params, r):
    return np.asarray(jpipe.jit_generate()(
        params, KEY, jnp.asarray(r["ids"]), jnp.asarray(r["neg"]), jnp.asarray(r["pair"]),
        jnp.asarray(r["query"]), num_steps=STEPS, guidance_scale=9.0,
        init_noise=jnp.asarray(r["noise"])))


@pytest.fixture(scope="module")
def pipeline_case():
    """The JAX tree, one request with injected x_T, and JAX's fp32 images
    (the same CPU stand-ins of the chip's routing)."""
    shapes = jax.eval_shape(lambda r: _jpipe(j_fp32_policy()).init_params(r, image_size=IMG),
                            KEY)
    params = randomize(shapes, 40)
    rng = np.random.default_rng(41)
    r = dict(ids=rng.integers(0, 100, (B, 77)).astype(np.int32), neg=np.zeros((B, 77), np.int32),
             pair=rng.uniform(-1, 1, (B, IMG, IMG, 6)).astype(np.float32),
             query=rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
             noise=rng.normal(size=(B, IMG // 8, IMG // 8, 4)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        _jax_switches(mp)
        ref32 = _jgenerate(_jpipe(j_fp32_policy()), params, r)
    return params, r, ref32


def _port_pipe(**options):
    return PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET), INT8_F32),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, INT8_F32),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), F32),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP), F32), device="cpu", **options)


def _count_calls(monkeypatch, *names):
    """Counts the calls of the port's layers' kernel wrappers `names`."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(pl, name)

        def counted(*args, _name=name, _real=real, **kwargs):
            counts[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(pl, name, counted)
    return counts


@pytest.mark.parametrize("option", ["int8_attention", "unfused_geglu"])
def test_int8_pipeline_option_matches_jax(pipeline_case, option, monkeypatch):
    """Tiny int8 `generate` (fp32 compute, batch 2 at 256², 2 DDIM steps, CFG
    9, injected x_T) with the option against JAX's with the switch: an
    int8 evaluation at JAX's noise level (tests/test_torch_int8.py's
    whole-network rule: as far from JAX fp32 as JAX int8 is, ratio in
    [0.5, 1.5], and within 1.5 times that of JAX int8). The port's calls
    prove the option ran: with `int8_attention` K9 at each eligible
    self-attention (3 in the UNet, 1 in the ControlNet, per CFG
    evaluation) and no K1; without the fusion no K7."""
    params, r, ref32 = pipeline_case
    options = ({"int8_attention": True} if option == "int8_attention"
               else {"fused_geglu": False})
    _jax_switches(monkeypatch, **options)
    ref8 = _jgenerate(_jpipe(J_INT8_F32), params, r)
    pipe = _port_pipe(**options)
    load_jax_params(pipe, params)
    counts = _count_calls(monkeypatch, "flash_attention_packed_int8", "flash_attention_packed",
                          "fused_geglu_quant")
    got = pipe.generate(torch.from_numpy(r["ids"]), torch.from_numpy(r["neg"]),
                        torch.from_numpy(r["pair"]), torch.from_numpy(r["query"]),
                        num_steps=STEPS, guidance_scale=9.0,
                        init_noise=torch.from_numpy(r["noise"])).numpy()
    assert got.shape == (B, IMG, IMG, 3) and np.isfinite(got).all()
    want = ({"flash_attention_packed_int8": 4 * STEPS, "flash_attention_packed": 0,
             "fused_geglu_quant": 6 * STEPS} if option == "int8_attention" else
            {"flash_attention_packed_int8": 0, "flash_attention_packed": 4 * STEPS,
             "fused_geglu_quant": 0})
    assert counts == want
    quant_err = _rel(ref8, ref32)
    ratio32, ratio8 = _rel(got, ref32) / quant_err, _rel(got, ref8) / quant_err
    assert quant_err > 1e-3, quant_err
    assert 0.5 <= ratio32 <= 1.5 and ratio8 <= 1.5, (quant_err, ratio32, ratio8)


# ---- create, the loaders and the entries -----------------------------------------


def _tiny(policy, device="cpu"):
    with torch.device(device):
        return dict(unet=UNetSD15(UNetConfig(**TINY_UNET), policy),
                    controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, policy),
                    vae=AutoencoderKL(VAEConfig(**TINY_VAE), F32),
                    text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP), F32))


def _options(pipe):
    """{(int8_attention, fused_geglu)} over the UNet's and ControlNet's
    modules, and the VAE's attention modules' (none of the options)."""
    seen = set()
    for m in (pipe.unet, pipe.controlnet):
        for mod in m.modules():
            if isinstance(mod, pl.CrossAttention):
                seen.add(("attn", mod.int8_attention))
            elif isinstance(mod, pl.GEGLUFeedForward):
                seen.add(("geglu", mod.fused_geglu))
    return seen


@pytest.mark.parametrize("options", [{"int8_attention": True}, {"fused_geglu": False},
                                     {"int8_attention": True, "fused_geglu": False}])
def test_create_refuses_the_options_without_int8(options):
    """With neither the UNet nor the ControlNet under an int8 policy, each
    option raises ValueError (it would not run); the defaults pass."""
    with pytest.raises(ValueError, match="int8"):
        PromptDiffusionSD15.create(**_tiny(F32), device="cpu", **options)
    with pytest.raises(ValueError, match="int8"):
        PromptDiffusionSD15.create(**_tiny(F32), device="cpu", policy=fp32_policy(), **options)
    pipe = PromptDiffusionSD15.create(**_tiny(F32), device="cpu", int8_attention=False,
                                      fused_geglu=True)
    assert _options(pipe) == {("attn", False), ("geglu", True)}


def test_create_sets_the_options_on_every_module():
    """On models built or given, every attention and feed-forward of the
    UNet and the ControlNet takes the options; the defaults are K1 and
    K7; a built int8 pipeline takes them too."""
    pipe = PromptDiffusionSD15.create(**_tiny(INT8_F32), device="cpu", int8_attention=True,
                                      fused_geglu=False)
    assert _options(pipe) == {("attn", True), ("geglu", False)}
    assert _options(PromptDiffusionSD15.create(**_tiny(INT8_F32), device="cpu")) == {
        ("attn", False), ("geglu", True)}
    built = PromptDiffusionSD15.create(policy=int8_policy(), device="meta",
                                       int8_attention=True)
    assert _options(built) == {("attn", True), ("geglu", True)}


def test_from_single_file_plumbs_the_options(tmp_path):
    """`from_single_file` builds on the meta device through `create` with
    the options (an int8 UNet and ControlNet built on the meta device take
    them), and sets them on a loaded model it keeps; with fp32 models it
    refuses them."""
    from prompt_diffusion_tpu_torch.tools.torch_import import export_ldm_checkpoint
    from tests.test_torch_ckpt_import import RULE_KW

    src = PromptDiffusionSD15.create(**_tiny(F32), device="cpu")
    path = str(tmp_path / "tiny.ckpt")
    export_ldm_checkpoint(src.state_dicts(), path, unet_cfg=UNetConfig(**TINY_UNET), **RULE_KW)
    pipe = PromptDiffusionSD15.from_single_file(path, device="cpu", int8_attention=True,
                                                fused_geglu=False, **_tiny(INT8_F32, "meta"))
    assert _options(pipe) == {("attn", True), ("geglu", False)}
    for name in ("unet", "controlnet"):
        got, want = pipe.jax_modules()[name].state_dict(), src.jax_modules()[name].state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    kept = _tiny(INT8_F32, "meta")
    kept["controlnet"] = ControlNetSD15(UNetConfig(**TINY_UNET), 6, INT8_F32)  # loaded: kept
    pipe = PromptDiffusionSD15.from_single_file(path, device="cpu", int8_attention=True, **kept)
    assert pipe.controlnet is kept["controlnet"]
    assert _options(pipe) == {("attn", True), ("geglu", True)}
    with pytest.raises(ValueError, match="int8"):
        PromptDiffusionSD15.from_single_file(path, device="cpu", fused_geglu=False,
                                             **_tiny(F32, "meta"))


class _Built(Exception):
    pass


def test_entries_pass_the_options(monkeypatch):
    """`serve --policy int8 --int8-attention --unfused-geglu` and
    `profile_sd15 --int8 --int8-attention --unfused-geglu` hand `create`
    the options; without the int8 policy both entries refuse the flags."""
    seen = {}

    def fake_build(*args, ckpt=None, **kwargs):
        seen.update(kwargs)
        raise _Built

    monkeypatch.setattr(serve, "build_pipeline", fake_build)
    with pytest.raises(_Built):
        serve.main(["--policy", "int8", "--int8-attention", "--unfused-geglu", "--device", "cpu"])
    assert seen == {"int8_attention": True, "fused_geglu": False}
    seen.clear()
    with pytest.raises(_Built):
        serve.main(["--policy", "int8", "--device", "cpu"])
    assert seen == {}
    for argv in (["--policy", "bf16", "--int8-attention"], ["--policy", "bf16", "--unfused-geglu"]):
        with pytest.raises(SystemExit):
            serve.main(argv)
    monkeypatch.setattr(profile_sd15, "build", fake_build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profile_sd15, "card", lambda: "no card")
    with pytest.raises(_Built):
        profile_sd15.main(["--int8", "--int8-attention", "--unfused-geglu"])
    assert seen == {"int8": True, "conv_variant": "im2col", "int8_attention": True,
                    "fused_geglu": False}
    for argv in (["--int8-attention"], ["--unfused-geglu"]):
        with pytest.raises(SystemExit):
            profile_sd15.main(argv)
