"""PyTorch port, SD3 slice: the MMDiT, the SD3 ControlNet and the SD3
Prompt-Diffusion `generate` against the JAX package on the CPU, at fp32 and
under the int8 serving policy (fp32 compute), with the weights carried over
by the bridge; the pipeline's own behavior and the device default. Tiny
configurations after tests/test_sd3.py, with the context widened to two
CLIPs (quick-gelu and gelu) and a tiny T5. Inputs come from numpy seeds;
each test states its bound."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd3 as jcn
from prompt_diffusion_tpu.models import mmdit_sd3 as jmm
from prompt_diffusion_tpu.models import t5_text as jt5
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3 as JPipe
from prompt_diffusion_tpu.utils.dtypes import DTypePolicy as JPolicy
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet, SupportPairDownProj
from prompt_diffusion_tpu_torch.models.mmdit_sd3 import (
    JointBlock,
    MMDiTConfig,
    SD3Transformer,
    _cropped_pos_embed,
)
from prompt_diffusion_tpu_torch.models.t5_text import T5Config, T5Encoder
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.ops.quant import QuantDense
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, fp32_policy
from tests.torch_port_util import nchw, nhwc, randomize

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
# 3 MMDiT blocks and 2 ControlNet taps: the tap interval 1.5 truncates
TCFG = dict(sample_size=8, patch_size=2, in_channels=4, num_layers=3, attention_head_dim=16,
            num_attention_heads=4, joint_attention_dim=64, caption_projection_dim=64,
            pooled_projection_dim=56, out_channels=4, pos_embed_max_size=16)
CCFG = dict(TCFG, num_layers=2)
CLIP_L = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              eot_token_id=99)
CLIP_G = dict(vocab_size=100, hidden_size=24, num_layers=3, num_heads=4, intermediate_size=48,
              activation="gelu", eot_token_id=99)  # 32 + 24 = 56 wide, zero-padded to 64
TINY_T5 = dict(vocab_size=50, d_model=64, d_kv=8, d_ff=96, num_layers=2, num_heads=4)
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=4,
                scale_factor=1.5305, shift_factor=0.0609)
J_INT8_F32 = JPolicy(compute_dtype=jnp.float32, quant="int8")
INT8_F32 = DTypePolicy(compute_dtype=torch.float32, quant="int8")
B, IMG, LT5 = 2, 64, 8
LAT = IMG // 8


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module.eval()


def test_create_defaults_to_the_card():
    """Both pipelines build on CUDA unless the caller asks for the CPU
    (checked on the signature: no card is needed)."""
    for pipe in (PromptDiffusionSD15, PromptDiffusionSD3):
        assert inspect.signature(pipe.create).parameters["device"].default == "cuda"


def test_cropped_pos_embed_equals_jax_table():
    """The port computes only the center crop of the sin-cos table; it
    equals the crop of the JAX package's full table bit for bit."""
    for dim, grid, base, gh, gw in ((64, 16, 4, 4, 4), (1536, 192, 64, 64, 64), (64, 16, 4, 6, 2)):
        full = jmm._2d_sincos_pos_embed(dim, grid, base).reshape(grid, grid, dim)
        top, left = (grid - gh) // 2, (grid - gw) // 2
        want = full[top:top + gh, left:left + gw].reshape(gh * gw, dim)
        np.testing.assert_array_equal(_cropped_pos_embed(dim, grid, base, gh, gw), want)


# ---- models against JAX --------------------------------------------------


@pytest.fixture(scope="module")
def model_case():
    rng = np.random.default_rng(40)
    inp = dict(lat=_normal(rng, (B, LAT, LAT, 4)), t=np.array([977.0, 31.5], np.float32),
               ctx=_normal(rng, (B, 77 + LT5, 64)), pooled=_normal(rng, (B, 56)),
               cond=_normal(rng, (B, LAT, LAT, 4)), pair=_normal(rng, (B, LAT, LAT, 4)))
    jt = jmm.SD3Transformer(config=jmm.MMDiTConfig(**TCFG), policy=j_fp32_policy())
    jc = jcn.SD3ControlNet(config=jmm.MMDiTConfig(**CCFG), policy=j_fp32_policy())
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    pt = randomize(jax.eval_shape(jt.init, KEY, j["lat"], j["t"], j["ctx"], j["pooled"]), 41)
    pc = randomize(jax.eval_shape(jc.init, KEY, j["lat"], j["t"], j["cond"], j["pair"],
                                  j["ctx"], j["pooled"]), 42)
    return inp, pt, pc


def _jcontrol(params, inp, policy, scale=0.8):
    jc = jcn.SD3ControlNet(config=jmm.MMDiTConfig(**CCFG), policy=policy)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return jc.apply(params, j["lat"], j["t"], j["cond"], j["pair"], j["ctx"], j["pooled"],
                    conditioning_scale=scale)


def _jtransformer(params, inp, taps, policy):
    jt = jmm.SD3Transformer(config=jmm.MMDiTConfig(**TCFG), policy=policy)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return np.asarray(jt.apply(params, j["lat"], j["t"], j["ctx"], j["pooled"],
                               block_controlnet_hidden_states=taps))


def _pcontrol(params, inp, policy, scale=0.8):
    m = _load(SD3ControlNet(MMDiTConfig(**CCFG), policy), params)
    t = lambda k: torch.from_numpy(inp[k])
    with torch.no_grad():
        return m(nchw(inp["lat"]), t("t"), nchw(inp["cond"]), nchw(inp["pair"]), t("ctx"),
                 t("pooled"), conditioning_scale=scale)


def _ptransformer(params, inp, taps, policy):
    m = _load(SD3Transformer(MMDiTConfig(**TCFG), policy), params)
    t = lambda k: torch.from_numpy(inp[k])
    with torch.no_grad():
        return nhwc(m(nchw(inp["lat"]), t("t"), t("ctx"), t("pooled"),
                      block_controlnet_hidden_states=taps))


def test_controlnet_and_transformer_match_jax_fp32(model_case):
    """SD3ControlNet taps and the SD3Transformer fed those taps, fp32:
    relative L2 within 1e-4 of JAX (each fed JAX's own taps, so the two
    comparisons are independent)."""
    inp, pt, pc = model_case
    jtaps = _jcontrol(pc, inp, j_fp32_policy())
    taps = _pcontrol(pc, inp, fp32_policy())
    assert len(taps) == 2 and taps[0].shape == (B, (LAT // 2) ** 2, 64)
    for got, ref in zip(taps, jtaps):
        assert _rel(got.numpy(), ref) <= 1e-4
    ref = _jtransformer(pt, inp, jtaps, j_fp32_policy())
    got = _ptransformer(pt, inp, tuple(torch.from_numpy(np.array(a)) for a in jtaps),
                        fp32_policy())
    assert got.shape == (B, LAT, LAT, 4)
    assert _rel(got, ref) <= 1e-4
    # the taps matter: without them the output moves
    assert _rel(_jtransformer(pt, inp, None, j_fp32_policy()), ref) > 1e-2


@pytest.mark.parametrize("pre_only", [False, True])
def test_int8_joint_block_matches_jax(pre_only):
    """One int8 JointBlock (fp32 compute), the same inputs as JAX's: the
    K13 / K10 / K11 pairs and the QuantDenses reproduce JAX int8, each
    stream within 5e-7 relative L2 of JAX int8 (measured 1.4e-7 and 2.0e-7;
    JAX int8 sits ~9e-3 from JAX fp32). One exception, with its cause: in
    the context stream of the full block the exact attention differs from
    XLA's by fp32 ulps, one value of the norm2 site's input sits at a
    rounding boundary and one int8 code moves. The feed-forward after it
    is row-local, so that one token row differs (2.8e-3) and every other
    row still holds 5e-7 (measured 3.3e-7); the whole stream stays within
    a fifth of JAX int8's own distance from JAX fp32 (measured 1.9e-4)."""
    rng = np.random.default_rng(50 + pre_only)
    cfg = jmm.MMDiTConfig(**TCFG)
    x = [_normal(rng, (B, 16, 64)), _normal(rng, (B, 77 + LT5, 64)), _normal(rng, (B, 64))]
    jb = lambda pol: jmm.JointBlock(cfg, pol, context_pre_only=pre_only)
    params = randomize(jax.eval_shape(jb(J_INT8_F32).init, KEY, *map(jnp.asarray, x)), 52)
    run = lambda pol: jb(pol).apply(params, *map(jnp.asarray, x))
    ref8, ref32 = run(J_INT8_F32), run(j_fp32_policy())
    port = _load(JointBlock(MMDiTConfig(**TCFG), INT8_F32, context_pre_only=pre_only), params)
    assert isinstance(port.ff_out, QuantDense) and isinstance(port.to_q, QuantDense)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, x))
    assert got[1] is None if pre_only else got[1].shape == x[1].shape
    for i in range(1 if pre_only else 2):
        quant_err = _rel(ref8[i], ref32[i])
        assert quant_err > 1e-3, quant_err
        g, r = got[i].numpy().reshape(-1, 64), np.asarray(ref8[i]).reshape(-1, 64)
        if i == 1:  # the context stream of the full block: one token row may differ
            row_err = np.linalg.norm(g - r, axis=1) / np.linalg.norm(r, axis=1)
            keep = np.arange(len(r)) != row_err.argmax()
            assert _rel(g[keep], r[keep]) <= 5e-7, (_rel(g[keep], r[keep]), row_err.max())
            assert _rel(g, r) <= quant_err / 5, (_rel(g, r), quant_err)
        else:
            assert _rel(g, r) <= 5e-7, (i, _rel(g, r), quant_err)


def test_int8_transformer_at_jax_noise_level(model_case):
    """The whole tiny int8 transformer (fp32 compute, with taps): as far
    from JAX fp32 as JAX int8 is (ratio within [0.5, 1.5]) and no farther
    from JAX int8 than 1.5 times that. An fp32 ulp between the frameworks
    becomes a whole code step at an int8 site and grows with depth, so the
    quantization itself is held block by block above."""
    inp, pt, pc = model_case
    jtaps = _jcontrol(pc, inp, j_fp32_policy())
    ptaps = tuple(torch.from_numpy(np.array(a)) for a in jtaps)
    ref8 = _jtransformer(pt, inp, jtaps, J_INT8_F32)
    ref32 = _jtransformer(pt, inp, jtaps, j_fp32_policy())
    got = _ptransformer(pt, inp, ptaps, INT8_F32)
    quant_err = _rel(ref8, ref32)
    ratio32, ratio8 = _rel(got, ref32) / quant_err, _rel(got, ref8) / quant_err
    assert quant_err > 1e-3, quant_err
    assert 0.5 <= ratio32 <= 1.5 and ratio8 <= 1.5, (quant_err, ratio32, ratio8)


# ---- the pipeline ---------------------------------------------------------


def _jpipe():
    pol = j_fp32_policy()
    return JPipe(
        transformer=jmm.SD3Transformer(config=jmm.MMDiTConfig(**TCFG), policy=pol),
        controlnet=jcn.SD3ControlNet(config=jmm.MMDiTConfig(**CCFG), policy=pol),
        down_proj=jcn.SupportPairDownProj(policy=pol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=pol),
        clip_l=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**CLIP_L), policy=pol),
        clip_g=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**CLIP_G), policy=pol),
        t5=jt5.T5Encoder(config=jt5.T5Config(**TINY_T5), policy=pol))


def _port_pipe(with_t5=True):
    pol = fp32_policy()
    return PromptDiffusionSD3.create(
        transformer=SD3Transformer(MMDiTConfig(**TCFG), pol),
        controlnet=SD3ControlNet(MMDiTConfig(**CCFG), pol),
        down_proj=SupportPairDownProj(pol), vae=AutoencoderKL(VAEConfig(**TINY_VAE), pol),
        clip_l=CLIPTextModel(CLIPTextConfig(**CLIP_L), pol),
        clip_g=CLIPTextModel(CLIPTextConfig(**CLIP_G), pol),
        t5=T5Encoder(T5Config(**TINY_T5), pol) if with_t5 else None, device="cpu")


@pytest.fixture(scope="module")
def pipes():
    jpipe = _jpipe()
    z = TINY_VAE["z_channels"]
    lat, t = jnp.zeros((1, LAT, LAT, z)), jnp.zeros((1,))
    ctx, pooled = jnp.zeros((1, 77 + LT5, 64)), jnp.zeros((1, 56))
    img, ids = jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, 77), jnp.int32)
    shapes = {  # `init_params` sizes the pooled input at SD3's 2048
        "transformer": jax.eval_shape(jpipe.transformer.init, KEY, lat, t, ctx, pooled),
        "controlnet": jax.eval_shape(jpipe.controlnet.init, KEY, lat, t, lat, lat, ctx, pooled),
        "down_proj": jax.eval_shape(jpipe.down_proj.init, KEY, img, img),
        "vae": jax.eval_shape(jpipe.vae.init, KEY, img),
        "clip_l": jax.eval_shape(jpipe.clip_l.init, KEY, ids),
        "clip_g": jax.eval_shape(jpipe.clip_g.init, KEY, ids),
        "t5": jax.eval_shape(jpipe.t5.init, KEY, jnp.zeros((1, LT5), jnp.int32)),
    }
    params = randomize(shapes, 60)
    # The VAE sampling noise cannot be shared across frameworks: the logvar
    # rows of quant_conv give logvar -40, clipped to -30, a noise scale of
    # 3e-7 (only the parameter values change).
    qc = params["vae"]["params"]["quant_conv"]
    qc["kernel"] = qc["kernel"].copy()
    qc["kernel"][..., z:] = 0.0
    qc["bias"] = qc["bias"].copy()
    qc["bias"][z:] = -40.0
    pipe = _port_pipe()
    load_jax_params(pipe, params)
    return jpipe, params, pipe


def _request(seed):
    rng = np.random.default_rng(seed)
    ids = lambda: dict(l=rng.integers(0, 99, (B, 77)).astype(np.int32),
                       g=rng.integers(0, 99, (B, 77)).astype(np.int32),
                       t5=rng.integers(0, 50, (B, LT5)).astype(np.int32))
    img = lambda: rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    r = dict(ids=ids(), neg=ids(), control=img(), cond=img(), image=img(),
             noise=rng.normal(size=(B, LAT, LAT, 4)).astype(np.float32))
    for key in ("ids", "neg"):
        r[key]["l"][:, 12] = r[key]["g"][:, 12] = 99  # end-of-text
    return r


def _port_ids(ids):
    return {k: torch.from_numpy(v) for k, v in ids.items()}


@pytest.mark.parametrize("window", [(0.0, 1.0), (0.3, 0.7)])
def test_generate_matches_jax(pipes, window):
    """Tiny `generate` (batch 2, 64², 3 flow-match steps, CFG 7, injected
    x_T), fp32, with the default and a windowed ControlNet (the middle step
    only): max abs within 1e-3 of JAX `jit_generate`."""
    jpipe, params, pipe = pipes
    r = _request(61)
    jids = lambda ids: {k: jnp.asarray(v) for k, v in ids.items()}
    ref = np.asarray(jpipe.jit_generate()(
        params, KEY, jids(r["ids"]), jids(r["neg"]), jnp.asarray(r["control"]),
        jnp.asarray(r["cond"]), jnp.asarray(r["image"]), num_steps=3, guidance_scale=7.0,
        control_guidance_start=window[0], control_guidance_end=window[1],
        init_noise=jnp.asarray(r["noise"])))
    got = pipe.generate(_port_ids(r["ids"]), _port_ids(r["neg"]),
                        torch.from_numpy(r["control"]), torch.from_numpy(r["cond"]),
                        torch.from_numpy(r["image"]), num_steps=3, guidance_scale=7.0,
                        control_guidance_start=window[0], control_guidance_end=window[1],
                        init_noise=torch.from_numpy(r["noise"]))
    assert got.shape == (B, IMG, IMG, 3)
    inside = ((ref > 0.01) & (ref < 0.99)).mean()
    assert inside > 0.5, f"only {inside:.0%} of the pixels are not clipped"
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_staged_t5_equals_in_graph(pipes):
    """The staged T5 path (`encode_t5` once, `t5_seq` / `neg_t5_seq` into a
    pipeline without T5) gives the in-graph T5 images bit for bit."""
    _, params, pipe = pipes
    r = _request(62)
    run = lambda p, **kw: p.generate(
        _port_ids(r["ids"]), _port_ids(r["neg"]), torch.from_numpy(r["control"]),
        torch.from_numpy(r["cond"]), torch.from_numpy(r["image"]), num_steps=2,
        init_noise=torch.from_numpy(r["noise"]), generator=torch.Generator().manual_seed(5), **kw)
    in_graph = run(pipe)
    staged = _port_pipe(with_t5=False)
    load_jax_params(staged, {k: v for k, v in params.items() if k != "t5"})
    seq = lambda ids: PromptDiffusionSD3.encode_t5(pipe.t5, torch.from_numpy(ids["t5"]))
    t5_seq, neg_seq = seq(r["ids"]), seq(r["neg"])
    assert t5_seq.shape == (B, LT5, 64) and t5_seq.abs().max() > 0
    assert torch.equal(run(staged, t5_seq=t5_seq, neg_t5_seq=neg_seq), in_graph)


def test_generate_seeded_noise_and_validation(pipes):
    _, _, pipe = pipes
    r = _request(63)
    imgs = [torch.from_numpy(r[k]) for k in ("control", "cond", "image")]
    run = lambda seed, **kw: pipe.generate(_port_ids(r["ids"]), _port_ids(r["neg"]), *imgs,
                                           num_steps=2,
                                           generator=torch.Generator().manual_seed(seed), **kw)
    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all() and a.min() >= 0 and a.max() <= 1
    assert torch.equal(a, b) and not torch.equal(a, c)
    bad = torch.zeros(B, 72, 72, 3)
    with pytest.raises(ValueError, match="divisible by 16"):
        pipe.generate(_port_ids(r["ids"]), _port_ids(r["neg"]), bad, bad, bad, num_steps=2)
    short = {k: v[:1] for k, v in _port_ids(r["ids"]).items()}
    with pytest.raises(ValueError, match="batch"):
        pipe.generate(short, _port_ids(r["neg"]), *imgs, num_steps=2)
    with pytest.raises(ValueError, match="support_cond"):
        pipe.generate(_port_ids(r["ids"]), _port_ids(r["neg"]), imgs[0], imgs[1][:, :32],
                      imgs[2], num_steps=2)
    with pytest.raises(ValueError, match="control_guidance_start"):
        run(0, control_guidance_start=0.8, control_guidance_end=0.2)


def test_bridge_uses_every_sd3_leaf_once(pipes):
    _, params, pipe = pipes
    modules = pipe.jax_modules()
    assert set(modules) == {"transformer", "controlnet", "down_proj", "vae", "clip_l", "clip_g",
                            "t5"}
    assert "t5" not in _port_pipe(with_t5=False).jax_modules()
    sds = {name: state_dict_from_jax(params[name]) for name in modules}
    for name, module in modules.items():
        leaves = traverse_util.flatten_dict(params[name]["params"])
        assert len(sds[name]) == len(leaves)
        assert set(sds[name]) == set(module.state_dict()), name
    # the 2x2 patch conv arrives as OIHW; the T5 bias table keeps its name
    k = np.asarray(params["transformer"]["params"]["pos_embed"]["proj"]["kernel"])
    np.testing.assert_array_equal(sds["transformer"]["pos_embed.proj.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sds["t5"]["blocks_0.attn.relative_attention_bias"].numpy(),
        params["t5"]["params"]["blocks_0"]["attn"]["relative_attention_bias"])
    assert "blocks_0.ln_attn.weight" in sds["t5"]
    # strict: a missing leaf, a missing namespace, an extra namespace
    pruned = dict(params)
    pruned["controlnet"] = {"params": dict(params["controlnet"]["params"])}
    del pruned["controlnet"]["params"]["controlnet_blocks_1"]
    with pytest.raises(RuntimeError, match="controlnet_blocks_1"):
        load_jax_params(pipe, pruned)
    with pytest.raises(ValueError, match="t5"):
        load_jax_params(pipe, {k: v for k, v in params.items() if k != "t5"})
    with pytest.raises(ValueError, match="t5"):
        load_jax_params(_port_pipe(with_t5=False), params)
