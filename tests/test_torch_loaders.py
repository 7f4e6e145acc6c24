"""PyTorch port, pipeline loaders: LoRA and textual inversion against the
JAX package's loaders on the same files (fused weights within 1e-6
relative, token ids equal), the fold seen by the int8 layers' cache, and a
tiny `generate` after `from_single_file` against JAX `jit_generate` (atol
1e-3, tests/test_torch_port_pipeline.py's bound). Tiny SD1.5 (tests/
test_ckpt_export.py's widths), fp32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prompt_diffusion_tpu.data import tokenizer as jtok
from prompt_diffusion_tpu.tools import loaders as jld
from prompt_diffusion_tpu.tools import torch_import as jti
from prompt_diffusion_tpu_torch.data import tokenizer as ptok
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.ops.quant import QuantDense, quant_weight
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools import torch_import as pti
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy
from chip_smoke import lora_targets
from tests.test_torch_ckpt_import import RULE_KW, jax_params, port_pipe, tiny_models  # noqa: F401
from tests.torch_port_util import TINY_CLIP, TINY_UNET

torch.set_num_threads(2)

REL = 1e-6  # fused weights against the JAX loader's and against fp64 on the host
IMG = 64


def _j_unet_cfg():
    from prompt_diffusion_tpu.models import unet_sd15 as junet

    return junet.UNetConfig(**TINY_UNET)


def make_lora(pipe, layout="peft", rank=4, alpha=None, seed=0, bare_unet=False):
    """A LoRA on every attention projection of the UNet and CLIP in
    `layout` ("peft": lora_A/lora_B; "legacy": lora.down/lora.up)."""
    g = torch.Generator().manual_seed(seed)
    sd, modules = {}, pipe.jax_modules()
    down_sfx, up_sfx = {"peft": (".lora_A.weight", ".lora_B.weight"),
                        "legacy": (".lora.down.weight", ".lora.up.weight")}[layout]
    for mod, name, key in lora_targets(pipe):
        out_f, in_f = modules[name].get_parameter(key).shape
        if bare_unet and mod.startswith("unet."):
            mod = mod[len("unet."):]
        sd[mod + down_sfx] = torch.randn(rank, in_f, generator=g) * 0.1
        sd[mod + up_sfx] = torch.randn(out_f, rank, generator=g) * 0.1
        if alpha is not None:
            sd[mod + ".alpha"] = torch.tensor(float(alpha))
    return sd


def _rel_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{err} > {rel} x {np.abs(want).max()}"


@pytest.mark.parametrize("layout,alpha,scale,bare", [
    ("peft", None, 1.0, False), ("peft", 8.0, 0.7, False), ("legacy", None, 1.0, False),
    ("legacy", 2.0, 1.3, True)])
def test_lora_fold_matches_jax(jax_params, tmp_path, layout, alpha, scale, bare):
    """peft and legacy layouts (with and without `.alpha`, a bare UNet
    module path, CLIP pairs under `text_encoder.`), from a `.safetensors`
    file: every fused weight within 1e-6 relative of the JAX loader's and
    of W + scale * (alpha / r) * B @ A in fp64; the other weights
    untouched."""
    from safetensors.torch import save_file

    pipe = port_pipe()
    load_jax_params(pipe, jax_params)
    before = {n: {k: v.clone() for k, v in sd.items()} for n, sd in pipe.state_dicts().items()}
    sd = make_lora(pipe, layout, alpha=alpha, bare_unet=bare)
    path = str(tmp_path / "lora.safetensors")
    save_file(sd, path)
    folded = pipe.load_lora_weights(path, scale=scale)
    want = jld.load_lora_weights(jax_params, path, scale=scale, unet_cfg=_j_unet_cfg(),
                                 clip_layers=TINY_CLIP["num_layers"])
    targets = lora_targets(pipe)
    assert sorted(folded["unet"] + folded["clip"]) == sorted(k for _, _, k in targets)
    for name in ("unet", "clip"):
        got, ref = pipe.state_dicts()[name], state_dict_from_jax(want[name])
        for key, t in got.items():
            if key in folded[name]:
                _rel_close(t.numpy(), ref[key].numpy())
            else:
                assert torch.equal(t, before[name][key]), key
    r = 4
    for mod, name, key in targets:
        if bare and mod.startswith("unet."):
            mod = mod[len("unet."):]
        sfx = ("lora_A", "lora_B") if layout == "peft" else ("lora.down", "lora.up")
        a, b = sd[f"{mod}.{sfx[0]}.weight"].double(), sd[f"{mod}.{sfx[1]}.weight"].double()
        w = before[name][key].double() + scale * (alpha / r if alpha else 1.0) * (b @ a)
        _rel_close(pipe.state_dicts()[name][key].numpy(), w.numpy())


def test_lora_scale_zero_is_the_identity(jax_params):
    """At scale 0 every weight and the images stay bit for bit."""
    pipe = port_pipe()
    load_jax_params(pipe, jax_params)
    rng = np.random.default_rng(5)
    req = dict(token_ids=torch.from_numpy(rng.integers(0, 100, (1, 77)).astype(np.int32)),
               neg_token_ids=torch.zeros((1, 77), dtype=torch.int32),
               example_pair=torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 6)).astype(np.float32)),
               query=torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)),
               num_steps=2, generator=torch.Generator().manual_seed(0))
    base = pipe.generate(**dict(req, generator=torch.Generator().manual_seed(0)))
    before = {n: {k: v.clone() for k, v in sd.items()} for n, sd in pipe.state_dicts().items()}
    pipe.load_lora_weights(make_lora(pipe), scale=0.0)
    for name, sd in pipe.state_dicts().items():
        for key, t in sd.items():
            assert torch.equal(t, before[name][key]), key
    assert torch.equal(pipe.generate(**dict(req, generator=torch.Generator().manual_seed(0))),
                       base)
    pipe.load_lora_weights(make_lora(pipe), scale=1.0)
    assert not torch.equal(pipe.generate(**dict(req, generator=torch.Generator().manual_seed(0))),
                           base)


@pytest.mark.parametrize("case", ["kohya", "unknown_unet", "unknown_clip", "incomplete", "empty"])
def test_lora_refusals_match_jax(jax_params, case):
    """Layouts and modules the loaders cannot place are refused by both
    packages with the same message, and the port changes no weight."""
    pipe = port_pipe()
    load_jax_params(pipe, jax_params)
    before = {n: {k: v.clone() for k, v in sd.items()} for n, sd in pipe.state_dicts().items()}
    sd = make_lora(pipe)
    match = {"kohya": "kohya", "unknown_unet": "did not match", "unknown_clip": "did not match",
             "incomplete": "incomplete", "empty": "no LoRA"}[case]
    if case == "kohya":
        sd["lora_unet_down_blocks_0_attentions_0_proj_in.lora_down.weight"] = torch.zeros(4, 32)
    elif case == "unknown_unet":
        sd["unet.foo.bar.lora_A.weight"] = torch.zeros(4, 32)
        sd["unet.foo.bar.lora_B.weight"] = torch.zeros(32, 4)
    elif case == "unknown_clip":
        sd["text_encoder.text_model.foo.lora_A.weight"] = torch.zeros(4, 32)
        sd["text_encoder.text_model.foo.lora_B.weight"] = torch.zeros(32, 4)
    elif case == "incomplete":
        sd.pop(next(k for k in sd if k.endswith("lora_B.weight")))
    else:
        sd = {"something.else": torch.zeros(2)}
    with pytest.raises(ValueError, match=match):
        pipe.load_lora_weights(sd)
    with pytest.raises(ValueError, match=match):
        jld.load_lora_weights(jax_params, sd, unet_cfg=_j_unet_cfg(),
                              clip_layers=TINY_CLIP["num_layers"])
    for name, s in pipe.state_dicts().items():
        for key, t in s.items():
            assert torch.equal(t, before[name][key]), key


def test_lora_fold_renews_the_int8_codes(jax_params):
    """Under an int8 policy a folded QuantDense quantizes anew: its int8
    codes change and equal those of the new fp32 weight."""
    pol = DTypePolicy(compute_dtype=torch.float32, quant="int8")
    cfg = UNetConfig(**TINY_UNET)
    models = tiny_models()
    models.update(unet=UNetSD15(cfg, pol), controlnet=ControlNetSD15(cfg, 6, pol))
    pipe = PromptDiffusionSD15.create(**models, device="cpu")
    load_jax_params(pipe, jax_params)
    layer = pipe.unet.input_blocks_1_attn.block_0.attn1.to_k
    assert isinstance(layer, QuantDense)
    codes, scales = (t.clone() for t in layer.quantized())
    version = layer.weight._version
    pipe.load_lora_weights(make_lora(pipe), scale=1.0)
    assert layer.weight._version > version
    new_codes, new_scales = layer.quantized()
    assert not torch.equal(new_codes, codes) and not torch.equal(new_scales, scales)
    want, want_s = quant_weight(layer.weight, dims=1)
    assert torch.equal(new_codes, want) and torch.equal(new_scales, want_s.view(-1))


# ---- textual inversion ----------------------------------------------------------


def _ti_file(layout, tmp_path, dim, n=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(n, dim, generator=g)
    if layout == "a1111":
        path = str(tmp_path / "ti.pt")
        torch.save({"string_to_param": {"*": emb}, "name": "Ani-Style", "step": 100,
                    "string_to_token": {"*": 265}}, path)
        return path, None
    if layout == "diffusers":
        path = str(tmp_path / "learned_embeds.bin")
        torch.save({"<cat-toy>": emb[0] if n == 1 else emb}, path)
        return path, None
    from safetensors.torch import save_file

    path = str(tmp_path / "ti.safetensors")
    save_file({"emb_params": emb}, path)
    return path, "<sks>"


@pytest.mark.parametrize("layout,n", [("a1111", 1), ("a1111", 3), ("diffusers", 1),
                                      ("diffusers", 2), ("safetensors", 2)])
def test_textual_inversion_matches_jax(jax_params, tmp_path, layout, n):
    """A1111, diffusers and safetensors files, one and several vectors:
    the same token and ids as the JAX loader, the same grown table (in the
    table's dtype and device), the tokenizers' ids of a prompt with the
    placeholder equal, and CLIP's states of that prompt within 1e-4 of the
    JAX CLIP on the JAX tree."""
    pipe = port_pipe()
    load_jax_params(pipe, jax_params)
    path, token = _ti_file(layout, tmp_path, TINY_CLIP["hidden_size"], n)
    tp, tj = ptok.HashTokenizer(), jtok.HashTokenizer()
    got_token, ids = pipe.load_textual_inversion(tp, path, token=token)
    new_params, want_token, want_ids = jld.load_textual_inversion(jax_params, tj, path,
                                                                  token=token)
    assert (got_token, ids) == (want_token, want_ids)
    assert ids == list(range(TINY_CLIP["vocab_size"], TINY_CLIP["vocab_size"] + n))
    table = pipe.text_encoder.token_embedding.weight
    assert table.dtype == torch.float32 and not table.requires_grad
    assert pipe.text_encoder.config.vocab_size == TINY_CLIP["vocab_size"] + n
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(new_params["clip"]["params"]["token_embedding"]["embedding"]))
    text = [f"a photo of {got_token} in a garden"]
    np.testing.assert_array_equal(tp(text), tj(text))
    assert tp(text)[0, 4:4 + n].tolist() == ids
    from prompt_diffusion_tpu.models import clip_text as jclip

    prompt = np.zeros((1, 77), np.int32)
    prompt[0, :3] = (7, 8, 9)
    prompt[0, 3:3 + n] = ids
    jcfg = jclip.CLIPTextConfig(**dict(TINY_CLIP, vocab_size=TINY_CLIP["vocab_size"] + n))
    from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy

    want = jclip.CLIPTextModel(config=jcfg, policy=j_fp32_policy()).apply(
        new_params["clip"], jnp.asarray(prompt))
    got = pipe.encode_prompt(torch.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want["last_hidden_state"]), atol=1e-4)


def test_textual_inversion_refusals(jax_params, tmp_path):
    pipe = port_pipe()
    load_jax_params(pipe, jax_params)
    tok = ptok.HashTokenizer()
    with pytest.raises(ValueError, match="embedding dim"):
        pipe.load_textual_inversion(tok, {"<x>": torch.zeros(7)})
    with pytest.raises(ValueError, match="ambiguous"):
        pipe.load_textual_inversion(tok, {"<x>": torch.zeros(64), "<y>": torch.zeros(64)})
    with pytest.raises(ValueError, match="token="):
        pipe.load_textual_inversion(tok, {"emb_params": torch.zeros(1, 64)})
    assert pipe.text_encoder.token_embedding.weight.shape[0] == TINY_CLIP["vocab_size"]


# ---- from_single_file, then generate ------------------------------------------------


@pytest.mark.parametrize("fmt", ["ckpt", "safetensors"])
def test_from_single_file_generates_as_jax(jax_params, tmp_path, fmt):
    """A checkpoint the JAX exporter wrote, loaded by `from_single_file`:
    a 3-step `generate` with injected x_T within atol 1e-3 of JAX
    `jit_generate` on the JAX import of the same file."""
    from prompt_diffusion_tpu.models import clip_text as jclip
    from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
    from prompt_diffusion_tpu.models import unet_sd15 as junet
    from prompt_diffusion_tpu.models import vae as jvae
    from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
    from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
    from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
    from tests.torch_port_util import TINY_VAE

    path = str(tmp_path / f"jax.{fmt}")
    if fmt == "ckpt":
        jti.export_ldm_checkpoint(jax_params, path, unet_cfg=_j_unet_cfg(), **RULE_KW)
    else:
        pipe0 = port_pipe()
        load_jax_params(pipe0, jax_params)
        pti.export_ldm_checkpoint(pipe0.state_dicts(), path, unet_cfg=UNetConfig(**TINY_UNET),
                                  **RULE_KW)
    params = jti.import_ldm_checkpoint(path, unet_cfg=_j_unet_cfg(), **RULE_KW)
    pipe = PromptDiffusionSD15.from_single_file(path, device="cpu", **tiny_models("meta"))
    jpol = j_fp32_policy()
    ucfg = _j_unet_cfg()
    jpipe = JPipe(
        unet=junet.UNetSD15(config=ucfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jpol),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP), policy=jpol),
        schedule=JSchedule.create())
    rng = np.random.default_rng(9)
    r = dict(ids=rng.integers(0, 100, (2, 77)).astype(np.int32), neg=np.zeros((2, 77), np.int32),
             pair=rng.uniform(-1, 1, (2, IMG, IMG, 6)).astype(np.float32),
             query=rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32),
             noise=rng.normal(size=(2, IMG // 8, IMG // 8, 4)).astype(np.float32))
    ref = np.asarray(jpipe.jit_generate()(
        params, jax.random.PRNGKey(0), jnp.asarray(r["ids"]), jnp.asarray(r["neg"]),
        jnp.asarray(r["pair"]), jnp.asarray(r["query"]), num_steps=3, guidance_scale=9.0,
        init_noise=jnp.asarray(r["noise"])))
    got = pipe.generate(torch.from_numpy(r["ids"]), torch.from_numpy(r["neg"]),
                        torch.from_numpy(r["pair"]), torch.from_numpy(r["query"]), num_steps=3,
                        guidance_scale=9.0, init_noise=torch.from_numpy(r["noise"]))
    inside = ((ref > 0.01) & (ref < 0.99)).mean()
    assert inside > 0.5, f"only {inside:.0%} of the pixels are not clipped"
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
