"""PyTorch port, diffusers folders and `.safetensors`: the port's
`tools/diffusers_import.py` against the JAX package's on the same folders
(SD1.5 with both VAE-attention key schemes, with and without
text_encoder/; the SD3 folder with T5), the two ControlNet exporters read
back by the JAX importer, and `tools/safetensors_io.py` against the
`safetensors` package byte for byte. Tiny configurations (tests/
test_ckpt_export.py, tests/test_torch_sd3.py), fp32; parameters must be
bit-equal."""

import json
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as pt_load_file
from safetensors.torch import save_file as pt_save_file

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd3 as jcn3
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import mmdit_sd3 as jmm
from prompt_diffusion_tpu.models import t5_text as jt5
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.tools import diffusers_import as jdi
from prompt_diffusion_tpu.tools import torch_import as jti
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet, SupportPairDownProj
from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
from prompt_diffusion_tpu_torch.models.t5_text import T5Config, T5Encoder
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools import diffusers_import as pdi
from prompt_diffusion_tpu_torch.tools import safetensors_io
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.test_torch_ckpt_import import assert_sd_equal, assert_tree_equal, tiny_models
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE, randomize

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
IMG = 64
# the SD3 configurations of tests/test_torch_sd3.py
TCFG = dict(sample_size=8, patch_size=2, in_channels=4, num_layers=3, attention_head_dim=16,
            num_attention_heads=4, joint_attention_dim=64, caption_projection_dim=64,
            pooled_projection_dim=56, out_channels=4, pos_embed_max_size=16)
CCFG = dict(TCFG, num_layers=2)
CLIP_L = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              eot_token_id=99)
CLIP_G = dict(vocab_size=100, hidden_size=24, num_layers=3, num_heads=4, intermediate_size=48,
              activation="gelu", eot_token_id=99)
TINY_T5 = dict(vocab_size=50, d_model=64, d_kv=8, d_ff=96, num_layers=2, num_heads=4)
SD3_VAE = dict(TINY_VAE, z_channels=4, scale_factor=1.5305, shift_factor=0.0609)
LT5 = 8


def _save(sd, folder, name="diffusion_pytorch_model.safetensors"):
    os.makedirs(folder, exist_ok=True)
    np_save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, os.path.join(folder, name))


def _vae_attention_keys(vae_tree, scheme, conv_form=False):
    """The VAE mid-block attention in a diffusers key scheme: "new"
    (to_q/.../to_out.0, diffusers >= 0.18) or "old" (query/.../proj_attn)."""
    names = ({"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0"} if scheme == "new"
             else {"q": "query", "k": "key", "v": "value", "proj_out": "proj_attn"})
    out = {}
    for side in ("encoder", "decoder"):
        node = vae_tree[side]["mid_attn_1"]
        tp = f"{side}.mid_block.attentions.0"
        out[f"{tp}.group_norm.weight"] = np.asarray(node["norm"]["scale"])
        out[f"{tp}.group_norm.bias"] = np.asarray(node["norm"]["bias"])
        for fname, tname in names.items():
            w = np.asarray(node[fname]["kernel"])[0, 0].T  # (Cout, Cin)
            out[f"{tp}.{tname}.weight"] = w[:, :, None, None] if conv_form else w
            out[f"{tp}.{tname}.bias"] = np.asarray(node[fname]["bias"])
    return out


def _clip_keys(tree, layers):
    sd = jti.export_rules(tree, jti.clip_key_rules(layers))
    return {k[len("transformer."):]: v for k, v in sd.items()}


# ---- SD1.5 folders ------------------------------------------------------------


@pytest.fixture(scope="module")
def sd15_params():
    ucfg = junet.UNetConfig(**TINY_UNET)
    jpol = j_fp32_policy()
    jpipe = JPipe(
        unet=junet.UNetSD15(config=ucfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jpol),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP), policy=jpol),
        schedule=JSchedule.create(),
    )
    shapes = jax.eval_shape(lambda r: jpipe.init_params(r, image_size=IMG), KEY)
    return randomize(shapes, 80)


def _write_sd15_folder(params, root, scheme, text_encoder=True, conv_form=False):
    ucfg = junet.UNetConfig(**TINY_UNET)
    _save(jti.export_rules(params["unet"]["params"], jdi.diffusers_unet_rules(ucfg)),
          os.path.join(root, "unet"))
    jdi.export_diffusers_controlnet(params["controlnet"], os.path.join(root, "controlnet"),
                                    cfg=ucfg)
    vae = params["vae"]["params"]
    vsd = jti.export_rules(vae, jdi.diffusers_vae_rules())
    vsd.update(_vae_attention_keys(vae, scheme, conv_form))
    _save(vsd, os.path.join(root, "vae"))
    if text_encoder:
        _save(_clip_keys(params["clip"]["params"], TINY_CLIP["num_layers"]),
              os.path.join(root, "text_encoder"), "model.safetensors")


@pytest.mark.parametrize("scheme,conv_form", [("new", False), ("old", False), ("new", True)])
def test_sd15_folder_imports_bit_equal(sd15_params, tmp_path, scheme, conv_form):
    """A diffusers SD1.5 folder (each VAE-attention key scheme; Linear or
    1x1-conv attention weights) through both importers: the port's state
    dicts equal the bridge's conversion of the JAX import, and
    `from_diffusers_folder` builds the pipeline `load_jax_params` gives."""
    root = str(tmp_path / "sd15")
    _write_sd15_folder(sd15_params, root, scheme, conv_form=conv_form)
    want = jdi.import_diffusers_folder(root, unet_cfg=junet.UNetConfig(**TINY_UNET))
    got = pdi.import_diffusers_folder(root, unet_cfg=UNetConfig(**TINY_UNET))
    assert set(got) == set(want) == {"unet", "controlnet", "vae", "clip"}
    for name in got:
        assert_sd_equal(got[name], state_dict_from_jax(want[name]))
    assert_tree_equal(want, sd15_params)
    pipe = PromptDiffusionSD15.from_diffusers_folder(root, device="cpu", **tiny_models("meta"))
    ref = PromptDiffusionSD15.create(**tiny_models(), device="cpu")
    load_jax_params(ref, want)
    for name, sd in pipe.state_dicts().items():
        assert_sd_equal(sd, ref.state_dicts()[name])


def test_sd15_folder_without_text_encoder(sd15_params, tmp_path):
    """No text_encoder/: both importers leave "clip" out; the pipeline
    loads the other three namespaces only when given a loaded CLIP, and
    refuses otherwise."""
    root = str(tmp_path / "sd15")
    _write_sd15_folder(sd15_params, root, "new", text_encoder=False)
    want = jdi.import_diffusers_folder(root, unet_cfg=junet.UNetConfig(**TINY_UNET))
    got = pdi.import_diffusers_folder(root, unet_cfg=UNetConfig(**TINY_UNET))
    assert set(got) == set(want) == {"unet", "controlnet", "vae"}
    models = tiny_models("meta")
    with pytest.raises(ValueError, match="clip"):
        PromptDiffusionSD15.from_diffusers_folder(root, device="cpu", **models)
    models = tiny_models("meta")
    clip = tiny_models()["text_encoder"]
    clip.load_state_dict(state_dict_from_jax(sd15_params["clip"]))
    models["text_encoder"] = clip
    pipe = PromptDiffusionSD15.from_diffusers_folder(root, device="cpu", **models)
    assert_sd_equal(pipe.unet.state_dict(), state_dict_from_jax(want["unet"]))
    assert pipe.text_encoder is clip


def test_unknown_vae_attention_scheme_is_refused(sd15_params, tmp_path):
    root = str(tmp_path / "sd15")
    _write_sd15_folder(sd15_params, root, "new")
    sd = np_load_file(os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"))
    sd = {k.replace(".to_q.", ".q_proj."): v for k, v in sd.items()}
    _save(sd, os.path.join(root, "vae"))
    with pytest.raises(KeyError, match="unrecognized VAE attention"):
        pdi.import_diffusers_folder(root, unet_cfg=UNetConfig(**TINY_UNET))


def test_export_diffusers_controlnet_reads_back_in_jax(sd15_params, tmp_path):
    """The port's ControlNet export through the JAX loader gives the JAX
    tree bit for bit, and the port reads the JAX export back."""
    folder = str(tmp_path / "cn_port")
    pdi.export_diffusers_controlnet(state_dict_from_jax(sd15_params["controlnet"]), folder,
                                    cfg=UNetConfig(**TINY_UNET))
    ucfg = junet.UNetConfig(**TINY_UNET)
    back = jti.apply_rules(jdi.load_component_state(folder), jdi.diffusers_controlnet_rules(ucfg))
    assert_tree_equal({"params": back}, sd15_params["controlnet"])
    folder = str(tmp_path / "cn_jax")
    jdi.export_diffusers_controlnet(sd15_params["controlnet"], folder, cfg=ucfg)
    got = pdi.apply_rules(pdi.load_component_state(folder),
                          pdi.diffusers_controlnet_rules(UNetConfig(**TINY_UNET)))
    assert_sd_equal(got, state_dict_from_jax(sd15_params["controlnet"]))


@pytest.mark.parametrize("width", ["default", "tiny"])
@pytest.mark.parametrize("table", ["unet", "encoder", "controlnet", "vae"])
def test_diffusers_rule_tables_match_jax(width, table):
    kw = TINY_UNET if width == "tiny" else {}
    p, j = UNetConfig(**kw), junet.UNetConfig(**kw)
    got, want = {
        "unet": lambda: (pdi.diffusers_unet_rules(p), jdi.diffusers_unet_rules(j)),
        "encoder": lambda: (pdi.diffusers_unet_rules(p, encoder_only=True),
                            jdi.diffusers_unet_rules(j, encoder_only=True)),
        "controlnet": lambda: (pdi.diffusers_controlnet_rules(p),
                               jdi.diffusers_controlnet_rules(j)),
        "vae": lambda: ((pdi.diffusers_vae_rules(TINY_VAE["ch_mult"], 1),
                         jdi.diffusers_vae_rules(TINY_VAE["ch_mult"], 1)) if width == "tiny"
                        else (pdi.diffusers_vae_rules(), jdi.diffusers_vae_rules())),
    }[table]()
    assert got == want


@pytest.mark.parametrize("layers", [2, 12, 24])
def test_sd3_rule_tables_match_jax(layers):
    assert pdi.sd3_transformer_rules(layers) == jdi.sd3_transformer_rules(layers)
    assert pdi.sd3_controlnet_rules(layers) == jdi.sd3_controlnet_rules(layers)
    for pre in (False, True):
        assert pdi.sd3_block_rules(layers - 1, pre) == jdi.sd3_block_rules(layers - 1, pre)


# ---- the SD3 folder -------------------------------------------------------------


@pytest.fixture(scope="module")
def sd3_params():
    pol = j_fp32_policy()
    z = SD3_VAE["z_channels"]
    lat, t = jnp.zeros((1, 8, 8, z)), jnp.zeros((1,))
    ctx, pooled = jnp.zeros((1, 77 + LT5, 64)), jnp.zeros((1, 56))
    img, ids = jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, 77), jnp.int32)
    tr = jmm.SD3Transformer(config=jmm.MMDiTConfig(**TCFG), policy=pol)
    cn = jcn3.SD3ControlNet(config=jmm.MMDiTConfig(**CCFG), policy=pol)
    shapes = {
        "transformer": jax.eval_shape(tr.init, KEY, lat, t, ctx, pooled),
        "controlnet": jax.eval_shape(cn.init, KEY, lat, t, lat, lat, ctx, pooled),
        "down_proj": jax.eval_shape(jcn3.SupportPairDownProj(policy=pol).init, KEY, img, img),
        "vae": jax.eval_shape(jvae.AutoencoderKL(config=jvae.VAEConfig(**SD3_VAE),
                                                 policy=pol).init, KEY, img),
        "clip_l": jax.eval_shape(jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**CLIP_L),
                                                     policy=pol).init, KEY, ids),
        "clip_g": jax.eval_shape(jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**CLIP_G),
                                                     policy=pol).init, KEY, ids),
        "t5": jax.eval_shape(jt5.T5Encoder(config=jt5.T5Config(**TINY_T5), policy=pol).init,
                             KEY, jnp.zeros((1, LT5), jnp.int32)),
    }
    return randomize(shapes, 81)


def _t5_hf_keys(tree, layers):
    """The JAX T5 tree in HF T5EncoderModel keys (the inverse of
    t5_params_from_state_dict)."""
    sd = {"shared.weight": tree["token_embedding"]["embedding"],
          "encoder.final_layer_norm.weight": tree["final_norm"]["scale"]}
    for i in range(layers):
        b, e = tree[f"blocks_{i}"], f"encoder.block.{i}"
        sd[f"{e}.layer.0.layer_norm.weight"] = b["ln_attn"]["scale"]
        sd[f"{e}.layer.1.layer_norm.weight"] = b["ln_ff"]["scale"]
        for n in ("q", "k", "v", "o"):
            sd[f"{e}.layer.0.SelfAttention.{n}.weight"] = np.asarray(b["attn"][n]["kernel"]).T
        for n in ("wi_0", "wi_1", "wo"):
            sd[f"{e}.layer.1.DenseReluDense.{n}.weight"] = np.asarray(b[n]["kernel"]).T
        if "relative_attention_bias" in b["attn"]:
            sd[f"{e}.layer.0.SelfAttention.relative_attention_bias.weight"] = \
                b["attn"]["relative_attention_bias"]
    return sd


@pytest.fixture(scope="module")
def sd3_folder(sd3_params, tmp_path_factory):
    """An SD3 diffusers folder written from the JAX trees with the JAX
    package's exporters and rule tables."""
    root = str(tmp_path_factory.mktemp("sd3"))
    p = {k: v["params"] for k, v in sd3_params.items()}
    _save(jti.export_rules(p["transformer"], jdi.sd3_transformer_rules(TCFG["num_layers"])),
          os.path.join(root, "transformer"))
    jdi.export_sd3_controlnet(sd3_params, os.path.join(root, "controlnet"),
                              num_layers=CCFG["num_layers"])
    vsd = jti.export_rules(p["vae"], jdi.diffusers_vae_rules())
    vsd.update(_vae_attention_keys(p["vae"], "new"))
    _save(vsd, os.path.join(root, "vae"))
    _save(_clip_keys(p["clip_l"], CLIP_L["num_layers"]), os.path.join(root, "text_encoder"),
          "model.safetensors")
    _save(_clip_keys(p["clip_g"], CLIP_G["num_layers"]), os.path.join(root, "text_encoder_2"),
          "model.safetensors")
    _save(_t5_hf_keys(p["t5"], TINY_T5["num_layers"]), os.path.join(root, "text_encoder_3"),
          "model.safetensors")
    return root


def _sd3_models(device, t5=True):
    pol = fp32_policy()
    with torch.device(device):
        models = dict(
            transformer=SD3Transformer(MMDiTConfig(**TCFG), pol),
            controlnet=SD3ControlNet(MMDiTConfig(**CCFG), pol),
            down_proj=SupportPairDownProj(pol), vae=AutoencoderKL(VAEConfig(**SD3_VAE), pol),
            clip_l=CLIPTextModel(CLIPTextConfig(**CLIP_L), pol),
            clip_g=CLIPTextModel(CLIPTextConfig(**CLIP_G), pol))
        t5_model = T5Encoder(T5Config(**TINY_T5), pol) if t5 else None
    return models, t5_model


def test_sd3_folder_imports_bit_equal(sd3_params, sd3_folder):
    """The SD3 folder with T5 through both importers: every namespace's
    state dict equals the bridge's conversion of the JAX import."""
    want = jdi.import_sd3_folder(sd3_folder, num_layers=3, controlnet_layers=2)
    got = pdi.import_sd3_folder(sd3_folder, num_layers=3, controlnet_layers=2)
    assert set(got) == set(want) == {"transformer", "controlnet", "down_proj", "vae", "clip_l",
                                     "clip_g", "t5"}
    for name in got:
        assert_sd_equal(got[name], state_dict_from_jax(want[name]))
    assert_tree_equal(want, sd3_params)


def test_sd3_from_folder_generates_as_the_source(sd3_params, sd3_folder):
    """`PromptDiffusionSD3.from_folder` (models built on the meta device,
    T5 given on it) holds the JAX trees' weights, and a 2-step request with
    staged T5 equals, bit for bit, the same request on a pipeline loaded by
    `load_jax_params` with in-graph T5."""
    models, t5 = _sd3_models("meta")
    pipe = PromptDiffusionSD3.from_folder(sd3_folder, device="cpu", t5=t5, **models)
    ref_models, ref_t5 = _sd3_models("cpu")
    ref = PromptDiffusionSD3.create(**ref_models, t5=ref_t5, device="cpu")
    load_jax_params(ref, sd3_params)
    for name, module in pipe.jax_modules().items():
        assert_sd_equal(module.state_dict(), ref.jax_modules()[name].state_dict())
    rng = np.random.default_rng(82)
    ids = lambda: {k: torch.from_numpy(rng.integers(0, 99, (1, 77)).astype(np.int32))
                   for k in "lg"}
    prompt, neg = ids(), ids()
    t5_ids = [torch.from_numpy(rng.integers(0, 50, (1, LT5)).astype(np.int32)) for _ in "pn"]
    img = lambda: torch.from_numpy(rng.uniform(-1, 1, (1, IMG, IMG, 3)).astype(np.float32))
    args = dict(control_image=img(), support_cond=img(), support_image=img(), num_steps=2)
    want = ref.generate(dict(prompt, t5=t5_ids[0]), dict(neg, t5=t5_ids[1]), **args,
                        generator=torch.Generator().manual_seed(3))
    seq, neg_seq = pipe.stage_t5(*t5_ids)
    assert pipe.t5 is None and "t5" not in pipe.jax_modules()
    got = pipe.generate(prompt, neg, **args, t5_seq=seq, neg_t5_seq=neg_seq,
                        generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_sd3_from_folder_without_t5(sd3_params, sd3_folder, tmp_path):
    """Without `t5` the folder's T5 is left out (CLIP-only pipeline); a
    folder without text_encoder_3/ refuses `t5=True`, as the root generate.py
    refuses `--t5-assets` there."""
    models, _ = _sd3_models("meta", t5=False)
    pipe = PromptDiffusionSD3.from_folder(sd3_folder, device="cpu", **models)
    assert pipe.t5 is None
    assert_sd_equal(pipe.clip_g.state_dict(), state_dict_from_jax(sd3_params["clip_g"]))
    root = str(tmp_path / "no_t5")
    os.makedirs(root)
    for sub in ("transformer", "controlnet", "vae", "text_encoder", "text_encoder_2"):
        os.symlink(os.path.join(sd3_folder, sub), os.path.join(root, sub))
    assert "t5" not in pdi.import_sd3_folder(root, 3, 2)
    with pytest.raises(ValueError, match="text_encoder_3"):
        PromptDiffusionSD3.from_folder(root, device="cpu", t5=True, **_sd3_models("meta")[0])


def test_export_sd3_controlnet_reads_back_in_jax(sd3_params, tmp_path):
    """The port's SD3 ControlNet export (with down_proj) through the JAX
    loader gives the JAX trees bit for bit."""
    folder = str(tmp_path / "sd3_controlnet")
    pdi.export_sd3_controlnet({k: state_dict_from_jax(sd3_params[k])
                               for k in ("controlnet", "down_proj")}, folder, num_layers=2)
    tree = jti.apply_rules(jdi.load_component_state(folder), jdi.sd3_controlnet_rules(2))
    down = tree.pop("down_proj")
    assert_tree_equal({"params": tree}, sd3_params["controlnet"])
    assert_tree_equal({"params": {"down_proj": down}}, sd3_params["down_proj"])


def test_export_sd3_folder_reads_back_in_jax(sd3_params, tmp_path):
    """The port's whole-folder SD3 export (every namespace, T5 in HF keys,
    the VAE attention in the diffusers >= 0.18 scheme) through the JAX
    importer gives the JAX trees bit for bit, and the port's importer gives
    its state dicts back."""
    sds = {k: state_dict_from_jax(v) for k, v in sd3_params.items()}
    root = str(tmp_path / "sd3_export")
    pdi.export_sd3_folder(sds, root, num_layers=3, controlnet_layers=2)
    assert sorted(os.listdir(root)) == ["controlnet", "text_encoder", "text_encoder_2",
                                        "text_encoder_3", "transformer", "vae"]
    assert_tree_equal(jdi.import_sd3_folder(root, num_layers=3, controlnet_layers=2),
                      sd3_params)
    back = pdi.import_sd3_folder(root, num_layers=3, controlnet_layers=2)
    for name, sd in sds.items():
        assert_sd_equal(back[name], sd)


def test_t5_state_dict_matches_jax(sd3_params):
    hf = _t5_hf_keys(sd3_params["t5"]["params"], 2)
    want = jdi.t5_params_from_state_dict(hf, 2)
    got = pdi.t5_params_from_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                         for k, v in hf.items()}, 2)
    assert_sd_equal(got, state_dict_from_jax({"params": want}))
    back = pdi.hf_t5_state_dict(got, 2)
    assert set(back) == set(hf)
    for k, v in hf.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_bin_components_load(sd15_params, tmp_path):
    """A component saved as a torch `.bin` reads as its safetensors form."""
    folder = str(tmp_path / "unet")
    sd = jti.export_rules(sd15_params["unet"]["params"],
                          jdi.diffusers_unet_rules(junet.UNetConfig(**TINY_UNET)))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               os.path.join(tmp_path, "x.bin"))
    os.makedirs(folder)
    os.rename(os.path.join(tmp_path, "x.bin"), os.path.join(folder, "diffusion_pytorch_model.bin"))
    got = pdi.load_component_state(folder)
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


# ---- safetensors_io -------------------------------------------------------------

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8, "BOOL": torch.bool}


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    make = lambda *s: (torch.randn(s, generator=g) * 100).to(dtype) if dtype.is_floating_point \
        else torch.randint(0, 2 if dtype == torch.bool else 120, s, generator=g).to(dtype)
    return {"b.weight": make(3, 5), "a": make(7), "scalar": make(), "empty": make(0, 4),
            "z.w": make(2, 3, 4)}


@pytest.mark.parametrize("name", list(DTYPES))
def test_safetensors_write_matches_the_package(tmp_path, name):
    """Files written here equal the package's byte for byte (torch and,
    where numpy has the dtype, numpy), alone and mixed with other dtypes,
    with and without metadata."""
    dtype = DTYPES[name]
    t = _tensors(dtype)
    mixed = dict(t, **{f"m.{k}": v for k, v in _tensors(torch.float16, 1).items()},
                 **{f"i.{k}": v for k, v in _tensors(torch.int64, 2).items()})
    for tensors, meta in ((t, None), (mixed, {"format": "pt"}), (t, {})):
        pt_save_file(tensors, str(tmp_path / "a"), metadata=meta)
        safetensors_io.save_file(tensors, str(tmp_path / "b"), metadata=meta)
        assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
        if dtype != torch.bfloat16:
            np_save_file({k: v.numpy() for k, v in tensors.items()}, str(tmp_path / "c"),
                         metadata=meta)
            assert (tmp_path / "c").read_bytes() == (tmp_path / "b").read_bytes()


@pytest.mark.parametrize("name", list(DTYPES))
def test_safetensors_read_matches_the_package(tmp_path, name):
    """Files the package wrote read here as the package reads them (names,
    dtypes, shapes, values, metadata); a channels_last tensor is written
    in logical order."""
    t = _tensors(DTYPES[name])
    path = str(tmp_path / "a.safetensors")
    pt_save_file(t, path, metadata={"k": "v"})
    got, want = safetensors_io.load_file(path), pt_load_file(path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        assert json.loads(f.read(n))["__metadata__"] == {"k": "v"}
    if DTYPES[name] != torch.bfloat16:
        np_want = np_load_file(path)
        for k in np_want:
            np.testing.assert_array_equal(got[k].numpy(), np_want[k])
    cl = torch.arange(2 * 3 * 2 * 2, dtype=torch.float32).view(2, 3, 2, 2)
    safetensors_io.save_file({"w": cl.contiguous(memory_format=torch.channels_last)},
                             str(tmp_path / "cl"))
    assert torch.equal(pt_load_file(str(tmp_path / "cl"))["w"], cl)


def _raw_file(path, header, data: bytes):
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + data)


@pytest.mark.parametrize("case", ["dtype", "overlap", "gap", "short", "shape", "header"])
def test_safetensors_refusals(tmp_path, case):
    """An unknown dtype, overlapping offsets, a gap, a data section the
    tensors do not fill, offsets that do not hold the shape, and a header
    longer than the file are refused."""
    path = str(tmp_path / "bad.safetensors")
    hdr = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
           "b": {"dtype": "F32", "shape": [1], "data_offsets": [8, 12]}}
    data = bytes(12)
    if case == "dtype":
        hdr["a"]["dtype"] = "Q32"
        hdr["a"]["shape"] = [1]
    elif case == "overlap":
        hdr["b"]["data_offsets"] = [4, 8]
        data = bytes(8)
    elif case == "gap":
        hdr["b"]["data_offsets"] = [12, 16]
        data = bytes(16)
    elif case == "short":
        data = bytes(16)
    elif case == "shape":
        hdr["a"]["shape"] = [3]
    _raw_file(path, hdr, data)
    if case == "header":
        with open(path, "r+b") as f:
            f.write(struct.pack("<Q", 10 ** 6))
    with pytest.raises(ValueError):
        safetensors_io.load_file(path)
    if case != "header":
        with pytest.raises(Exception):
            pt_load_file(path)


def test_safetensors_write_refusals(tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        safetensors_io.save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(tmp_path / "x"))
    with pytest.raises(ValueError, match="metadata"):
        safetensors_io.save_file({"x": torch.zeros(2)}, str(tmp_path / "x"), metadata={"a": 1})
