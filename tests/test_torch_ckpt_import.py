"""PyTorch port, reference ldm checkpoints: the port's importer, exporter
and loaders (`tools/torch_import.py`, `tools/jax_bridge.py`,
`tools/safetensors_io.py`) against the JAX package's on the same files, at
the tiny SD1.5 configuration of tests/test_ckpt_export.py, fp32. Files
cross in both directions and must give bit-equal parameters; the rule
tables must list the JAX tables' triples at the default and tiny widths."""

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util
from safetensors.numpy import save_file as np_save_file

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.tools import torch_import as jti
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools import torch_import as pti
from prompt_diffusion_tpu_torch.tools.jax_bridge import (
    check_materialized,
    jax_params_from_module,
    load_jax_params,
    load_module_state,
    load_state_dicts,
    state_dict_from_jax,
)
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE, randomize

torch.set_num_threads(2)

IMG = 64
RULE_KW = dict(vae_ch_mult=TINY_VAE["ch_mult"], vae_num_res_blocks=TINY_VAE["num_res_blocks"],
               clip_layers=TINY_CLIP["num_layers"])


def tiny_models(device="cpu"):
    """The tiny fp32 SD1.5 models, built on `device` (the meta device for
    the loaders)."""
    pol = fp32_policy()
    with torch.device(device):
        return dict(unet=UNetSD15(UNetConfig(**TINY_UNET), pol),
                    controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, pol),
                    vae=AutoencoderKL(VAEConfig(**TINY_VAE), pol),
                    text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP), pol))


def port_pipe():
    return PromptDiffusionSD15.create(**tiny_models(), device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    ucfg = junet.UNetConfig(**TINY_UNET)
    jpol = j_fp32_policy()
    jpipe = JPipe(
        unet=junet.UNetSD15(config=ucfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jpol),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP), policy=jpol),
        schedule=JSchedule.create(),
    )
    shapes = jax.eval_shape(lambda r: jpipe.init_params(r, image_size=IMG),
                            jax.random.PRNGKey(0))
    return randomize(shapes, 70)


@pytest.fixture(scope="module")
def jax_ckpt(jax_params, tmp_path_factory):
    """A `.ckpt` written by the JAX package's exporter."""
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "jax.ckpt")
    jti.export_ldm_checkpoint(jax_params, path, unet_cfg=junet.UNetConfig(**TINY_UNET),
                              **RULE_KW)
    return path


def _leaves(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb), (sorted(set(la) ^ set(lb)))[:10]
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def assert_sd_equal(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:10]
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


# ---- rule tables ------------------------------------------------------------


@pytest.mark.parametrize("width", ["default", "tiny"])
@pytest.mark.parametrize("table", ["unet", "controlnet", "vae", "clip"])
def test_rule_tables_match_jax(width, table):
    """The port's tables list the JAX tables' (torch key, Flax path, kind)
    triples; the UNet's decoder comes from the port's `decoder_plan(ds)`."""
    ukw = TINY_UNET if width == "tiny" else {}
    vkw = ({"ch_mult": TINY_VAE["ch_mult"], "num_res_blocks": TINY_VAE["num_res_blocks"]}
           if width == "tiny" else {})
    layers = TINY_CLIP["num_layers"] if width == "tiny" else 12
    got, want = {
        "unet": lambda: (pti.unet_key_rules(UNetConfig(**ukw)),
                         jti.unet_key_rules(junet.UNetConfig(**ukw))),
        "controlnet": lambda: (pti.unet_key_rules(UNetConfig(**ukw), is_controlnet=True),
                               jti.unet_key_rules(junet.UNetConfig(**ukw), is_controlnet=True)),
        "vae": lambda: (pti.vae_key_rules(**vkw), jti.vae_key_rules(**vkw)),
        "clip": lambda: (pti.clip_key_rules(layers), jti.clip_key_rules(layers)),
    }[table]()
    assert got == want


@pytest.mark.parametrize("width", ["default", "tiny"])
def test_rules_name_every_port_parameter(width):
    """Every state-dict key of the four models (built on the meta device,
    nothing allocated) is the port key of one rule's weight or bias, or
    CLIP's bare position embedding; every rule's weight key that the
    module lacks is a conditional layer (a ResBlock skip conv)."""
    pol = fp32_policy()
    kw = width == "tiny"
    with torch.device("meta"):
        ucfg = UNetConfig(**TINY_UNET) if kw else UNetConfig()
        mods = {"unet": UNetSD15(ucfg, pol), "controlnet": ControlNetSD15(ucfg, 6, pol),
                "vae": AutoencoderKL(VAEConfig(**TINY_VAE) if kw else VAEConfig(), pol),
                "clip": CLIPTextModel(CLIPTextConfig(**TINY_CLIP) if kw else CLIPTextConfig(),
                                      pol)}
    rules = pti._namespace_rules(ucfg, mods["vae"].config.ch_mult,
                                 mods["vae"].config.num_res_blocks,
                                 mods["clip"].config.num_layers)
    for name, (_, table) in rules.items():
        keys = set(mods[name].state_dict())
        named = {key for _, key in pti.rule_keys(table)}
        assert keys - named == ({"position_embedding"} if name == "clip" else set()), name
        absent = {key for ref, key in pti.rule_keys(table)
                  if ref.endswith(".weight") and key not in keys}
        assert all(".skip." in k or "nin_shortcut" in k for k in absent), sorted(absent)[:5]


# ---- files across the two packages ------------------------------------------


@pytest.mark.parametrize("fmt", ["ckpt", "safetensors"])
def test_jax_written_checkpoint_loads_bit_equal(jax_params, jax_ckpt, tmp_path, fmt):
    """A checkpoint the JAX exporter wrote (and its `.safetensors` form)
    through the port's importer: each namespace's state dict equals the
    bridge's conversion of the JAX import of the same file, and the two
    pipelines (`load_state_dicts` vs `load_jax_params`) hold equal tensors."""
    path = jax_ckpt
    if fmt == "safetensors":
        path = str(tmp_path / "jax.safetensors")
        np_save_file({k: np.ascontiguousarray(v)
                      for k, v in jti.load_torch_state_dict(jax_ckpt).items()}, path)
    ref_tree = jti.import_ldm_checkpoint(path, unet_cfg=junet.UNetConfig(**TINY_UNET),
                                         **RULE_KW)
    sds = pti.import_ldm_checkpoint(path, unet_cfg=UNetConfig(**TINY_UNET), **RULE_KW)
    assert set(sds) == {"unet", "controlnet", "vae", "clip"}
    for name in sds:
        assert_sd_equal(sds[name], state_dict_from_jax(ref_tree[name]))
    a, b = port_pipe(), port_pipe()
    load_state_dicts(a, sds)
    load_jax_params(b, ref_tree)
    for name in sds:
        assert_sd_equal(a.state_dicts()[name], b.state_dicts()[name])
    assert_tree_equal(ref_tree, jax_params)


@pytest.mark.parametrize("fmt", ["ckpt", "safetensors"])
def test_port_written_checkpoint_reads_back_in_jax(jax_params, tmp_path, fmt):
    """The port's export of a pipeline through the JAX importer gives the
    source JAX trees bit for bit; the port's own importer gives its state
    dicts back bit for bit."""
    pipe = port_pipe()
    load_jax_params(pipe, jax_params)
    path = str(tmp_path / f"port.{fmt}")
    pti.export_ldm_checkpoint(pipe.state_dicts(), path, unet_cfg=UNetConfig(**TINY_UNET),
                              **RULE_KW)
    back = jti.import_ldm_checkpoint(path, unet_cfg=junet.UNetConfig(**TINY_UNET), **RULE_KW)
    assert_tree_equal(back, jax_params)
    sds = pti.import_ldm_checkpoint(path, unet_cfg=UNetConfig(**TINY_UNET), **RULE_KW)
    for name, sd in pipe.state_dicts().items():
        assert_sd_equal(sds[name], sd)
    raw = pti.load_torch_state_dict(path)
    assert {k.split(".")[0] for k in raw} == {"model", "control_model", "first_stage_model",
                                              "cond_stage_model"}
    assert raw["model.diffusion_model.input_blocks.0.0.weight"].shape[1:] == (4, 3, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_checkpoints_keep_their_values(jax_params, tmp_path, dtype):
    """A bf16 or fp16 checkpoint (which the JAX importer cannot read as
    bf16) loads into the fp32 pipeline as the exact widening of its values,
    and exports back to the same bytes."""
    src = port_pipe()
    load_jax_params(src, jax_params)
    half = {n: {k: v.to(dtype) for k, v in sd.items()} for n, sd in src.state_dicts().items()}
    path = str(tmp_path / "half.ckpt")
    pti.export_ldm_checkpoint(half, path, unet_cfg=UNetConfig(**TINY_UNET), **RULE_KW)
    sds = pti.import_ldm_checkpoint(path, unet_cfg=UNetConfig(**TINY_UNET), **RULE_KW)
    for name in half:
        assert_sd_equal(sds[name], half[name])
    pipe = PromptDiffusionSD15.from_single_file(path, device="cpu", **tiny_models("meta"))
    for name, sd in pipe.state_dicts().items():
        assert_sd_equal(sd, {k: v.float() for k, v in half[name].items()})


# ---- building from a file -----------------------------------------------------


@pytest.mark.parametrize("fmt", ["ckpt", "safetensors"])
def test_from_single_file_builds_as_create_does(jax_params, tmp_path, fmt):
    """`from_single_file` fills models built on the meta device: every
    tensor ends on the requested device with the dtype and strides (the
    4-D weights in channels_last) that `create` gives, the values those of
    `load_jax_params`, and no tensor shares the file's memory."""
    ref = port_pipe()
    load_jax_params(ref, jax_params)
    path = str(tmp_path / f"port.{fmt}")
    pti.export_ldm_checkpoint(ref.state_dicts(), path, unet_cfg=UNetConfig(**TINY_UNET),
                              **RULE_KW)
    pipe = PromptDiffusionSD15.from_single_file(path, device="cpu", **tiny_models("meta"))
    raw = pti.load_torch_state_dict(path)
    ptrs = {t.untyped_storage().data_ptr() for t in raw.values()}
    for name, module in pipe.jax_modules().items():
        want = ref.jax_modules()[name].state_dict()
        for key, t in module.state_dict().items():
            assert t.device.type == "cpu" and t.dtype == want[key].dtype, key
            assert t.stride() == want[key].stride(), key
            assert torch.equal(t, want[key]), key
            assert t.untyped_storage().data_ptr() not in ptrs, key
        assert not any(p.requires_grad for p in module.parameters())
        assert not module.training


def test_state_dict_loading_names_its_subsets(jax_params):
    """A pipeline loads all of its namespaces, or exactly the subset the
    caller names, never a subset silently; a missing key, a wrong shape and
    a meta module without a device are refused; `check_materialized` finds
    a namespace no file filled."""
    sds = {n: state_dict_from_jax(t) for n, t in jax_params.items()}
    pipe = PromptDiffusionSD15.create(**tiny_models("meta"), device="meta")
    part = {k: v for k, v in sds.items() if k != "clip"}
    with pytest.raises(ValueError, match="not the pipeline's"):
        load_state_dicts(pipe, part, device="cpu")
    with pytest.raises(ValueError, match="not the named"):
        load_state_dicts(pipe, part, namespaces={"unet", "vae"}, device="cpu")
    with pytest.raises(ValueError, match="are not the pipeline's"):
        load_state_dicts(pipe, part, namespaces={"unet", "controlnet", "vae", "t5"},
                         device="cpu")
    with pytest.raises(ValueError, match="meta device"):
        load_state_dicts(pipe, part, namespaces=set(part))
    load_state_dicts(pipe, part, namespaces=set(part), device="cpu")
    with pytest.raises(ValueError, match="clip"):
        check_materialized(pipe)
    with pytest.raises(RuntimeError, match="missing keys"):
        load_module_state(pipe.text_encoder, {k: v for k, v in sds["clip"].items()
                                              if k != "position_embedding"}, "cpu")
    bad = dict(sds["clip"], position_embedding=torch.zeros(3, 3))
    with pytest.raises(RuntimeError, match="shape"):
        load_module_state(pipe.text_encoder, bad, "cpu")
    load_module_state(pipe.text_encoder, sds["clip"], "cpu")
    check_materialized(pipe)
    with pytest.raises(ValueError, match="not the pipeline's"):
        load_jax_params(pipe, {"clip": jax_params["clip"]})
    load_jax_params(pipe, {"clip": jax_params["clip"]}, namespaces=["clip"])


def test_jax_params_from_module_inverts_the_bridge(jax_params):
    """Module state dict -> Flax tree gives the JAX trees bit for bit:
    kernels by the owning layer (dense, conv), scales of the norms, the
    embedding table and CLIP's bare position embedding."""
    pipe = port_pipe()
    load_jax_params(pipe, jax_params)
    for name, module in pipe.jax_modules().items():
        assert_tree_equal(jax_params_from_module(module), jax_params[name])


# ---- small functions against JAX ------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_make_it_fit_matches_jax(seed):
    """Cyclic resizing by one modular index per axis equals the JAX
    package's element loop, on random shapes (numpy and torch leaves),
    nested, with a leaf missing from the import."""
    rng = np.random.default_rng(seed)
    rank = int(rng.integers(1, 5))
    src_shape = tuple(int(s) for s in rng.integers(1, 5, rank))
    dst_shape = tuple(int(s) for s in rng.integers(1, 7, rank))
    src = rng.normal(size=src_shape).astype(np.float32)
    imported = {"a": {"w": src, "same": src}, "b": src[..., :1]}
    template = {"a": {"w": np.zeros(dst_shape), "same": np.zeros(src_shape),
                      "gone": np.zeros(3)}, "b": np.zeros(src[..., :1].shape)}
    want = jti.make_it_fit(imported, template)
    got = pti.make_it_fit(imported, template)
    got_t = pti.make_it_fit({"a": {"w": torch.from_numpy(src)}}, {"a": {"w": torch.zeros(dst_shape)}})
    assert got["a"]["gone"] is None and want["a"]["gone"] is None
    for g, w in ((got["a"]["w"], want["a"]["w"]), (got["a"]["same"], want["a"]["same"]),
                 (got["b"], want["b"]), (got_t["a"]["w"].numpy(), want["a"]["w"])):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_controlnet_init_from_unet_matches_jax(jax_params):
    """The shared encoder copied from the UNet into the ControlNet, as the
    JAX function does with trees; the hint blocks and taps keep theirs."""
    want = jti.controlnet_init_from_unet(jax_params["unet"], jax_params["controlnet"])
    got = pti.controlnet_init_from_unet(state_dict_from_jax(jax_params["unet"]),
                                        state_dict_from_jax(jax_params["controlnet"]))
    assert_sd_equal(got, state_dict_from_jax(want))
    assert torch.equal(got["input_blocks_1_res.in_conv.weight"],
                       state_dict_from_jax(jax_params["unet"])["input_blocks_1_res.in_conv.weight"])


def test_validate_tree_shapes_matches_jax(jax_params):
    ref = jax_params["vae"]["params"]
    bad = dict(ref, quant_conv={"kernel": np.zeros((1, 1, 2, 2)), "bias": ref["quant_conv"]["bias"]})
    bad.pop("post_quant_conv")
    assert pti.validate_tree_shapes(bad, ref) == jti.validate_tree_shapes(bad, ref)
    assert len(pti.validate_tree_shapes(bad, ref)) == 2
    sd = state_dict_from_jax(jax_params["vae"])
    assert pti.validate_tree_shapes(sd, sd) == []
