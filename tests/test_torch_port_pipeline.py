"""PyTorch port, pipeline: tiny SD1.5 Prompt-Diffusion `generate` against
the JAX package with the same weights and the same starting noise, the
weight bridge's coverage, and the port's independence from JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE, randomize

torch.set_num_threads(2)

B, IMG = 2, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pipes():
    jpol = j_fp32_policy()
    ucfg = junet.UNetConfig(**TINY_UNET)
    jpipe = JPipe(
        unet=junet.UNetSD15(config=ucfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jpol),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP), policy=jpol),
        schedule=JSchedule.create(),
    )
    shapes = jax.eval_shape(lambda r: jpipe.init_params(r, image_size=IMG), jax.random.PRNGKey(0))
    params = randomize(shapes, 20)

    pol = fp32_policy()
    pipe = PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET), pol),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, pol),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), pol),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP), pol),
        device="cpu",
    )
    load_jax_params(pipe, params)
    return jpipe, params, pipe


def _request(seed):
    rng = np.random.default_rng(seed)
    return dict(
        ids=rng.integers(0, 100, (B, 77)).astype(np.int32),
        neg=np.zeros((B, 77), np.int32),
        pair=rng.uniform(-1, 1, (B, IMG, IMG, 6)).astype(np.float32),
        query=rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
        noise=rng.normal(size=(B, IMG // 8, IMG // 8, 4)).astype(np.float32),
    )


@pytest.mark.parametrize("guess_mode", [False, True])
def test_generate_matches_jax(pipes, guess_mode):
    jpipe, params, pipe = pipes
    r = _request(1)
    ref = jpipe.jit_generate()(
        params, jax.random.PRNGKey(0), jnp.asarray(r["ids"]), jnp.asarray(r["neg"]),
        jnp.asarray(r["pair"]), jnp.asarray(r["query"]), num_steps=3, guidance_scale=9.0,
        guess_mode=guess_mode, init_noise=jnp.asarray(r["noise"]))
    got = pipe.generate(
        torch.from_numpy(r["ids"]), torch.from_numpy(r["neg"]), torch.from_numpy(r["pair"]),
        torch.from_numpy(r["query"]), num_steps=3, guidance_scale=9.0, guess_mode=guess_mode,
        init_noise=torch.from_numpy(r["noise"]))
    ref = np.asarray(ref)
    assert got.shape == (B, IMG, IMG, 3)
    inside = ((ref > 0.01) & (ref < 0.99)).mean()
    assert inside > 0.5, f"only {inside:.0%} of the pixels are not clipped"
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_generate_seeded_noise_and_validation(pipes):
    _, _, pipe = pipes
    r = {k: torch.from_numpy(v) for k, v in _request(2).items()}
    run = lambda seed: pipe.generate(r["ids"], r["neg"], r["pair"], r["query"], num_steps=2,
                                     generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all() and a.min() >= 0 and a.max() <= 1
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="divisible by 8"):
        pipe.generate(r["ids"], r["neg"], torch.zeros(B, 100, 100, 6),
                      torch.zeros(B, 100, 100, 3), num_steps=2)
    with pytest.raises(ValueError, match="batch"):
        pipe.generate(r["ids"][:1], r["neg"][:1], r["pair"], r["query"], num_steps=2)
    with pytest.raises(ValueError, match="unknown sampler"):
        pipe.generate(r["ids"], r["neg"], r["pair"], r["query"], sampler="euler")
    with pytest.raises(ValueError, match="DDIM-only"):
        pipe.generate(r["ids"], r["neg"], r["pair"], r["query"], sampler="unipc", eta=0.5)


def test_bridge_uses_every_leaf_once(pipes):
    _, params, pipe = pipes
    modules = pipe.jax_modules()
    assert set(modules) == {"unet", "controlnet", "vae", "clip"}
    sds = {name: state_dict_from_jax(params[name]) for name in modules}
    for name, module in modules.items():
        leaves = traverse_util.flatten_dict(params[name]["params"])
        assert len(sds[name]) == len(leaves)
        assert set(sds[name]) == set(module.state_dict()), name
    # a Dense kernel arrives transposed, a conv kernel as OIHW
    k = np.asarray(params["unet"]["params"]["time_embed"]["fc1"]["kernel"])
    np.testing.assert_array_equal(sds["unet"]["time_embed.fc1.weight"].numpy(), k.T)
    k = np.asarray(params["unet"]["params"]["input_blocks_0_conv"]["kernel"])
    np.testing.assert_array_equal(sds["unet"]["input_blocks_0_conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    # strict: a missing leaf does not load
    pruned = dict(params)
    pruned["vae"] = {"params": dict(params["vae"]["params"])}
    del pruned["vae"]["params"]["post_quant_conv"]
    with pytest.raises(RuntimeError, match="post_quant_conv"):
        load_jax_params(pipe, pruned)


def test_chip_smoke_token_ids_are_hash_tokenizer_ids():
    """chip_smoke.py writes HashTokenizer's rule out so that it imports
    nothing of the JAX package; both must give the same ids."""
    import chip_smoke
    from prompt_diffusion_tpu.data.tokenizer import HashTokenizer

    texts = list(chip_smoke.PROMPTS) + ["", "one two  three " * 30]
    np.testing.assert_array_equal(chip_smoke.hash_token_ids(texts), HashTokenizer()(texts))


def test_chip_smoke_counts_every_kernel_it_lists():
    """Every kernel in chip_smoke.py's JSON line has a counted wrapper, every
    kernel a path must launch is listed, and K9's prologue is held to one
    launch per K9 call on the int8 DPT-Hybrid path."""
    import chip_smoke

    counted = chip_smoke.wrappers()
    assert set(chip_smoke.KERNELS) == set(counted)
    assert all(hasattr(w, "launches") for w in counted.values())
    for tag, names in chip_smoke.PATH_KERNELS.items():
        assert set(names) <= set(counted), tag
    assert set(chip_smoke.DEVICE_FUNCTIONS) <= set(counted)
    per = chip_smoke.MIDAS_PER_FORWARD["midas_int8"]
    assert per["quant_k_int8"] == per["flash_attention_packed_int8"] == 12


def test_port_imports_no_jax():
    code = ("import sys, prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15, "
            "prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3, "
            "prompt_diffusion_tpu_torch.models.mmdit_sd3, "
            "prompt_diffusion_tpu_torch.models.controlnet_sd3, "
            "prompt_diffusion_tpu_torch.models.t5_text, "
            "prompt_diffusion_tpu_torch.ops.fused_adaln, "
            "prompt_diffusion_tpu_torch.ops.row_quant, "
            "prompt_diffusion_tpu_torch.tools.quant_tune, "
            "prompt_diffusion_tpu_torch.tools.profile_sd3, "
            "prompt_diffusion_tpu_torch.tools.attn_lab, "
            "prompt_diffusion_tpu_torch.tools.jax_bridge, "
            "prompt_diffusion_tpu_torch.annotators.midas, "
            "prompt_diffusion_tpu_torch.annotators.canny, "
            "prompt_diffusion_tpu_torch.annotators.hed, "
            "prompt_diffusion_tpu_torch.annotators.uniformer, "
            "prompt_diffusion_tpu_torch.annotators.mlsd, "
            "prompt_diffusion_tpu_torch.annotators.openpose, "
            "prompt_diffusion_tpu_torch.annotators.util, "
            "prompt_diffusion_tpu_torch.run_prompt_diffusion, "
            "prompt_diffusion_tpu_torch.tools.profile_midas, "
            "prompt_diffusion_tpu_torch.ops.resize, "
            "prompt_diffusion_tpu_torch.annotate_data, "
            "prompt_diffusion_tpu_torch.serving.server, prompt_diffusion_tpu_torch.serve, "
            "prompt_diffusion_tpu_torch.data.tokenizer, "
            "prompt_diffusion_tpu_torch.schedulers.unipc, "
            "prompt_diffusion_tpu_torch.schedulers.dpm_solver, "
            "prompt_diffusion_tpu_torch.schedulers.plms, "
            "prompt_diffusion_tpu_torch.tools.safetensors_io, "
            "prompt_diffusion_tpu_torch.tools.torch_import, "
            "prompt_diffusion_tpu_torch.tools.diffusers_import, "
            "prompt_diffusion_tpu_torch.tools.loaders, "
            "prompt_diffusion_tpu_torch.data.t5_tokenizer, "
            "prompt_diffusion_tpu_torch.data.coco_val, "
            "prompt_diffusion_tpu_torch.data.laion_meta, "
            "prompt_diffusion_tpu_torch.generate, "
            "prompt_diffusion_tpu_torch.data.edit_dataset, "
            "prompt_diffusion_tpu_torch.training.sd15, prompt_diffusion_tpu_torch.training.sd3, "
            "prompt_diffusion_tpu_torch.training.checkpoint, "
            "prompt_diffusion_tpu_torch.training.image_logger, "
            "prompt_diffusion_tpu_torch.train_sd15, prompt_diffusion_tpu_torch.finetune_sd15, "
            "prompt_diffusion_tpu_torch.train_sd3, prompt_diffusion_tpu_torch.tools.profile_train, "
            "prompt_diffusion_tpu_torch.evaluation, prompt_diffusion_tpu_torch.evaluation.ssim, "
            "prompt_diffusion_tpu_torch.evaluation.mse, prompt_diffusion_tpu_torch.evaluation.fid, "
            "prompt_diffusion_tpu_torch.evaluation.inception, "
            "prompt_diffusion_tpu_torch.utils.config, prompt_diffusion_tpu_torch.utils.profiling, "
            "prompt_diffusion_tpu_torch.tools.int8_quality, "
            "chip_smoke; "
            "bad = [m for m in ('jax', 'flax', 'prompt_diffusion_tpu', 'tools') "
            "if m in sys.modules]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
