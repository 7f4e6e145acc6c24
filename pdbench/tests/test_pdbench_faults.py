"""The check that decides `correct`, driven through the rest of a run on
the CPU at small widths (the look for a card skipped), with the timed path
broken underneath: each fault that a generation cell can have (a step
that returns its state, half the batch dropped, an altered image, a
denoiser blind to the prompt) turns `correct` false against the cell's own
limits; so does the control, the
reference one precision below the configuration in the program's place.
(No cell here spans chips, so no exchange between chips can be left out.)"""

import io
import time

import pytest
import torch

from pdbench import harness
from pdbench.calibrate import readings
from pdbench.tests.tiny import tiny_cell

SEED = 2_718_281_828_459
CELLS = ["sd15.int8.b8", "sd3.int8.b1"]


def _unchanged_state(monkeypatch, family):
    """The sampler's step returns its state unchanged."""
    if family == "sd15":
        from prompt_diffusion_tpu_torch.schedulers import ddim

        monkeypatch.setattr(ddim, "ddim_step", lambda x, eps, *a, **k: (x, x))
    else:
        from prompt_diffusion_tpu_torch.pipelines import prompt_diffusion_sd3 as p

        monkeypatch.setattr(p, "flow_match_step", lambda x, v, s, sn: x)


def _half_batch(monkeypatch, family):
    """The denoiser computes the first half of the images in each half of
    its CFG batch and copies them over the rest."""
    if family == "sd15":
        from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetSD15 as cls
    else:
        from prompt_diffusion_tpu_torch.models.mmdit_sd3 import SD3Transformer as cls
    inner = cls.forward

    def forward(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        keep = [o[: o.shape[0] // 2] for o in out.chunk(2)]
        return torch.cat([torch.cat([k, k]) for k in keep])

    monkeypatch.setattr(cls, "forward", forward)


def _altered_image(monkeypatch, family):
    """The VAE decode alters the first image where it produces it."""
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL

    inner = AutoencoderKL.decode

    def decode(self, z):
        out = inner(self, z)
        out[0] = -out[0]
        return out

    monkeypatch.setattr(AutoencoderKL, "decode", decode)


def _prompt_blind(monkeypatch, family):
    """The denoiser ignores the prompt: both halves of its CFG batch see
    the negative prompt's states (SD3: and its pooled vector)."""
    if family == "sd15":
        from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
        from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetSD15

        text = {UNetSD15: ((2, "context"),), ControlNetSD15: ((2, "context"),)}
    else:
        from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet
        from prompt_diffusion_tpu_torch.models.mmdit_sd3 import SD3Transformer

        text = {SD3Transformer: ((2, "encoder_hidden_states"), (3, "pooled_projections")),
                SD3ControlNet: ((4, "encoder_hidden_states"), (5, "pooled_projections"))}
    negative = lambda t: None if t is None else torch.cat([t.chunk(2)[0]] * 2)

    for cls, places in text.items():
        def forward(self, *args, _inner=cls.forward, _places=places, **kwargs):
            args = list(args)
            for pos, key in _places:
                if key in kwargs:
                    kwargs[key] = negative(kwargs[key])
                elif pos < len(args):
                    args[pos] = negative(args[pos])
            return _inner(self, *args, **kwargs)

        monkeypatch.setattr(cls, "forward", forward)


# each fault, and the numbers of which one at least has to catch it: a
# prompt-blind denoiser reads a `guidance` gap of exactly 1, which the
# SD1.5 int8 cell's limit (its W8A8 noise) lets through; its cond - uncond
# then points nowhere, and `guidance_angle` reads 1
FAULTS = {"unchanged_state": (_unchanged_state, ("step",)),
          "half_batch": (_half_batch, ("denoise",)),
          "altered_image": (_altered_image, ("decode",)),
          "prompt_blind": (_prompt_blind, ("guidance", "guidance_angle"))}


def _caught(result, log, names) -> bool:
    hits = [n for n in names if n in result["check"]
            and result["check"][n]["value"] > result["check"][n]["limit"]]
    return bool(hits) and all("check " + n in log for n in hits)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_turns_correct_false(monkeypatch, name, fault):
    cell = tiny_cell(name, steps=3)
    plant, caught_by = FAULTS[fault]
    plant(monkeypatch, cell.config["family"])
    log = io.StringIO()
    result = harness.run(cell, SEED, 0.0, False, time.perf_counter(), device="cpu", log=log)
    assert result["correct"] is False
    assert _caught(result, log.getvalue(), caught_by)


@pytest.mark.card
@pytest.mark.parametrize("seed", [5_100_000_041, 5_100_000_042, 5_100_000_043])
def test_prompt_blind_fails_the_main_cell_at_its_size(monkeypatch, card, seed):
    """The prompt-blind denoiser at `sd15.int8.b8`'s own size on the card."""
    from pdbench import spec

    cell = spec.cell(spec.benchmark(), "sd15.int8.b8")
    _prompt_blind(monkeypatch, "sd15")
    log = io.StringIO()
    result = harness.run(cell, seed, 0.0, False, time.perf_counter(), device=card, log=log)
    assert result["correct"] is False
    assert _caught(result, log.getvalue(), FAULTS["prompt_blind"][1]), result["check"]


@pytest.mark.parametrize("name", CELLS + ["sd15.bf16.b8", "sd3.bf16.b1"])
def test_control_fails_a_limit(name):
    cell = tiny_cell(name, steps=3)
    got = readings(cell, SEED, True, "cpu")["control"]
    limits = cell.limits["limits"]
    assert any(got[k] > limits[k] for k in limits)


def test_check_steps_take_the_ends_and_draws_from_the_seed():
    a = harness.check_steps(1, 50, 4)
    assert a[0] == 0 and a[-1] == 49 and len(a) == 4
    assert a == harness.check_steps(1, 50, 4)
    assert any(harness.check_steps(s, 50, 4) != a for s in range(2, 6))
    assert harness.check_steps(1, 3, 4) == [0, 1, 2]
