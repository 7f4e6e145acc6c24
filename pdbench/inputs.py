"""Each request's inputs, made on the device from (seed, request index).

Every request of every seed has the same sizes; what the seed changes is
the values. Prompts are token ids of CLIP's layout (SOT, a body of 1 to
`MAX_PROMPT` ids below SOT, EOT, then the pad id) with an empty negative
prompt, as the fork's generate scripts send; SD3 adds T5 ids (a body, EOS
1, then pad 0) of the traffic's `t5_len`. Images are uniform in [-1, 1]
at the traffic's size; the noises are standard normals.
"""

from __future__ import annotations

import torch

from pdbench.seeds import sub_seed

SOT, EOT = 49406, 49407
MAX_PROMPT = 75  # the longest prompt body CLIP's 77 positions hold


def _clip_ids(gen, b: int, n: int, max_body: int, pad: int, device, empty: bool):
    ids = torch.full((b, n), pad, dtype=torch.int64, device=device)
    ids[:, 0] = SOT
    if empty:
        ids[:, 1] = EOT
        return ids
    lengths = torch.randint(1, max_body + 1, (b,), generator=gen, device=device)
    body = torch.randint(0, SOT, (b, n), generator=gen, device=device)
    pos = torch.arange(n, device=device)[None]
    inside = (pos >= 1) & (pos <= lengths[:, None])
    ids = torch.where(inside, body, ids)
    return ids.scatter(1, (lengths + 1)[:, None], EOT)


def _t5_ids(gen, b: int, n: int, vocab: int, device):
    lengths = torch.randint(1, n, (b,), generator=gen, device=device)
    body = torch.randint(2, vocab, (b, n), generator=gen, device=device)
    pos = torch.arange(n, device=device)[None]
    ids = torch.where(pos < lengths[:, None], body, torch.zeros_like(body))
    return ids.scatter(1, lengths[:, None], 1)


def request_inputs(family: str, traffic: dict, cfg: dict, seed: int, index: int, device):
    """The keyword arguments of the pipeline's `generate` for request
    `index`, without the sampler's settings."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "request", index))
    b, size = traffic["batch"], traffic["size"]
    img = lambda c: torch.rand((b, size, size, c), generator=gen, device=device) * 2 - 1
    normal = lambda *shape: torch.randn(shape, generator=gen, device=device)
    max_body, n_ctx = MAX_PROMPT, 77
    if family == "sd15":
        pad = EOT
        return dict(
            token_ids=_clip_ids(gen, b, n_ctx, max_body, pad, device, False),
            neg_token_ids=_clip_ids(gen, b, n_ctx, max_body, pad, device, True),
            example_pair=img(6),
            query=img(3),
            init_noise=normal(b, size // 8, size // 8, cfg["unet"]["in_channels"]),
        )
    z, h = cfg["vae"]["z_channels"], size // 8
    ids = _clip_ids(gen, b, n_ctx, max_body, EOT, device, False)
    empty = _clip_ids(gen, b, n_ctx, max_body, EOT, device, True)
    neg_t5 = torch.zeros((b, traffic["t5_len"]), dtype=torch.int64, device=device)
    neg_t5[:, 0] = 1
    prompt = {"l": ids, "g": ids, "t5": _t5_ids(gen, b, traffic["t5_len"],
                                                cfg["t5"]["vocab_size"], device)}
    neg = {"l": empty, "g": empty, "t5": neg_t5}
    return dict(
        prompt_ids=prompt,
        neg_prompt_ids=neg,
        control_image=img(3),
        support_cond=img(3),
        support_image=img(3),
        pair_noise=normal(b, z, h, h),
        cond_noise=normal(b, z, h, h),
        init_noise=normal(b, h, h, z),
    )
