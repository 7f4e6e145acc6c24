"""What the SD1.5 and SD3 families share: building a module on the meta
device and giving it the seed's weights, the modes of the reference and of
its control, and the capture of the timed path's state."""

from __future__ import annotations

import torch
from torch import nn

from pdbench import weights
from pdbench.reference.common import FLOAT, Mode, set_mode


def materialize(module: nn.Module, seed: int, tag: str, device, std=None) -> nn.Module:
    """A module built on the meta device, moved to `device` uninitialised
    and filled with the seed's weights for `tag` (`weights.fill_`)."""
    module = module.to_empty(device=device)
    weights.fill_(module, seed, tag, device, std)
    return module.eval().requires_grad_(False)


def reference(cls, cfg: dict, seed: int, tag: str, device, mode: Mode = FLOAT,
              std=None) -> nn.Module:
    """A reference model with the seed's weights for `tag`, fp32."""
    with torch.device("meta"):
        model = cls(cfg)
    return set_mode(materialize(model.float(), seed, tag, device, std), mode)


def modes(policy: str, control: bool) -> dict:
    """{stage: Mode} of the reference (`control` False) or of its control:
    each stage one precision below what the configuration states: fp8
    (e4m3) for what runs in bf16, int4 for the int8 sites, bf16 for the
    fp32 sampler."""
    int8 = policy == "int8"
    if not control:
        return {"text": FLOAT, "hint": FLOAT, "decode": FLOAT, "step": FLOAT,
                "denoise": Mode(site_bits=8) if int8 else FLOAT}
    low = Mode(fp8=True)
    return {"text": low, "hint": low, "decode": low, "step": Mode(round_bf16=True),
            "denoise": Mode(site_bits=4, fp8=True) if int8 else low}


def difference(pair):
    """cond - uncond of a denoiser's (uncond || cond) output: the part that
    guidance scales, which only the text's path through the blocks makes."""
    u, c = pair.chunk(2)
    return c - u


def guidance_readings(got, want) -> dict:
    """The tested side's cond - uncond against the reference's:
    `guidance`, the relative L2 gap, and `guidance_angle`, 1 - the cosine
    between the two (0 where they point alike, 1 where the tested side
    has no cond - uncond at all, as a denoiser blind to the prompt)."""
    g, w = difference(got).double().flatten(), difference(want).double().flatten()
    gn, wn = torch.linalg.vector_norm(g), torch.linalg.vector_norm(w).clamp_min(1e-30)
    cos = float(torch.dot(g, w) / (gn * wn)) if gn > 0 else 0.0
    return {"guidance": float(torch.linalg.vector_norm(g - w) / wn), "guidance_angle": 1.0 - cos}


def require_sampler(traffic: dict, sampler: str) -> None:
    """Refuses traffic whose sampler is not `sampler` with eta 0: the
    family's check follows only that update."""
    got = (traffic["sampler"], traffic.get("eta", 0.0))
    if got != (sampler, 0.0):
        raise ValueError(f"traffic asks for sampler {got[0]!r} with eta {got[1]}; "
                         f"this family runs and checks {sampler!r} with eta 0 only")


class Capture:
    """Forward hooks that keep, for one request, what the timed path
    produced: per denoiser call its latent input (the first half of the
    CFG batch), its timestep and its output, and once the named tensors
    that `take_first` picks from a call. On a card each is copied into
    pinned host memory on the program's stream without a wait, so the
    capture holds no device memory and stalls no step; `load` brings them
    back as fp32 once the request has finished. `remove` takes the hooks
    off."""

    def __init__(self, batch: int, device):
        self.batch = batch
        self.to_host = torch.device(device).type == "cuda"
        self.x, self.t, self.out, self.first = [], [], [], {}
        self.handles = []

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if not (self.to_host and t.is_cuda):
            return t.clone()
        buf = torch.empty_like(t, device="cpu", pin_memory=True)
        return buf.copy_(t, non_blocking=True)

    def load(self, device) -> "Capture":
        """Every kept tensor as fp32 on `device`; the request's images on
        the host have already waited for the copies."""
        f = lambda t: t.to(device).float()
        self.x, self.out = [f(v) for v in self.x], [f(v) for v in self.out]
        self.t = [v.to(device) for v in self.t]
        self.first = {k: f(v) for k, v in self.first.items()}
        return self

    def on_denoiser(self, module: nn.Module, x_arg: int, t_arg: int, output: bool = True):
        """Keeps each call's latent input and timestep, and with `output`
        its output."""
        b = self.batch

        def pre(_, args, kwargs):
            self.x.append(self.keep(args[x_arg][:b]))
            self.t.append(self.keep(args[t_arg][:1]))

        def post(_, args, kwargs, out):
            self.out.append(self.keep(out))

        self.handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))
        if output:
            self.handles.append(module.register_forward_hook(post, with_kwargs=True))

    def take_first(self, module: nn.Module, pick, when=None, output: bool = False):
        """Keeps {name: tensor} = pick(args, kwargs[, out]) from the first
        call of `module` for which `when(args, kwargs)` holds."""

        def keep(picked):
            for k, v in picked.items():
                if k not in self.first:
                    self.first[k] = self.keep(v)

        if output:
            def hook(_, args, kwargs, out):
                if when is None or when(args, kwargs):
                    keep(pick(args, kwargs, out))
            self.handles.append(module.register_forward_hook(hook, with_kwargs=True))
        else:
            def hook(_, args, kwargs):
                if when is None or when(args, kwargs):
                    keep(pick(args, kwargs))
            self.handles.append(module.register_forward_pre_hook(hook, with_kwargs=True))

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def fine_spans(marks, denoisers) -> list:
    """Opens spans for the per-layer rooflines around the denoisers' int8
    layers (`QuantDense`, `QuantConv`: key ("int8_layer", least seconds)),
    their attention (`CrossAttention`, less its projections, and
    `JointBlock.attention`: ("attention", least seconds)) and the float
    projections inside a `CrossAttention` (("child",), so they leave its
    self time). Returns the functions that undo it."""
    from prompt_diffusion_tpu_torch.models.layers import CrossAttention
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import JointBlock
    from prompt_diffusion_tpu_torch.ops.quant import QuantConv, QuantDense

    from pdbench.counts import layers
    from pdbench.tracing import hook_spans, wrap_method

    def act(x):
        return (x[0], 1) if isinstance(x, tuple) else (x, x.element_size())

    def dense_key(m, args, kwargs):
        x, nbytes = act(args[0])
        return ("int8_layer", layers.int8_dense_s(tuple(x.shape), m.out_features, nbytes))

    def conv_key(m, args, kwargs):
        x, nbytes = act(args[0])
        return ("int8_layer", layers.int8_conv_s(tuple(x.shape), m.out_channels,
                                                 m.kernel_size[0], m.stride[0], m.padding[0],
                                                 nbytes))

    def cross_key(m, args, kwargs):
        x, _ = act(args[0])
        ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
        nk = x.shape[1] if ctx is None else act(ctx)[0].shape[1]
        return ("attention", layers.attention_s(x.shape[0], x.shape[1], nk, m.heads,
                                                m.dim_head))

    undo = []
    for model in denoisers:
        for m in model.modules():
            if isinstance(m, QuantDense):
                undo += [h.remove for h in hook_spans(marks, m, dense_key)]
            elif isinstance(m, QuantConv):
                undo += [h.remove for h in hook_spans(marks, m, conv_key)]
            elif isinstance(m, CrossAttention):
                undo += [h.remove for h in hook_spans(marks, m, cross_key)]
                for p in (m.to_q, m.to_k, m.to_v, m.to_out):
                    if not isinstance(p, QuantDense):
                        undo += [h.remove for h in hook_spans(marks, p, lambda *a: ("child",))]
            elif isinstance(m, JointBlock):
                key = (lambda blk: lambda q, k, v: ("attention", layers.attention_s(
                    q.shape[0], q.shape[1], k.shape[1], blk.heads, blk.head_dim)))(m)
                undo.append(wrap_method(marks, m, "attention", key))
    return undo
