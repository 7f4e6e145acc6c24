"""Micro-batching generation server over the port's pipelines.

Counterpart of `prompt_diffusion_tpu/serving/server.py`, with the same
names and behaviour:
  * requests carry per-sample parameters (guidance and control scale,
    seed), which batch freely; the parameters that shape the loop (size,
    steps, eta, guess mode, sampler) pick the bucket;
  * batch sizes are powers of two up to `max_batch`, or
    `ServerConfig.buckets` (none above `max_batch`); a partial batch is
    padded by repeating its last request and sliced on the way out;
  * one worker thread owns the device; a bounded queue decouples the
    producers, and `flush_ms` bounds the extra latency a request pays to
    let a batch form; within a bucket requests are FIFO, and buckets are
    served round-robin.

A request's noise comes from its own `torch.Generator` seeded with its
seed and is drawn per request before stacking, so it never depends on the
batch or on the request's slot in it: x_T, and for SD3 then the VAE
sampling noise of the support pair and of the query condition. An eta > 0
DDIM request draws batch-shaped noise at every step, so it runs alone, at
batch 1 whatever the bucket set, never padded. The image depends on the
seed alone wherever every op is per sample: under the int8 policy the
dynamic per-tensor activation scale couples co-batched requests (ROADMAP,
queue 3), as it does in the JAX package. The worker runs under
`torch.no_grad()` itself (grad mode is thread-local).

Differences from the JAX package's server, by design (each a fault of
the reference): buckets above `max_batch` are refused; an eta > 0 request
is never padded past batch 1; the SD3 adapter's VAE sampling noise is the
request's, not one fixed key's for every batch.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class ServerStopped(RuntimeError):
    """Raised into futures still outstanding when the server shuts down."""


@dataclasses.dataclass
class GenerationRequest:
    """One SD1.5 generation job. Arrays are host numpy, NHWC."""

    token_ids: np.ndarray  # (77,) int32
    neg_token_ids: np.ndarray  # (77,) int32
    example_pair: np.ndarray  # (H, W, 6) float32 in [-1, 1]
    query: np.ndarray  # (H, W, 3) float32 in [-1, 1]
    num_steps: int = 50
    guidance_scale: float = 9.0
    control_scale: float = 1.0
    eta: float = 0.0
    guess_mode: bool = False
    sampler: str = "ddim"  # "ddim" | "plms" | "unipc" | "dpm++" | "dpm"
    seed: int = 0

    def bucket_key(self):
        """Everything that shapes the batch's loop."""
        h, w, _ = self.query.shape
        return (h, w, self.num_steps, self.eta, self.guess_mode, self.sampler)


@dataclasses.dataclass
class SD3GenerationRequest:
    """One SD3 Prompt-Diffusion job."""

    token_ids_l: np.ndarray  # (77,) int32 CLIP-L ids
    token_ids_g: np.ndarray  # (77,) int32 CLIP-G ids
    neg_ids_l: np.ndarray
    neg_ids_g: np.ndarray
    support_cond: np.ndarray  # (H, W, 3) [-1, 1]
    support_image: np.ndarray  # (H, W, 3) [-1, 1]
    query: np.ndarray  # (H, W, 3) [-1, 1]
    t5_ids: Optional[np.ndarray] = None  # (L,) int32, needs the pipeline's T5
    num_steps: int = 28
    guidance_scale: float = 7.0
    control_scale: float = 1.0
    shift: float = 3.0
    seed: int = 0

    def bucket_key(self):
        h, w, _ = self.query.shape
        # the control scale multiplies the ControlNet's token-space
        # residuals: one per bucket (guidance batches per sample)
        return (h, w, self.num_steps, self.shift, self.control_scale,
                self.t5_ids is not None)


@dataclasses.dataclass
class ServerConfig:
    max_batch: int = 8
    flush_ms: float = 10.0
    queue_size: int = 256
    # Allowed batch sizes. None = powers of two up to max_batch. Partial
    # flushes are padded up to the next allowed bucket.
    buckets: Optional[Tuple[int, ...]] = None


class GenerationServer:
    """Micro-batching server over `PromptDiffusionSD15.generate` (or the
    pipeline an adapter wraps).

    Usage:
        server = GenerationServer(pipe)
        server.start()
        fut = server.submit(request)      # a concurrent.futures.Future
        image = fut.result()              # (H, W, 3) float32 in [0, 1]
    """

    def __init__(self, pipe, config: Optional[ServerConfig] = None,
                 adapter: Optional["PipelineAdapter"] = None):
        self.pipe = pipe
        self.config = config or ServerConfig()
        if self.config.buckets:
            self._buckets = sorted(set(int(b) for b in self.config.buckets))
            if self._buckets[0] < 1:
                raise ValueError(f"bucket sizes must be >= 1: {self.config.buckets}")
            if self._buckets[-1] > self.config.max_batch:
                raise ValueError(f"bucket sizes must be <= max_batch {self.config.max_batch}: "
                                 f"{self.config.buckets}")
        else:
            self._buckets, b = [], 1
            while b <= self.config.max_batch:
                self._buckets.append(b)
                b *= 2
        self._adapter = adapter or SD15Adapter(pipe)
        self._queue: "queue.Queue" = queue.Queue(self.config.queue_size)
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # serializes submit()'s post-stop drain against stop()'s, so that a
        # request that lands in the consumerless queue after stop() drained
        # it is still failed, never left pending
        self._lifecycle = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0}

    # ---- lifecycle --------------------------------------------------------

    def start(self):
        with self._lifecycle:
            if self._worker is not None:
                return self
            self._stop.clear()
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()
        return self

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        worker = self._worker
        if worker is not None:
            worker.join(timeout)
        with self._lifecycle:
            # a worker still running after the timeout keeps its handle, so
            # a later start() cannot spawn a second one; it exits after its
            # batch and fails its own pending requests
            if worker is None or not worker.is_alive():
                self._worker = None
            self._fail_queued()

    def _fail_queued(self):
        """Drain the queue, failing every undone future. The caller holds
        self._lifecycle. Idempotent."""
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                return
            if not fut.done():
                fut.set_exception(ServerStopped("server stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- client API -------------------------------------------------------

    def submit(self, req) -> Future:
        fut: Future = Future()
        # backpressure outside the lifecycle lock: a submit blocked on a full
        # queue must not keep start() from spawning the worker that drains
        # it; the stop flag is checked at every wait slice
        while True:
            if self._stop.is_set():
                fut.set_exception(ServerStopped("server stopped"))
                return fut
            try:
                self._queue.put((req, fut), timeout=0.1)
                break
            except queue.Full:
                continue
        if self._stop.is_set():
            # raced with stop(): its drain may have run before the put
            with self._lifecycle:
                self._fail_queued()
        return fut

    def generate(self, req, timeout: Optional[float] = None):
        return self.submit(req).result(timeout)

    def warmup(self, sample, batches: Sequence[int] = ()):
        """Run each bucket once before taking traffic (the kernels' build
        and first launches, the int8 weight caches)."""
        for b in list(batches) or list(self._buckets):
            self._execute([sample] * b)

    # ---- worker -----------------------------------------------------------

    def _bucket_size(self, n: int) -> int:
        """The smallest allowed bucket that holds n requests (the collector
        never takes more than the largest)."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    @staticmethod
    def _batch_limit(req, max_batch: int) -> int:
        # eta > 0 draws batch-shaped noise at every DDIM step: only a batch
        # of one keeps the image a function of the request's seed
        if _alone(req):
            return 1
        return max_batch

    def _absorb(self, timeout: float) -> bool:
        """Move one queued item into the per-bucket pending map."""
        try:
            item = self._queue.get(timeout=timeout)
        except queue.Empty:
            return False
        self._pending.setdefault(item[0].bucket_key(), collections.deque()).append(item)
        return True

    def _run(self):
        with torch.no_grad():
            self._serve()

    def _serve(self):
        cfg = self.config
        # per-bucket FIFO queues, served round-robin (move_to_end after each
        # batch), so that traffic to one bucket cannot starve another
        self._pending = collections.OrderedDict()
        while not self._stop.is_set():
            if not self._pending and not self._absorb(0.05):
                continue
            key = next(iter(self._pending))
            dq = self._pending[key]
            self._pending.move_to_end(key)
            limit = self._batch_limit(dq[0][0], min(cfg.max_batch, self._buckets[-1]))
            deadline = time.perf_counter() + cfg.flush_ms / 1e3
            while len(dq) < limit:
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or not self._absorb(remaining):
                    break
            batch = [dq.popleft() for _ in range(min(len(dq), limit))]
            if not dq:
                del self._pending[key]
            reqs = [r for r, _ in batch]
            futs = [f for _, f in batch]
            try:
                images = self._execute(reqs)
                for f, img in zip(futs, images):
                    f.set_result(img)
            except Exception as e:  # a failed batch fails its own requests
                for f in futs:
                    if not f.done():
                        f.set_exception(e)
        for dq in self._pending.values():
            for _, fut in dq:
                if not fut.done():
                    fut.set_exception(ServerStopped("server stopped"))
        self._pending.clear()

    def _execute(self, reqs: Sequence) -> np.ndarray:
        n = len(reqs)
        # a request that must run alone is not padded, whatever the buckets
        bucket = n if _alone(reqs[0]) else self._bucket_size(n)
        padded = list(reqs) + [reqs[-1]] * (bucket - n)
        images = self._adapter.execute(padded)
        out = images[:n].float().cpu().numpy()
        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["padded_slots"] += bucket - n
        return out


def _alone(req) -> bool:
    """Whether `req` runs in a batch of its own (DDIM with eta > 0)."""
    return getattr(req, "eta", 0.0) > 0


class PipelineAdapter:
    """Builds the batched inputs of padded same-bucket requests and runs the
    pipeline once."""

    def execute(self, padded):  # pragma: no cover - interface
        raise NotImplementedError


def request_noise(seed: int, shape, device) -> torch.Tensor:
    """A request's x_T: N(0, 1) of `shape` from its own generator."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def _stack(padded, field, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.stack([getattr(r, field) for r in padded])).to(
        device=device, dtype=dtype)


def _per_sample(padded, field, device) -> torch.Tensor:
    """(B, 1, 1, 1) fp32 of a per-request number."""
    return torch.tensor([float(getattr(r, field)) for r in padded], dtype=torch.float32,
                        device=device)[:, None, None, None]


class SD15Adapter(PipelineAdapter):
    """SD1.5: per-sample guidance and control scales and x_T; for eta > 0
    (served at batch 1) the loop noise comes from a generator seeded with
    the request's seed and advanced past its x_T."""

    def __init__(self, pipe):
        self.pipe = pipe

    def inputs(self, padded) -> dict:
        """The keyword arguments of `pipe.generate` for the padded batch."""
        r0, dev = padded[0], self.pipe.device
        h, w, _ = r0.query.shape
        loop_gen = None
        if r0.eta > 0:
            loop_gen = torch.Generator(device=dev).manual_seed(int(r0.seed))
            torch.randn((h // 8, w // 8, 4), generator=loop_gen, device=dev)  # its x_T
        return dict(
            token_ids=_stack(padded, "token_ids", torch.int32, dev),
            neg_token_ids=_stack(padded, "neg_token_ids", torch.int32, dev),
            example_pair=_stack(padded, "example_pair", torch.float32, dev),
            query=_stack(padded, "query", torch.float32, dev),
            num_steps=r0.num_steps,
            guidance_scale=_per_sample(padded, "guidance_scale", dev),
            control_scale=_per_sample(padded, "control_scale", dev),
            eta=r0.eta,
            guess_mode=r0.guess_mode,
            init_noise=torch.stack([request_noise(r.seed, (h // 8, w // 8, 4), dev)
                                    for r in padded]),
            sampler=r0.sampler,
            generator=loop_gen,
        )

    def execute(self, padded):
        return self.pipe.generate(**self.inputs(padded))


class SD3Adapter(PipelineAdapter):
    """SD3: per-sample guidance and noise; the control scale, the shift and
    the presence of T5 ids split buckets. Each request's generator, seeded
    with its seed, gives its x_T (`request_noise`), then the VAE sampling
    noise of its support pair, then of its query condition, stacked over
    the batch as x_T is (the JAX adapter passes one fixed key for every
    batch, so there a request's image depended on its slot)."""

    def __init__(self, pipe):
        self.pipe = pipe

    def inputs(self, padded) -> dict:
        r0, dev = padded[0], self.pipe.device
        ids = lambda field: _stack(padded, field, torch.int32, dev)
        pd = {"l": ids("token_ids_l"), "g": ids("token_ids_g")}
        nd = {"l": ids("neg_ids_l"), "g": ids("neg_ids_g")}
        if r0.t5_ids is not None:
            pd["t5"] = ids("t5_ids")
            nd["t5"] = torch.zeros_like(pd["t5"])
        h, w, _ = r0.query.shape
        zc = self.pipe.vae.config.z_channels
        img = lambda field: _stack(padded, field, torch.float32, dev)
        noise = [self.request_noise(r.seed, h, w, zc, dev) for r in padded]
        return dict(
            prompt_ids=pd, neg_prompt_ids=nd, control_image=img("query"),
            support_cond=img("support_cond"), support_image=img("support_image"),
            num_steps=r0.num_steps,
            guidance_scale=_per_sample(padded, "guidance_scale", dev),
            controlnet_conditioning_scale=r0.control_scale,
            shift=r0.shift,
            **{k: torch.stack([n[k] for n in noise])
               for k in ("init_noise", "pair_noise", "cond_noise")},
        )

    @staticmethod
    def request_noise(seed: int, h: int, w: int, zc: int, device) -> dict:
        """One request's x_T (h/8, w/8, zc), then its support pair's and its
        query condition's VAE sampling noise (zc, h/8, w/8 each, as the
        moments are), from one generator seeded with `seed`; x_T is
        `request_noise(seed, ...)`."""
        g = torch.Generator(device=device).manual_seed(int(seed))
        draw = lambda shape: torch.randn(shape, generator=g, device=device,
                                         dtype=torch.float32)
        return {"init_noise": draw((h // 8, w // 8, zc)),
                "pair_noise": draw((zc, h // 8, w // 8)),
                "cond_noise": draw((zc, h // 8, w // 8))}

    def execute(self, padded):
        return self.pipe.generate(**self.inputs(padded))
