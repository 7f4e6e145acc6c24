"""PyTorch port, serving: the micro-batching GenerationServer on a tiny
SD1.5 pipeline on the CPU (32², 2 steps, random weights) and on the tiny
SD3 pipeline of tests/test_torch_sd3.py; the reference's three server
faults, repaired here (a request's image depends on its slot in an SD3
batch, eta > 0 requests padded past batch 1, buckets above max_batch
accepted), each held by a test; its int8 co-batching fault, pinned by a
test named for it; the tokenizer copy against the original; the serve
entry point."""

import dataclasses
import json
import struct
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.data import tokenizer as jtok
from prompt_diffusion_tpu.ops.quant import _quant_act as j_quant_act
from prompt_diffusion_tpu_torch import serve
from prompt_diffusion_tpu_torch.data import tokenizer as ptok
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.ops.quant import quant_act
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.serving import (
    GenerationRequest,
    GenerationServer,
    PipelineAdapter,
    SD3Adapter,
    SD3GenerationRequest,
    SD15Adapter,
    ServerConfig,
    ServerStopped,
)
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy, random_init_
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE

torch.set_num_threads(2)

RES, STEPS = 32, 2
TIMEOUT = 120


@pytest.fixture(scope="module")
def pipe():
    pol = fp32_policy()
    p = PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET), pol),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, pol),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), pol),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP), pol),
        device="cpu",
    )
    gen = torch.Generator().manual_seed(0)
    for m in p.jax_modules().values():
        random_init_(m, gen, std=0.1)
    return p


def _req(seed=0, steps=STEPS, guidance=9.0, control=1.0, **kw):
    rng = np.random.default_rng(seed + 100)
    return GenerationRequest(
        token_ids=rng.integers(0, 100, (77,)).astype(np.int32),
        neg_token_ids=np.zeros((77,), np.int32),
        example_pair=rng.uniform(-1, 1, (RES, RES, 6)).astype(np.float32),
        query=rng.uniform(-1, 1, (RES, RES, 3)).astype(np.float32),
        num_steps=steps, guidance_scale=guidance, control_scale=control, seed=seed, **kw)


def _serve(pipe, reqs, **cfg):
    """Submits `reqs` at once to a fresh server; returns (images, stats)."""
    cfg = dict(dict(max_batch=4, flush_ms=500.0), **cfg)
    srv = GenerationServer(pipe, ServerConfig(**cfg))
    with srv:
        futs = [srv.submit(r) for r in reqs]
        imgs = [f.result(timeout=TIMEOUT) for f in futs]
    return imgs, srv.stats


def test_concurrent_requests_batched_and_equal_to_generate(pipe):
    """Four requests with their own seeds and scales run as one batch, and
    each image is pipe.generate's on the stacked requests with each
    request's own noise and scales: the server adds nothing."""
    reqs = [_req(seed=i, guidance=3.0 + i, control=0.5 + 0.25 * i) for i in range(4)]
    imgs, stats = _serve(pipe, reqs)
    assert stats == {"requests": 4, "batches": 1, "padded_slots": 0}
    noise = torch.stack([torch.randn((RES // 8, RES // 8, 4),
                                     generator=torch.Generator().manual_seed(i))
                         for i in range(4)])
    col = lambda v: torch.tensor(v, dtype=torch.float32).reshape(4, 1, 1, 1)
    st = lambda f, dt: torch.from_numpy(np.stack([getattr(r, f) for r in reqs])).to(dt)
    ref = pipe.generate(st("token_ids", torch.int32), st("neg_token_ids", torch.int32),
                        st("example_pair", torch.float32), st("query", torch.float32),
                        num_steps=STEPS, guidance_scale=col([3.0, 4.0, 5.0, 6.0]),
                        control_scale=col([0.5, 0.75, 1.0, 1.25]), init_noise=noise)
    for img, want in zip(imgs, ref):
        assert img.shape == (RES, RES, 3) and img.dtype == np.float32
        np.testing.assert_array_equal(img, want.numpy())
    assert not np.array_equal(imgs[0], imgs[1])


def test_seed_deterministic_across_co_batched_strangers(pipe):
    """The same request in the same bucket size, with two different sets of
    strangers, is bit-equal (fp32; every op is per sample)."""
    a, _ = _serve(pipe, [_req(seed=7)] + [_req(seed=20 + i) for i in range(3)])
    b, _ = _serve(pipe, [_req(seed=7)] + [_req(seed=30 + i, guidance=4.0 + i, control=0.2)
                                          for i in range(3)])
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[1], b[1])


def test_sampler_and_config_split_buckets(pipe):
    """Sampler, steps and guess mode pick the bucket: four requests in
    three buckets run as three batches, and the samplers' update rules
    differ on the same x_T."""
    base = _req(seed=70)
    reqs = [base, dataclasses.replace(base, sampler="unipc"),
            dataclasses.replace(_req(seed=71), sampler="unipc"),
            dataclasses.replace(base, num_steps=3, sampler="dpm++")]
    assert len({r.bucket_key() for r in reqs}) == 3
    imgs, stats = _serve(pipe, reqs)
    assert stats["batches"] == 3 and stats["requests"] == 4
    assert stats["padded_slots"] == 0  # batches of 1, 2 and 1: each a bucket size
    assert all(np.isfinite(i).all() for i in imgs)
    assert not np.array_equal(imgs[0], imgs[1])
    assert dataclasses.replace(base, guess_mode=True).bucket_key() != base.bucket_key()


def test_restricted_bucket_set(pipe):
    """buckets=(1, 4): two requests pad to 4; buckets=(2,): four requests
    run as two batches of 2; a padded image equals the same request's in a
    full bucket of its size; bucket sizes below 1 are refused."""
    imgs, stats = _serve(pipe, [_req(seed=60), _req(seed=61)], buckets=(1, 4))
    assert stats == {"requests": 2, "batches": 1, "padded_slots": 2}
    full, _ = _serve(pipe, [_req(seed=s) for s in (60, 90, 91, 92)], buckets=(1, 4))
    np.testing.assert_array_equal(imgs[0], full[0])
    _, stats = _serve(pipe, [_req(seed=70 + i) for i in range(4)], buckets=(2,))
    assert stats == {"requests": 4, "batches": 2, "padded_slots": 0}
    with pytest.raises(ValueError, match=">= 1"):
        GenerationServer(pipe, ServerConfig(buckets=(0, 2)))


def test_warmup_runs_every_bucket(pipe):
    srv = GenerationServer(pipe, ServerConfig(max_batch=2))
    srv.warmup(_req(seed=1))
    assert srv.stats == {"requests": 3, "batches": 2, "padded_slots": 0}
    srv.warmup(_req(seed=1), batches=(2,))
    assert srv.stats["batches"] == 3


def test_submit_after_stop_fails_fast(pipe):
    srv = GenerationServer(pipe, ServerConfig(max_batch=2, flush_ms=5.0))
    srv.start()
    srv.stop()
    with pytest.raises(ServerStopped):
        srv.submit(_req(seed=0)).result(timeout=10)


def test_stop_drains_queued_futures(pipe):
    """Futures still queued at shutdown are failed, never left pending."""
    srv = GenerationServer(pipe, ServerConfig(max_batch=2, flush_ms=5.0))
    fut = srv.submit(_req(seed=1))  # never started: no consumer
    srv.stop()
    with pytest.raises(ServerStopped):
        fut.result(timeout=10)


def test_blocked_submit_does_not_deadlock_start(pipe):
    """A submit spinning on a full queue holds no lock that start() needs."""
    srv = GenerationServer(pipe, ServerConfig(max_batch=2, flush_ms=5.0, queue_size=2))
    futs = []

    def producer():
        for i in range(4):  # two fill the queue, the rest wait for the worker
            futs.append(srv.submit(_req(seed=i)))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while srv._queue.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    try:
        srv.start()
        t.join(timeout=60)
        assert not t.is_alive(), "submit never unblocked after start()"
        for f in futs:
            assert f.result(timeout=TIMEOUT).shape == (RES, RES, 3)
    finally:
        srv.stop()


class _Failing(PipelineAdapter):
    def execute(self, padded):
        raise RuntimeError("kernel launch failed")


def test_a_failed_batch_fails_its_requests(pipe):
    """An exception in the worker (a kernel that does not launch) reaches
    each request's future; nothing falls back."""
    srv = GenerationServer(pipe, ServerConfig(max_batch=2, flush_ms=50.0), adapter=_Failing())
    with srv:
        futs = [srv.submit(_req(seed=i)) for i in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                f.result(timeout=TIMEOUT)
        assert srv.submit(_req(seed=3)).exception(timeout=TIMEOUT) is not None


def test_eta_request_seeds_its_loop_noise(pipe):
    """eta > 0 is served at batch 1 and its loop noise comes from the
    request's seed: the same request twice gives the same image, another
    seed another."""
    reqs = [_req(seed=5, steps=3, eta=0.5), _req(seed=5, steps=3, eta=0.5),
            _req(seed=6, steps=3, eta=0.5)]
    imgs, stats = _serve(pipe, reqs)
    assert stats["batches"] == 3
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[0], imgs[2])
    inputs = SD15Adapter(pipe).inputs([reqs[0]])
    ref = pipe.generate(**inputs)
    np.testing.assert_array_equal(imgs[0], ref[0].numpy())


def test_eta_request_padded_past_batch_one(pipe):
    """The reference's fault (serving/server.py:296 there: with a bucket
    set without 1 an eta > 0 request was padded to 2, its loop noise drawn
    at batch 2), repaired: it runs alone at batch 1, unpadded, whatever the
    buckets, and its image is the batch-1 image of its seed."""
    req = _req(seed=5, steps=3, eta=0.5)
    one, _ = _serve(pipe, [req], buckets=(1,))
    two, stats = _serve(pipe, [req], buckets=(2, 4))
    assert stats == {"requests": 1, "batches": 1, "padded_slots": 0}
    np.testing.assert_array_equal(one[0], two[0])


def test_buckets_above_max_batch_accepted(pipe):
    """The reference's fault (serving/server.py:124 there: a bucket above
    max_batch was accepted, the collector stopped at max_batch and padded
    to the bucket), repaired: such a bucket set is refused when the server
    is built; a bucket at max_batch still pads a partial batch."""
    with pytest.raises(ValueError, match=r"bucket sizes must be <= max_batch 2: \(4,\)"):
        GenerationServer(pipe, ServerConfig(max_batch=2, buckets=(4,)))
    imgs, stats = _serve(pipe, [_req(seed=i) for i in range(2)], max_batch=4, buckets=(4,))
    assert stats == {"requests": 2, "batches": 1, "padded_slots": 2}
    assert len(imgs) == 2


def test_sd15_request_image_independent_of_its_slot(pipe):
    """A request at slot 0 and at slot 1 of a bucket of 2 (the server's
    adapter, another request beside it) gives the same image bit for bit:
    its noise is drawn from its own seed before stacking."""
    a, b = _req(seed=11, guidance=5.0), _req(seed=12, control=0.5)
    adapter = SD15Adapter(pipe)
    first, second = adapter.execute([a, b]), adapter.execute([b, a])
    np.testing.assert_array_equal(first[0].numpy(), second[1].numpy())
    np.testing.assert_array_equal(first[1].numpy(), second[0].numpy())
    assert not np.array_equal(first[0].numpy(), first[1].numpy())


@pytest.mark.parametrize("scale", [10.0, 0.5])
def test_int8_quant_act_couples_co_batched_samples(scale):
    """Reference fault (prompt_diffusion_tpu/ops/quant.py:52-57, kept; ROADMAP
    queue 3): the dynamic activation scale is one amax over the whole
    batch, so a co-batched stranger with larger activations changes a
    sample's int8 codes (a smaller one does not), against the server's
    per-request contract. The port's quant_act is JAX's, code for code."""
    rng = np.random.default_rng(40)
    a = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    stranger = (scale * rng.normal(size=(1, 4, 8, 8))).astype(np.float32)
    batch = np.concatenate([a, stranger])
    alone_q, alone_s = quant_act(torch.from_numpy(a))
    both_q, both_s = quant_act(torch.from_numpy(batch))
    jq, js = j_quant_act(jnp.asarray(batch))
    np.testing.assert_array_equal(both_q.numpy(), np.asarray(jq))
    assert float(both_s) == float(js)
    coupled = not torch.equal(alone_q[0], both_q[0])
    assert coupled == (np.abs(stranger).max() > np.abs(a).max())


def _sd3_pipe():
    from tests.test_torch_sd3 import IMG, _port_pipe

    p = _port_pipe(with_t5=False)
    gen = torch.Generator().manual_seed(1)
    for m in p.jax_modules().values():
        random_init_(m, gen, std=0.1)
    return p, IMG


def test_sd3_adapter_serves_requests():
    """Two SD3 requests with their own seeds and guidance share one batch,
    bit-equal to pipe.generate on the same noise; the control scale splits
    buckets."""
    pipe, res = _sd3_pipe()
    rng = np.random.default_rng(0)

    def req(seed, g, control=1.0):
        img = lambda: rng.uniform(-1, 1, (res, res, 3)).astype(np.float32)
        ids = lambda: rng.integers(0, 99, (77,)).astype(np.int32)
        return SD3GenerationRequest(
            token_ids_l=ids(), token_ids_g=ids(), neg_ids_l=ids(), neg_ids_g=ids(),
            support_cond=img(), support_image=img(), query=img(), num_steps=2,
            guidance_scale=g, control_scale=control, seed=seed)

    reqs = [req(1, 7.0), req(2, 3.0)]
    assert req(3, 7.0, control=0.5).bucket_key() != reqs[0].bucket_key()
    srv = GenerationServer(pipe, ServerConfig(max_batch=2, flush_ms=500.0),
                           adapter=SD3Adapter(pipe))
    with srv:
        futs = [srv.submit(r) for r in reqs]
        a, b = (f.result(timeout=TIMEOUT) for f in futs)
    assert srv.stats["batches"] == 1
    assert a.shape == (res, res, 3) and np.isfinite(a).all() and not np.array_equal(a, b)
    inputs = SD3Adapter(pipe).inputs(reqs)
    assert inputs["guidance_scale"].flatten().tolist() == [7.0, 3.0]
    ref = pipe.generate(**inputs)
    np.testing.assert_array_equal(a, ref[0].numpy())
    np.testing.assert_array_equal(b, ref[1].numpy())


def test_sd3_request_image_independent_of_its_slot():
    """The reference's fault (its SD3 adapter passes one fixed key for the
    VAE sampling noise of every batch, so a request's support pair and
    query condition latents depend on its slot), repaired: each request's
    x_T, pair noise and condition noise come from its own seed, and a
    request at slot 0 and at slot 1 of a bucket of 2 gives the same image
    bit for bit."""
    pipe, res = _sd3_pipe()
    rng = np.random.default_rng(3)

    def req(seed, g):
        img = lambda: rng.uniform(-1, 1, (res, res, 3)).astype(np.float32)
        ids = lambda: rng.integers(0, 99, (77,)).astype(np.int32)
        return SD3GenerationRequest(
            token_ids_l=ids(), token_ids_g=ids(), neg_ids_l=ids(), neg_ids_g=ids(),
            support_cond=img(), support_image=img(), query=img(), num_steps=2,
            guidance_scale=g, seed=seed)

    a, b = req(21, 7.0), req(22, 4.0)
    adapter = SD3Adapter(pipe)
    inputs = adapter.inputs([a, b])
    zc, lat = pipe.vae.config.z_channels, res // 8
    assert inputs["pair_noise"].shape == inputs["cond_noise"].shape == (2, zc, lat, lat)
    g = torch.Generator().manual_seed(21)
    for name, shape in (("init_noise", (lat, lat, zc)), ("pair_noise", (zc, lat, lat)),
                        ("cond_noise", (zc, lat, lat))):
        assert torch.equal(inputs[name][0], torch.randn(shape, generator=g)), name
    first, second = adapter.execute([a, b]), adapter.execute([b, a])
    np.testing.assert_array_equal(first[0].numpy(), second[1].numpy())
    np.testing.assert_array_equal(first[1].numpy(), second[0].numpy())
    assert not np.array_equal(first[0].numpy(), first[1].numpy())


TEXTS = ["a photograph of a red house by a lake", "", "An OIL painting, 3 cats!",
         "naïve café — 東京 tower", "one two  three " * 30, "<|startoftext|> style styles"]


def test_tokenizer_copy_matches_original(tmp_path):
    """HashTokenizer and CLIPTokenizer (a small vocabulary and merges
    written here) give the original's ids, with added tokens and both
    packings; load_tokenizer falls back the same way."""
    for tok_p, tok_j in ((ptok.HashTokenizer(), jtok.HashTokenizer()),):
        for t in (tok_p, tok_j):
            t.add_tokens({"Style": [42, 43]})
        for pack in (False, True):
            np.testing.assert_array_equal(tok_p(TEXTS, openclip_pack=pack),
                                          tok_j(TEXTS, openclip_pack=pack))
    byte_enc = ptok._bytes_to_unicode()
    assert byte_enc == jtok._bytes_to_unicode()
    vocab = {}
    for ch in byte_enc.values():
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    merges = ["#version: 0.2", "t h", "th e</w>", "a </w>", "o n", "s t"]
    for m in merges[1:]:
        vocab["".join(m.split())] = len(vocab)
    vocab.update({"<|startoftext|>": len(vocab), "<|endoftext|>": len(vocab) + 1})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(merges))
    tp, tj = ptok.load_tokenizer(str(tmp_path)), jtok.load_tokenizer(str(tmp_path))
    assert isinstance(tp, ptok.CLIPTokenizer)
    tp.add_tokens({"styles": 7})
    tj.add_tokens({"styles": 7})
    texts = TEXTS + ["the one stone", "the theme"]
    np.testing.assert_array_equal(tp(texts), tj(texts))
    np.testing.assert_array_equal(tp(texts, max_length=20, openclip_pack=True),
                                  tj(texts, max_length=20, openclip_pack=True))
    assert (ptok.SOT, ptok.EOT, ptok.MAX_LEN) == (jtok.SOT, jtok.EOT, jtok.MAX_LEN)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        assert isinstance(ptok.load_tokenizer(str(tmp_path / "none")), ptok.HashTokenizer)


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_serve_entry_demo_and_refusals(pipe, tmp_path, capsys):
    """The demo's four requests batch into one run and land as PNGs that
    decode to the served images; `--ckpt` serves a checkpoint: the entry's
    PNGs decode to `SD15Adapter.execute` of the same requests on a pipeline
    loaded from that file; an unknown sampler is refused."""
    from prompt_diffusion_tpu_torch.tools.torch_import import export_ldm_checkpoint
    from tests.test_torch_ckpt_import import RULE_KW, tiny_models

    tok = lambda texts: ptok.HashTokenizer()(texts) % 100  # the tiny CLIP's vocabulary
    srv = GenerationServer(pipe, ServerConfig(max_batch=4, flush_ms=500.0))
    with srv:
        paths = serve.run_demo(srv, tok, RES, STEPS, "unipc", str(tmp_path / "out"))
    assert srv.stats["batches"] == 1 and len(paths) == 4
    reqs = [serve.make_request(tok, p, i, RES, STEPS, "unipc", 7.0 + i)
            for i, p in enumerate(serve.DEMO_PROMPTS)]
    direct = SD15Adapter(pipe).execute(reqs).numpy()
    for path, want in zip(paths, direct):
        np.testing.assert_array_equal(
            _read_png(path), np.clip(np.rint(want * 255), 0, 255).astype(np.uint8))
    ckpt = str(tmp_path / "tiny.ckpt")
    export_ldm_checkpoint(pipe.state_dicts(), ckpt, unet_cfg=UNetConfig(**TINY_UNET), **RULE_KW)
    out = tmp_path / "served"
    assert serve.main(["--ckpt", ckpt, "--policy", "bf16", "--steps", str(STEPS), "--resolution",
                       str(RES), "--sampler", "unipc", "--demo", "--out-dir", str(out),
                       "--device", "cpu"], tokenizer=tok, **tiny_models("meta")) == 0
    assert f"loaded {ckpt}" in capsys.readouterr().out
    loaded = PromptDiffusionSD15.from_single_file(ckpt, device="cpu", **tiny_models("meta"))
    direct = SD15Adapter(loaded).execute(reqs).numpy()
    for i, want in enumerate(direct):
        np.testing.assert_array_equal(
            _read_png(str(out / f"req{i}.png")),
            np.clip(np.rint(want * 255), 0, 255).astype(np.uint8))
    with pytest.raises(SystemExit):
        serve.main(["--sampler", "euler"])


def test_demo_requests_batch_whatever_their_build_time(tmp_path, capsys):
    """`run_demo` builds every request before it submits the first, so a
    slow tokenizer cannot make a request miss the flush window and run in a
    batch of its own (under int8 the images change with the batch); the
    runs it prints are its own, not the warm-up's."""

    class Blank(PipelineAdapter):
        def execute(self, padded):
            return torch.zeros(len(padded), RES, RES, 3)

    def slow_tok(texts):
        time.sleep(0.1)  # two calls a request: longer than the window
        return ptok.HashTokenizer()(texts)

    srv = GenerationServer(None, ServerConfig(max_batch=4, flush_ms=50.0), adapter=Blank())
    with srv:
        srv.warmup(serve.make_request(ptok.HashTokenizer(), "warmup", 0, RES, STEPS, "ddim"))
        assert srv.stats["batches"] == 3  # buckets 1, 2 and 4
        paths = serve.run_demo(srv, slow_tok, RES, STEPS, "ddim", str(tmp_path / "out"))
    assert srv.stats["batches"] == 4 and len(paths) == 4
    assert "(1 batched runs)" in capsys.readouterr().out
