"""PyTorch port, the batch `generate` entry and its data: the copies of
`t5_tokenizer`, `coco_val` and `laion_meta` against the originals on tiny
data roots written here (ids and batches equal), the entry's batch loop on
a tiny SD1.5 pipeline (the root generate.py's file layout, PNGs that decode to
the images `generate` gives, the support choice, rank sharding), and its
refusals (`--compute-fid` names ROADMAP queue 1, item 5)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from prompt_diffusion_tpu.data import coco_val as jcoco
from prompt_diffusion_tpu.data import laion_meta as jlaion
from prompt_diffusion_tpu.data import t5_tokenizer as jt5tok
from prompt_diffusion_tpu_torch import generate as entry
from prompt_diffusion_tpu_torch.data import coco_val as pcoco
from prompt_diffusion_tpu_torch.data import laion_meta as plaion
from prompt_diffusion_tpu_torch.data import t5_tokenizer as pt5tok
from prompt_diffusion_tpu_torch.data.tokenizer import HashTokenizer
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.utils.dtypes import random_init_
from tests.test_tokenizers import T5_SENTENCES, T5_VOCAB
from tests.test_torch_ckpt_import import tiny_models
from tests.test_torch_serving import _read_png

torch.set_num_threads(2)

RES = 32


def _jpg(path, rng, size=40):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """images/*.jpg, per-task conditions (hed for some images only) and
    prompts (not for every image)."""
    root = str(tmp_path_factory.mktemp("coco"))
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "prompts"))
    for i in range(5):
        name = f"{i:012d}"
        _jpg(os.path.join(root, "images", f"{name}.jpg"), rng)
        _jpg(os.path.join(root, "depth", f"{name}.jpg"), rng)
        if i != 2:
            _jpg(os.path.join(root, "hed", f"{name}.jpg"), rng)
        if i % 2 == 0:
            with open(os.path.join(root, "prompts", f"{name}.txt"), "w") as f:
                f.write(f"  a photo number {i}\n")
    return root


@pytest.fixture(scope="module")
def laion_root(tmp_path_factory):
    """laion_nonhuman/<group>/<name>.jpg with hed and depth conditions
    beside them; 24 images, so the 5% val split holds one."""
    root = str(tmp_path_factory.mktemp("laion"))
    rng = np.random.default_rng(1)
    for i in range(24):
        group = os.path.join(root, "laion_nonhuman", f"{i // 8:05d}")
        _jpg(os.path.join(group, f"{i:05d}.jpg"), rng)
        for task in ("hed", "depth"):
            _jpg(os.path.join(group, task, f"{i:05d}.jpg"), rng)
        if i % 3:
            with open(os.path.join(group, f"{i:05d}.txt"), "w") as f:
                f.write(f"image {i}")
    return root


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


# ---- the data copies -------------------------------------------------------------


@pytest.mark.parametrize("source", ["tokenizer.json", "spiece.model"])
def test_t5_tokenizer_copy_matches_original(tmp_path, source):
    if source == "tokenizer.json":
        (tmp_path / source).write_text(json.dumps(
            {"model": {"type": "Unigram", "vocab": [list(p) for p in T5_VOCAB]}}))
    else:
        import struct

        def varint(n):
            out = b""
            while True:
                b7, n = n & 0x7F, n >> 7
                out += bytes([b7 | (0x80 if n else 0)])
                if not n:
                    return out

        def piece(p, s):
            body = b"\x0a" + varint(len(p.encode())) + p.encode() + b"\x15" + struct.pack("<f", s)
            return b"\x0a" + varint(len(body)) + body

        (tmp_path / source).write_bytes(b"".join(piece(p, s) for p, s in T5_VOCAB))
    tp, tj = pt5tok.load_t5_tokenizer(str(tmp_path)), jt5tok.load_t5_tokenizer(str(tmp_path))
    assert isinstance(tp, pt5tok.T5Tokenizer)
    for max_length in (8, 256):
        np.testing.assert_array_equal(tp(T5_SENTENCES, max_length=max_length),
                                      tj(T5_SENTENCES, max_length=max_length))
    assert (pt5tok.PAD_ID, pt5tok.EOS_ID, pt5tok.UNK_ID, pt5tok.T5_MAX_LEN) == (
        jt5tok.PAD_ID, jt5tok.EOS_ID, jt5tok.UNK_ID, jt5tok.T5_MAX_LEN)
    assert pt5tok.load_t5_tokenizer(None) is None
    assert pt5tok.load_t5_tokenizer(str(tmp_path / "none")) is None


@pytest.mark.parametrize("task,batch", [("hed", 2), ("depth", 2), ("depth", 4), ("seg", 2)])
def test_coco_copy_matches_original(coco_root, task, batch):
    """The same items (images in [-1, 1], conditions in [0, 1], prompts,
    names) and the same flat batches, items without the task left out."""
    dp = pcoco.COCOValDataset(coco_root, tasks=["hed", "depth"], res=RES)
    dj = jcoco.COCOValDataset(coco_root, tasks=["hed", "depth"], res=RES)
    assert len(dp) == len(dj) == 5
    _assert_batches_equal([dp[i]["conditions"] for i in range(5)],
                          [dj[i]["conditions"] for i in range(5)])
    _assert_batches_equal(list(dp.batches(batch, task)), list(dj.batches(batch, task)))


@pytest.mark.parametrize("split,tasks_per_batch", [("val", 1), ("train", 1), ("train", 2)])
def test_laion_copy_matches_original(laion_root, split, tasks_per_batch):
    """The same split, the same seeded round-robin batches (images,
    conditions, prompts, task indices), and the fixed-support tuning
    loader."""
    kw = dict(human_tasks=(), nonhuman_tasks=("hed", "depth"), res=RES,
              tasks_per_batch=tasks_per_batch)
    mp, mj = plaion.ControlDataModule(laion_root, **kw), jlaion.ControlDataModule(laion_root, **kw)
    assert len(mp.datasets["nonhuman"][split]) == len(mj.datasets["nonhuman"][split])
    take = lambda it: [next(it) for _ in range(2)]
    _assert_batches_equal(take(iter(mp.loader(split, 2, seed=3))),
                          take(iter(mj.loader(split, 2, seed=3))))
    _assert_batches_equal(take(iter(mp.tuning_loader(split, 2, num_supports=2, seed=4))),
                          take(iter(mj.tuning_loader(split, 2, num_supports=2, seed=4))))
    assert plaion.make_split_indices(24)[1].tolist() == jlaion.make_split_indices(24)[1].tolist()
    assert plaion.TASKS == jlaion.TASKS


# ---- the entry ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_gen():
    """The entry's SD1.5 batch function over a tiny fp32 pipeline (random
    weights), recording its inputs."""
    pipe = PromptDiffusionSD15.create(**tiny_models(), device="cpu")
    gen = torch.Generator().manual_seed(0)
    for m in pipe.jax_modules().values():
        random_init_(m, gen, std=0.1)
    calls = []

    def run(ids, neg, pair, query, generator, prompts):
        calls.append(dict(ids=ids, pair=pair, query=query, prompts=prompts,
                          state=generator.get_state()))
        t = torch.from_numpy
        return pipe.generate(t(ids), t(neg), t(pair), t(query), num_steps=2, guidance_scale=5.0,
                             generator=generator)

    return pipe, run, calls


def tiny_tok(texts):
    return HashTokenizer()(texts) % 100  # the tiny CLIP's vocabulary


def _expected_coco(root, tasks, batch):
    ds = jcoco.COCOValDataset(root, tasks=tasks, res=RES)
    return {t: [n for b in ds.batches(batch, t) for n in b["name"]] for t in tasks}


@pytest.mark.parametrize("black", [False, True])
def test_batch_loop_coco_layout(coco_root, tiny_gen, tmp_path, black):
    """COCO: one subdirectory per task, one PNG per item that has the task,
    named as the data names it; the batch's first item is every item's
    support (zeros with --black-support); each PNG decodes to the image of
    the same call of `generate` rounded to 8 bits."""
    pipe, run, calls = tiny_gen
    args = entry.parse_args(["--data-root", coco_root, "--dataset", "coco", "--tasks", "hed",
                             "depth", "--resolution", str(RES), "--batch-size", "2",
                             "--out-dir", str(tmp_path / "out"), "--device", "cpu"]
                            + (["--black-support"] if black else []))
    calls.clear()
    n = entry.generate_batches(run, tiny_tok, entry.batch_iters(args), args.dataset, args.out_dir,
                               torch.Generator().manual_seed(0), black_support=black,
                               log=lambda *_: None)
    want = _expected_coco(coco_root, ["hed", "depth"], 2)
    assert n == sum(len(v) for v in want.values()) == 9
    assert sorted(os.listdir(args.out_dir)) == ["depth", "hed"]
    for task, names in want.items():
        assert sorted(os.listdir(os.path.join(args.out_dir, task))) == sorted(
            f"{name}.png" for name in names)
    first = jcoco.COCOValDataset(coco_root, tasks=["hed"], res=RES)
    b0 = next(first.batches(2, "hed"))
    call = calls[0]
    np.testing.assert_array_equal(call["query"], b0["condition"])
    if black:
        assert not call["pair"].any()
    else:
        np.testing.assert_array_equal(call["pair"][..., :3], b0["condition"][:1].repeat(2, 0))
        np.testing.assert_array_equal(call["pair"][..., 3:], b0["image"][:1].repeat(2, 0))
    np.testing.assert_array_equal(call["ids"], tiny_tok(b0["prompt"]))
    g = torch.Generator()
    g.set_state(call["state"])
    imgs = pipe.generate(*(torch.from_numpy(a) for a in (call["ids"], tiny_tok(["", ""]),
                                                         call["pair"], call["query"])),
                         num_steps=2, guidance_scale=5.0, generator=g).numpy()
    for name, img in zip(b0["name"], imgs):
        np.testing.assert_array_equal(
            _read_png(os.path.join(args.out_dir, "hed", f"{name}.png")),
            np.clip(np.rint(img * 255), 0, 255).astype(np.uint8))


def test_batch_loop_laion_layout(laion_root, tiny_gen, tmp_path):
    """LAION: one "meta" directory, `b{batch:05d}_{j}.png`; the query is
    the first condition of the first task, the support the sampled pair;
    --max-batches defaults to one pass over the val split."""
    _, run, calls = tiny_gen
    args = entry.parse_args(["--data-root", laion_root, "--dataset", "laion", "--tasks", "hed",
                             "--resolution", str(RES), "--batch-size", "1",
                             "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    iters = entry.batch_iters(args)
    assert args.max_batches == 1
    calls.clear()
    entry.generate_batches(run, tiny_tok, iters, args.dataset, args.out_dir,
                           torch.Generator().manual_seed(0), max_batches=args.max_batches,
                           log=lambda *_: None)
    assert os.listdir(args.out_dir) == ["meta"]
    assert os.listdir(os.path.join(args.out_dir, "meta")) == ["b00000_0.png"]
    dm = jlaion.ControlDataModule(laion_root, res=RES, human_tasks=(), nonhuman_tasks=("hed",))
    batch = next(iter(dm.loader("val", 1, seed=0)))
    np.testing.assert_array_equal(calls[0]["query"], batch["conditions"][:, 0, 0])
    np.testing.assert_array_equal(calls[0]["pair"], np.concatenate(
        [batch["conditions"][:, 0, 1], batch["images"][:, 1]], axis=-1))
    assert calls[0]["prompts"] == [p[0] for p in batch["prompts"]]


def test_batch_loop_shards_by_rank(coco_root, tiny_gen, tmp_path, monkeypatch):
    """With torch.distributed initialized, rank r of w takes batches
    r, r + w, ... of each task; without, (0, 1)."""
    assert entry.rank_world() == (0, 1)
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    rank, world = entry.rank_world()
    assert (rank, world) == (1, 2)
    _, run, _ = tiny_gen
    args = entry.parse_args(["--data-root", coco_root, "--dataset", "coco", "--tasks", "depth",
                             "--resolution", str(RES), "--batch-size", "2",
                             "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    n = entry.generate_batches(run, tiny_tok, entry.batch_iters(args), args.dataset,
                               args.out_dir, torch.Generator(), rank=rank, world=world,
                               log=lambda *_: None)
    names = _expected_coco(coco_root, ["depth"], 2)["depth"]
    assert n == 2 and sorted(os.listdir(os.path.join(args.out_dir, "depth"))) == [
        f"{name}.png" for name in names[2:4]]


@pytest.mark.parametrize("argv,match", [
    (["--compute-fid", "--random-init"], "ROADMAP queue 1, item 5"),
    (["--stack", "sd3", "--sampler", "unipc", "--random-init"], "sd15 only"),
    ([], "--ckpt is required")])
def test_entry_refusals(tmp_path, capsys, argv, match):
    """Refused before anything is built, with a message, exit code 2."""
    assert entry.main(["--data-root", str(tmp_path)] + argv) == 2
    assert match in capsys.readouterr().err


def test_entry_defaults_to_the_card():
    args = entry.parse_args(["--data-root", "x"])
    assert args.device == "cuda" and args.steps == 24 and args.sampler == "ddim"
