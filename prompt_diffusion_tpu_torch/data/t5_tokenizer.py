"""T5 SentencePiece-Unigram tokenizer (host-side, pure python), for the
PyTorch port: a copy of `prompt_diffusion_tpu/data/t5_tokenizer.py` (the
port imports nothing of the JAX package; `tests/test_torch_generate_entry.py`
holds the two against each other), used by the `generate` entry's
`--t5-assets`.

The reference SD3 stack tokenizes T5 prompts with HF `T5TokenizerFast`
(train_promptdiffusion_sd3.py:871-906,
promptdiffusioncontrolnetpipeline_sd3.py:351-543). This environment has no
network and no sentencepiece wheel, so this module implements the Unigram
model directly:

  * loads vocab+scores from either an HF `tokenizer.json` (T5 repos ship
    one) or a raw `spiece.model` (sentencepiece protobuf — parsed with a
    minimal varint reader, no protobuf dependency);
  * Metaspace pre-tokenization ("▁" word markers, prefix always);
  * Viterbi segmentation maximizing the sum of piece log-probs, with the
    sentencepiece unknown penalty (min_score − 10) and consecutive-unknown
    fusing — verified token-for-token against the `tokenizers` library's
    Unigram model in tests/test_tokenizers.py;
  * T5 special ids: <pad>=0 (also the padding filler), </s>=1 appended,
    <unk>=2.

Outputs fixed-length id arrays matching
`tokenizer(..., padding="max_length", max_length=256)` semantics the SD3
pipeline uses.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2
SPM_SPACE = "▁"  # ▁
T5_MAX_LEN = 256  # SD3 pipeline max_sequence_length default


def _parse_spiece_model(path: str) -> List[Tuple[str, float]]:
    """Minimal protobuf parse of a sentencepiece ModelProto: we only need
    field 1 (repeated SentencePiece{piece:1 string, score:2 float})."""
    with open(path, "rb") as f:
        data = f.read()

    def read_varint(buf, i):
        shift = 0
        val = 0
        while True:
            b = buf[i]
            i += 1
            val |= (b & 0x7F) << shift
            if not b & 0x80:
                return val, i
            shift += 7

    def read_fields(buf):
        i = 0
        while i < len(buf):
            tag, i = read_varint(buf, i)
            field, wire = tag >> 3, tag & 7
            if wire == 0:
                val, i = read_varint(buf, i)
            elif wire == 1:
                val, i = buf[i : i + 8], i + 8
            elif wire == 2:
                ln, i = read_varint(buf, i)
                val, i = buf[i : i + ln], i + ln
            elif wire == 5:
                val, i = buf[i : i + 4], i + 4
            else:  # groups unused by sentencepiece
                raise ValueError(f"unsupported wire type {wire}")
            yield field, wire, val

    import struct

    pieces: List[Tuple[str, float]] = []
    for field, wire, val in read_fields(data):
        if field == 1 and wire == 2:  # SentencePiece message
            piece, score = "", 0.0
            for f2, w2, v2 in read_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
            pieces.append((piece, score))
    return pieces


def _load_tokenizer_json(path: str) -> List[Tuple[str, float]]:
    with open(path) as f:
        spec = json.load(f)
    model = spec["model"]
    if model.get("type") != "Unigram":
        raise ValueError(f"expected a Unigram tokenizer.json, got {model.get('type')}")
    return [(p, float(s)) for p, s in model["vocab"]]


class T5Tokenizer:
    """Unigram (sentencepiece) tokenizer with T5 conventions."""

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: int = UNK_ID):
        self.vocab = {piece: (i, score) for i, (piece, score) in enumerate(vocab)}
        self.unk_id = unk_id
        scores = [s for _, s in vocab]
        self.min_score = min(scores) if scores else 0.0
        self.unk_penalty = self.min_score - 10.0
        self.max_piece_len = max((len(p) for p, _ in vocab), default=1)

    @classmethod
    def load(cls, assets_dir: str) -> "T5Tokenizer":
        tj = os.path.join(assets_dir, "tokenizer.json")
        if os.path.exists(tj):
            return cls(_load_tokenizer_json(tj))
        sp = os.path.join(assets_dir, "spiece.model")
        if os.path.exists(sp):
            return cls(_parse_spiece_model(sp))
        raise FileNotFoundError(
            f"no tokenizer.json or spiece.model under {assets_dir}"
        )

    def _viterbi(self, word: str) -> List[int]:
        """Best segmentation of one pre-token (sentencepiece lattice)."""
        n = len(word)
        best = [float("-inf")] * (n + 1)
        back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            # known pieces
            for j in range(i + 1, min(n, i + self.max_piece_len) + 1):
                entry = self.vocab.get(word[i:j])
                if entry is None:
                    continue
                s = best[i] + entry[1]
                if s > best[j]:
                    best[j] = s
                    back[j] = (i, entry[0])
            # single-char unknown fallback
            j = i + 1
            s = best[i] + self.unk_penalty
            if s > best[j]:
                best[j] = s
                back[j] = (i, None)  # None = unk
        ids: List[int] = []
        i = n
        while i > 0:
            prev, tid = back[i]
            ids.append(self.unk_id if tid is None else tid)
            i = prev
        ids.reverse()
        # fuse consecutive unknowns (sentencepiece/tokenizers fuse_unk)
        fused: List[int] = []
        for t in ids:
            if t == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(t)
        return fused

    def encode_text(self, text: str) -> List[int]:
        """ids without EOS.

        Matches T5TokenizerFast's pipeline for the characters its
        Replace-normalizer handles: runs of ASCII spaces collapse to one
        (tabs/newlines do NOT — they flow into the lattice as raw chars,
        usually <unk>), then Metaspace with prepend_scheme="always": every
        space becomes a "▁" attached to the following characters, so a
        trailing space yields a lone "▁" token. (The precompiled-charsmap
        NFKC step of the real normalizer is not replicated — ASCII prompts
        are unaffected.)"""
        if not text:
            return []
        text = re.sub(r" {2,}", " ", text)
        if not text.startswith(" "):
            text = " " + text
        marked = text.replace(" ", SPM_SPACE)
        ids: List[int] = []
        for seg in marked.split(SPM_SPACE)[1:]:
            ids.extend(self._viterbi(SPM_SPACE + seg))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = T5_MAX_LEN) -> np.ndarray:
        out = np.full((len(texts), max_length), PAD_ID, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode_text(t)[: max_length - 1] + [EOS_ID]
            out[i, : len(ids)] = ids
        return out


def load_t5_tokenizer(assets_dir: Optional[str]) -> Optional[T5Tokenizer]:
    """T5Tokenizer when assets exist, else None (the SD3 pipeline runs its
    CLIP-only path when ids_t5 is None)."""
    if not assets_dir:
        return None
    try:
        return T5Tokenizer.load(assets_dir)
    except FileNotFoundError:
        return None
