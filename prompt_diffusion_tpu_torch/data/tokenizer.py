"""CLIP BPE tokenizer (host-side, pure Python), for the PyTorch port.

A copy of `prompt_diffusion_tpu/data/tokenizer.py` (the port imports
nothing of the JAX package; `tests/test_torch_serving.py` holds the two
against each other on the same strings):

  * `CLIPTokenizer` implements CLIP's byte-pair encoding and loads
    `vocab.json` + `merges.txt` from a local path (the files HF ships).
  * `HashTokenizer` is a deterministic stand-in for tests and benchmarks
    when no vocab assets exist: it maps words to stable ids in the vocab
    range. It is NOT linguistically meaningful.

Both produce fixed-length (77) id arrays with CLIP's 49406/49407
start/end tokens and end-token padding (`padding="max_length"`).
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import List, Optional, Sequence

import numpy as np

SOT = 49406
EOT = 49407
MAX_LEN = 77


def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


# HF CLIPTokenizer's exact word pattern needs \p{L}/\p{N} classes (the
# third-party `regex` module, a transformers dependency). Fall back to an
# ASCII approximation only if it is absent — the ASCII classes split
# accented/CJK letters into the punctuation branch, changing BPE
# boundaries on non-English prompts.
try:
    import regex as _regex

    _WORD_RE = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    _WORD_RE = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE,
    )


# CJK ranges of transformers BasicTokenizer._is_chinese_char: the
# reference env pins transformers==4.19.2 WITHOUT ftfy
# (environment.yaml:23), so its CLIPTokenizer._tokenize takes the
# BasicTokenizer fallback, which space-pads each CJK char into its own
# word before the BPE word regex runs. Reproduce that here for id parity.
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _space_cjk(text: str) -> str:
    if all(ord(c) < 0x3400 for c in text):  # fast path: no CJK
        return text
    return "".join(
        f" {c} " if any(a <= ord(c) <= b for a, b in _CJK_RANGES) else c
        for c in text)


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = _space_cjk(text)
    return re.sub(r"\s+", " ", text).strip().lower()


class CLIPTokenizer:
    """BPE tokenizer compatible with openai/clip vocab assets."""

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        # real CLIP assets put these at 49406/49407; synthetic test vocabs
        # may not — always resolve from the vocab itself
        self.sot = self.encoder.get("<|startoftext|>", SOT)
        self.eot = self.encoder.get("<|endoftext|>", EOT)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        # skip header line(s)
        merges = [m for m in merges if m and not m.startswith("#")]
        if merges and merges[0].startswith("bpe_simple_vocab"):
            merges = merges[1:]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {}
        self.added_tokens: dict = {}

    def add_tokens(self, mapping: dict):
        """Register placeholder tokens (textual inversion): token text →
        list of embedding-table ids (multi-vector TI expands to several
        consecutive ids, diffusers TextualInversionLoaderMixin semantics).

        Keys are lowercased because `encode_text` matches against the
        `_basic_clean`-lowercased prompt — a mixed-case placeholder (e.g.
        an A1111 'EasyNegative' embedding) must still hit its table rows."""
        self.added_tokens.update(
            {t.lower(): list(ids) if isinstance(ids, (list, tuple)) else [ids]
             for t, ids in mapping.items()})

    @functools.lru_cache(maxsize=32768)
    def _bpe(self, token: str) -> str:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        return " ".join(word)

    def _encode_plain(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _WORD_RE.findall(text):
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token_b).split(" "))
        return ids

    def encode_text(self, text: str) -> List[int]:
        text = _basic_clean(text)
        if not self.added_tokens:
            return self._encode_plain(text)
        # split on placeholder tokens first so they bypass BPE. Boundary
        # lookarounds: a placeholder must not match INSIDE a longer word
        # ('style' must not split 'styles' — diffusers'
        # TextualInversionLoaderMixin replaces whole tokens only)
        import re as _re

        pattern = ("(?<![a-z0-9])(?:" + "|".join(
            _re.escape(t) for t in sorted(self.added_tokens, key=len, reverse=True))
            + ")(?![a-z0-9])")
        ids: List[int] = []
        for part in _re.split(f"({pattern})", text):
            if part in self.added_tokens:
                ids.extend(self.added_tokens[part])
            elif part:
                ids.extend(self._encode_plain(part))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = MAX_LEN,
                 openclip_pack: bool = False) -> np.ndarray:
        """Fixed-length id batch.

        Default packing matches HF `CLIPTokenizer(..., padding="max_length")`
        as used by the reference's FrozenCLIPEmbedder (ldm/modules/encoders/
        modules.py:99,118): end-token padding. `openclip_pack=True` matches
        `open_clip.tokenize` as used by FrozenOpenCLIPEmbedder
        (modules.py:169): ZERO padding after eot. Truncation is identical
        in both schemes (open_clip's `tokens[:n]; tokens[-1] = eot`
        reduces to keep-(n-2)-content + eot — exactly the slice below)."""
        pad = 0 if openclip_pack else self.eot
        out = np.full((len(texts), max_length), pad, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode_text(t)[: max_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic placeholder tokenizer (no vocab assets required).

    Words hash to stable ids in [1000, 49000). Only suitable for tests,
    benchmarks, and training-from-scratch experiments — NOT compatible
    with pretrained CLIP weights.
    """

    def __init__(self):
        self.added_tokens: dict = {}

    def add_tokens(self, mapping: dict):
        # lowercased keys — see CLIPTokenizer.add_tokens
        self.added_tokens.update(
            {t.lower(): list(ids) if isinstance(ids, (list, tuple)) else [ids]
             for t, ids in mapping.items()})

    def encode_text(self, text: str) -> List[int]:
        import hashlib

        ids = []
        for w in _basic_clean(text).split():
            if w in self.added_tokens:
                ids.extend(self.added_tokens[w])
                continue
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            ids.append(1000 + h % 48000)
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = MAX_LEN,
                 openclip_pack: bool = False) -> np.ndarray:
        out = np.full((len(texts), max_length),
                      0 if openclip_pack else EOT, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [SOT] + self.encode_text(t)[: max_length - 2] + [EOT]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(assets_dir: Optional[str] = None):
    """CLIPTokenizer when vocab assets exist, else HashTokenizer (with a
    loud warning — hash ids are NEVER compatible with pretrained CLIP)."""
    if assets_dir:
        vocab = os.path.join(assets_dir, "vocab.json")
        merges = os.path.join(assets_dir, "merges.txt")
        if os.path.exists(vocab) and os.path.exists(merges):
            return CLIPTokenizer(vocab, merges)
    import warnings

    warnings.warn(
        "No CLIP vocab assets found"
        + (f" under {assets_dir!r}" if assets_dir else " (no assets_dir given)")
        + " — falling back to HashTokenizer. Hash ids are deterministic but "
        "NOT CLIP BPE: do not use with pretrained weights.",
        stacklevel=2,
    )
    return HashTokenizer()
