"""The `.safetensors` format, read and written with torch alone.

A file is an 8-byte little-endian header length n, n bytes of JSON, then
the raw little-endian bytes of every tensor. The header maps each name to
{"dtype", "shape", "data_offsets": [begin, end]} (offsets into the data
section), plus an optional "__metadata__" of strings. Files written here
are those of the `safetensors` package byte for byte: tensors ordered by
dtype (the package's enum, largest first) and then by name, the JSON
without spaces, the header padded with spaces to a multiple of 8 bytes.

Reading checks what the package checks: a known dtype, offsets that match
each shape, and tensors that tile the data section from 0 to its end with
no overlap or gap. The file is mapped, not read: a tensor whose offset
suits its dtype is a view of the mapping (copy-on-write), any other one a
copy.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict, Mapping, Optional

import torch

# name -> (dtype, rank in the package's `Dtype` enum, which orders the data)
DTYPES = {
    "BOOL": (torch.bool, 0),
    "U8": (torch.uint8, 4),
    "F16": (torch.float16, 11),
    "BF16": (torch.bfloat16, 12),
    "I32": (torch.int32, 13),
    "F32": (torch.float32, 15),
    "I64": (torch.int64, 18),
}
_NAMES = {dt: name for name, (dt, _) in DTYPES.items()}
_MAX_HEADER = 100_000_000


def _check_host():
    if sys.byteorder != "little":
        raise RuntimeError("safetensors_io reads and writes little-endian bytes on a "
                           "little-endian host only")


def _header(path: str):
    """(header dict, data section's offset in the file, file size)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", raw)
        if n > _MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header length {n} does not fit a {size}-byte file")
        header = json.loads(f.read(n).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    return header, 8 + n, size


def _entries(header: dict, data_len: int, path: str):
    """[(name, dtype, shape, begin, end)] in file order, checked."""
    out = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info.get("dtype") not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has an unknown dtype {info.get('dtype')!r}")
        dtype = DTYPES[info["dtype"]][0]
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * dtype.itemsize or begin > end:
            raise ValueError(f"{path}: tensor {name!r}: offsets {begin}..{end} do not hold "
                             f"shape {shape} of {info['dtype']}")
        out.append((name, dtype, shape, begin, end))
    out.sort(key=lambda e: (e[3], e[4]))
    pos = 0
    for name, _, _, begin, end in out:
        if begin != pos:
            raise ValueError(f"{path}: tensor {name!r} starts at {begin}, not at {pos}: the "
                             "offsets overlap or leave a gap")
        pos = end
    if pos != data_len:
        raise ValueError(f"{path}: the tensors end at byte {pos} of a {data_len}-byte data "
                         "section")
    return out


def load_file(path: str, device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    """{name: tensor} in the file's order of names; on `device` (a copy)
    unless it is the CPU (views of the mapped file where aligned)."""
    _check_host()
    header, start, size = _header(path)
    entries = _entries(header, size - start, path)
    storage = torch.UntypedStorage.from_file(path, shared=False, nbytes=size)
    data = torch.empty(0, dtype=torch.uint8).set_(storage, 0, (size,))
    out = {}
    for name, dtype, shape, begin, end in entries:
        raw = data[start + begin:start + end]
        if (start + begin) % dtype.itemsize:
            raw = raw.clone()
        t = raw.view(dtype).reshape(shape)
        out[name] = t if torch.device(device).type == "cpu" else t.to(device)
    return {name: out[name] for name in header if name != "__metadata__"}


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Writes `tensors` (any device; each written from a contiguous CPU
    copy) with string `metadata`."""
    _check_host()
    if metadata is not None and not all(isinstance(k, str) and isinstance(v, str)
                                        for k, v in metadata.items()):
        raise ValueError("safetensors metadata must map strings to strings")
    items = []
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name here "
                             f"(one of {sorted(DTYPES)})")
        items.append((name, t))
    items.sort(key=lambda it: (-DTYPES[_NAMES[it[1].dtype]][1], it[0]))
    header = {}
    if metadata is not None:
        header["__metadata__"] = {k: metadata[k] for k in sorted(metadata)}
    pos = 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + n]}
        pos += n
    blob = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            flat = t.detach().to("cpu").contiguous().reshape(-1)
            f.write(memoryview(flat.view(torch.uint8).numpy()))
