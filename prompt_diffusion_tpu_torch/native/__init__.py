"""The native (C++) batch image decoder, bound with ctypes.

`loader.cpp` is a byte-for-byte copy of `prompt_diffusion_tpu/native/
loader.cpp` (the port imports nothing of the JAX package;
`tests/test_torch_native_loader.py` holds the copy against its original):
JPEG and PNG decode (libjpeg, libpng), a bilinear resize with PIL's
antialiasing taps and the normalisation, over threads, behind a C ABI. It
is built at first use with the JAX package's command

    g++ -O3 -funroll-loops -shared -fPIC -std=c++17 loader.cpp -ljpeg -lpng

into `build/native/libpdloader.so` at the root of the checkout (not beside
the source), and rebuilt when the source is newer. A failed build raises
`NativeBuildError` with the compiler's output: the caller chose the native
decoder (`BatchLoader(decoder="native")`, `--loader native`), so nothing
switches to PIL behind its back (`decoder="pil"` is the other choice).
The entries' default, `--loader auto`, is resolved once at start-up by
`choose_decoder`: native where the decoder builds and loads on this host,
else PIL, and the choice and its reason are printed.

    load_batch(paths, res, to_m11=False, n_threads=8) -> (N, res, res, 3) f32

A file the decoder cannot read (another format behind a .jpg name, which
PIL sniffs) is decoded by PIL alone, as the JAX package does; a corrupt
file then raises from PIL with its name.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "loader.cpp")
SO = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native", "libpdloader.so")
FLAGS = ("-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The decoder did not build: the compiler's command and output."""


def build(src: str = SRC, so: str = SO, force: bool = False) -> str:
    """Compiles `src` into `so` unless `so` is newer (or `force`); returns
    its path. The library is written beside its final name and renamed
    into place, so ranks that build at once never load a half-written
    file."""
    if not force and os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    cmd = ["g++", *FLAGS, src, "-ljpeg", "-lpng", "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:  # no compiler at all
        os.unlink(tmp)
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(f"{' '.join(cmd)} exited {r.returncode}:\n{r.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded decoder, built at first use (raises `NativeBuildError`).
    A library that does not load here (built on another machine, against
    libraries this one lacks) is built again."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(build())
            except OSError:
                lib = ctypes.CDLL(build(force=True))
            lib.pd_decode_resize_batch.restype = ctypes.c_int
            lib.pd_decode_resize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
    return _lib


def choose_decoder(choice: str, log=print) -> str:
    """`--loader`'s choice as a `BatchLoader` decoder: "native" or "pil"
    as given (a native decoder that does not build then raises at first
    use); "auto" is "native" where the decoder builds and loads here, else
    "pil", and `log` says which and why."""
    if choice != "auto":
        return choice
    try:
        get_lib()
    except (NativeBuildError, OSError) as e:
        log(f"--loader auto: the native decoder does not build on this host, so the batches "
            f"decode with PIL: {e}")
        return "pil"
    log("--loader auto: the batches decode with the native decoder")
    return "native"


def load_batch(paths: Sequence[str], res: int, to_m11: bool = False, n_threads: int = 8,
               dct_scale: bool = True) -> np.ndarray:
    """Decode, resize and normalise a batch of image files to (N, res, res,
    3) float32 in [0, 1] (or [-1, 1] with `to_m11`).

    n_threads defaults to 8: a cgroup-limited machine reports
    hardware_concurrency() == 1 while having more usable cores. dct_scale
    decodes a large JPEG at a reduced n/8 DCT scale first (disable it for
    PIL's resampling exactly)."""
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, res, res, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    flags = np.zeros(n, np.int32)
    rc = lib.pd_decode_resize_batch(
        arr, n, res, int(to_m11),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
        int(dct_scale), flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if rc != 0:
        bad = np.nonzero(flags)[0]
        out[bad] = load_batch_pil([paths[i] for i in bad], res, to_m11)
    return out


def load_batch_pil(paths: Sequence[str], res: int, to_m11: bool = False) -> np.ndarray:
    """The same batch through PIL (the per-file path, and `decoder="pil"`'s
    arithmetic)."""
    from PIL import Image

    out = np.empty((len(paths), res, res, 3), np.float32)
    for i, p in enumerate(paths):
        img = Image.open(p).convert("RGB").resize((res, res), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        out[i] = arr * 2 - 1 if to_m11 else arr
    return out
