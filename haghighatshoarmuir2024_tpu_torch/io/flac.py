"""FLAC reading by the repository's C++ decoder ``native/flacdec.cpp``
(counterpart of ``haghighatshoarmuir2024_tpu/io/flac.py``).

The decoder is built with g++ at first use into the git-ignored
``native/build/``, named by a hash of its source, and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "flacdec.cpp"
_BUILD_DIR = _REPO_ROOT / "native" / "build"


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    so = _BUILD_DIR / f"libflacdec_{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=_BUILD_DIR, suffix=".so", delete=False) as tmp:
            tmp_path = Path(tmp.name)
        proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp_path), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp_path.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {_SRC.name} ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp_path, so)
    lib = ctypes.CDLL(str(so))
    i, i32p = ctypes.c_int, ctypes.POINTER(ctypes.c_int32)
    lib.flac_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(i32p), ctypes.POINTER(ctypes.c_long),
                                ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.flac_decode.restype = i
    lib.flac_free.argtypes = [i32p]
    lib.flac_free.restype = None
    return lib


def read_flac(path: str, normalize: bool = True) -> Tuple[np.ndarray, float]:
    """Decode a FLAC file → ((n_samples, n_channels) float64 in [-1, 1] when
    ``normalize``, else the raw int32 samples; the sample rate)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_int32)()
    ns, nc, sr, bits = ctypes.c_long(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.flac_decode(str(path).encode(), ctypes.byref(out), ctypes.byref(ns), ctypes.byref(nc),
                         ctypes.byref(sr), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"FLAC decode failed for {path!r} (error {rc})")
    try:
        data = np.ctypeslib.as_array(out, shape=(ns.value * nc.value,)).reshape(ns.value, nc.value).copy()
    finally:
        lib.flac_free(out)
    if normalize:
        data = data.astype(np.float64) / float(2 ** (bits.value - 1))
    return data, float(sr.value)
