"""The native producer clients (counterpart of
``haghighatshoarmuir2024_tpu/runtime/native_client.py``): ctypes bindings of
``native/streamc.cpp``, the producer side of the serving daemon in C++.

TCP framing, the ``/dev/shm`` ring and the stateful wire encoder (the
anti-aliased decimation and mu-law companding) run in C, so a co-located
producer's loop hands Python only a buffer pointer.  The classes mirror
:class:`runtime.server.StreamClient`, :class:`ShmStreamClient` and
:class:`WireEncoder`: the encoder's codes equal ``WireEncoder``'s byte for
byte, and its decimated float wire agrees within float rounding.  The
reference has no serving client: audio enters in-process
(micloc/record.py:54-60).

The library is built with g++ at first use into ``native/build/``
(git-ignored), named by a hash of the source, as the daemon's is
(``runtime/server._load``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..ops.resample import design_upsample_fir

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "streamc.cpp"
_BUILD_DIR = _REPO_ROOT / "native" / "build"

_DTYPE_CODE = {"f32": 0, "i16": 1, "u8": 2, "u4": 3}
_DTYPE_NP = {"f32": np.float32, "i16": np.int16, "u8": np.uint8, "u4": np.uint8}


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    """Build ``native/streamc.cpp`` at first use and bind its C interface."""
    so = _BUILD_DIR / f"libstreamc_{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"
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
    u32, u32p, f32p, vp, i = (ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_float),
                              ctypes.c_void_p, ctypes.c_int)
    for name, args, res in (
        ("sc_connect", [ctypes.c_char_p, ctypes.c_uint16, u32], i),
        ("sc_send_frame", [i, vp, u32, u32], i),
        ("sc_recv_doas", [i, u32p, f32p, u32, i], i),
        ("sc_close", [i], None),
        ("sc_shm_create", [ctypes.c_char_p, u32], vp),
        ("sc_shm_send", [vp, vp, u32, i], i),
        ("sc_shm_recv_doas", [vp, f32p, u32, i], i),
        ("sc_shm_close", [vp, i], None),
        ("sc_encoder_new", [i, i, i, f32p, i], vp),
        ("sc_encoder_encode", [vp, f32p, i, vp], i),
        ("sc_encoder_free", [vp], None),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


class NativeWireEncoder:
    """C twin of :class:`runtime.server.WireEncoder` for chunks of
    ``n_ch`` channels: carried anti-alias history, the same codes byte for
    byte, and with ``wire_upsample=4`` the same decimated waveform within
    float rounding."""

    def __init__(self, wire_dtype: str = "f32", wire_upsample: int = 1, n_ch: int = 1):
        if wire_dtype not in _DTYPE_CODE:
            raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
        self._lib = _load()
        self.wire_dtype = wire_dtype
        self.up = int(wire_upsample)
        self.n_ch = int(n_ch)
        taps, ntaps = None, 0
        if self.up > 1:
            self._taps = np.ascontiguousarray(design_upsample_fir(self.up) / np.float32(self.up), np.float32)
            taps, ntaps = self._taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self._taps.size
        self._h = self._lib.sc_encoder_new(_DTYPE_CODE[wire_dtype], self.up, self.n_ch, taps, ntaps)
        if not self._h:
            raise ValueError("sc_encoder_new rejected the configuration")

    def encode(self, chunk: np.ndarray) -> np.ndarray:
        """A (T, n_ch) float block in [-1, 1] → its wire rows."""
        x = np.ascontiguousarray(chunk, np.float32)
        if x.ndim != 2 or x.shape[1] != self.n_ch:
            raise ValueError(f"chunk must be (T, {self.n_ch}); got {x.shape}")
        out = np.empty(x.size * 4, np.uint8)
        n = self._lib.sc_encoder_encode(self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.shape[0],
                                        out.ctypes.data_as(ctypes.c_void_p))
        if n < 0:
            raise ValueError("sc_encoder_encode failed: the chunk length must divide by the upsample factor "
                             "(and by 2 more on the u4 wire)")
        Tw = x.shape[0] // self.up
        rows = Tw // 2 if self.wire_dtype == "u4" else Tw
        return out[:n].view(_DTYPE_NP[self.wire_dtype]).reshape(rows, self.n_ch)

    def close(self):
        if self._h:
            self._lib.sc_encoder_free(self._h)
            self._h = None


class NativeStreamClient:
    """C twin of :class:`runtime.server.StreamClient` (TCP framing in C).
    ``sources`` must be the server's: a result frame is ``u32 id + f32[K]``."""

    def __init__(self, port: int, stream_id: int, host: str = "127.0.0.1", sources: int = 1):
        self._lib = _load()
        self.K = int(sources)
        self.fd = self._lib.sc_connect(host.encode(), port, stream_id)
        if self.fd < 0:
            raise OSError("streamc: connect or hello failed")

    def send(self, chunk: np.ndarray):
        """Send a (T, M) block in the server's wire dtype."""
        data = np.ascontiguousarray(chunk)
        if data.dtype not in (np.float32, np.int16, np.uint8):
            data = data.astype(np.float32)
        if self._lib.sc_send_frame(self.fd, data.ctypes.data_as(ctypes.c_void_p), data.size, data.dtype.itemsize):
            raise OSError("streamc: send failed")

    def recv_doa(self, timeout: float = 30.0):
        """The next result: ``(stream_id, doa)``, or for K > 1
        ``(stream_id, (K,) float32 array)``, NaN-padded."""
        sid = ctypes.c_uint32(0)
        doas = (ctypes.c_float * self.K)()
        if self._lib.sc_recv_doas(self.fd, ctypes.byref(sid), doas, self.K, int(timeout * 1000)):
            raise ConnectionError("streamc: receive timed out or the server closed")
        return (sid.value, doas[0]) if self.K == 1 else (sid.value, np.asarray(doas[:], np.float32))

    def close(self):
        if self.fd >= 0:
            self._lib.sc_close(self.fd)
            self.fd = -1


class NativeShmClient:
    """C twin of :class:`runtime.server.ShmStreamClient` (the ring's
    operations in C).  Attach it with ``server.attach_shm(stream_id,
    client.name)``."""

    def __init__(self, name: str, capacity_bytes: int = 1 << 22):
        self._lib = _load()
        self.name = name
        self._h = self._lib.sc_shm_create(name.encode(), capacity_bytes)
        if not self._h:
            raise OSError("streamc: shm create failed")

    def send(self, chunk: np.ndarray, timeout: float = 30.0):
        """Append a (T, M) block in the server's wire dtype; waits while the
        ring is full."""
        data = np.ascontiguousarray(chunk)
        if self._lib.sc_shm_send(self._h, data.ctypes.data_as(ctypes.c_void_p), data.nbytes, int(timeout * 1000)):
            raise TimeoutError("streamc: shm ring full, consumer not draining")

    def recv_doa(self, timeout: float = 30.0, sources: int = 1):
        """The newest DoA once a new result is posted; with ``sources=K`` > 1
        a (K,) NaN-padded array."""
        doas = (ctypes.c_float * sources)()
        if self._lib.sc_shm_recv_doas(self._h, doas, sources, int(timeout * 1000)):
            raise TimeoutError("streamc: no shm result")
        return doas[0] if sources == 1 else np.asarray(doas[:], np.float32)

    def close(self, unlink: bool = True):
        if self._h:
            self._lib.sc_shm_close(self._h, 1 if unlink else 0)
            self._h = None
