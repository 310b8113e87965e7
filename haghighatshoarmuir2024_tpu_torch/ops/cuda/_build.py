"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` files (``csrc/*.cuh`` are headers they share) compile
into one shared library with a plain C interface, at first use, with
``nvcc`` for ``sm_90a``: one compiler process per source, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <source>.o csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/hm_kernels_<hash>.so *.o

The library lands in ``haghighatshoarmuir2024_tpu_torch/build/`` (git-ignored),
named by a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one loads at once.  It is loaded with ``ctypes``; pointers and the
stream pass as ``c_void_p``.  Nothing here depends on PyTorch's headers.

``launch_counts`` counts kernel launches by name; each wrapper adds one where
it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "hm_rzcc_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "hm_rzcc_rows_per_block": ([], _I),
    "hm_rzcc_k1": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "hm_rzcc_k2": ([_P] * 8 + [_I] * 5 + [_P], _I),
    "hm_suppress_k7": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "hm_probe_p1": ([_P, _P, _L] + [_I] * 4 + [_P], _I),
    "hm_probe_p2": ([_P, _P] + [_I] * 4 + [_P], _I),
    "hm_probe_p3_max_channels": ([], _I),
    "hm_probe_p3": ([_P] * 7 + [_I] * 5 + [_P], _I),
    "hm_lif_max_channels": ([], _I),
    "hm_lif_max_rec_neurons": ([], _I),
    "hm_lif_launch_shape": ([_I] * 4 + [_P], None),
    "hm_lif_pack_bipolar": ([_P] * 5 + [_I] * 4 + [_P], _I),
    "hm_lif_count_bipolar": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "hm_lif_count_stateful_bipolar": ([_P] * 14 + [_I] * 7 + [_P], _I),
    "hm_lif_max_raster_channels": ([], _I),
    "hm_lif_pack_raster": ([_P] * 2 + [_I] * 4 + [_P], _I),
    "hm_lif_count": ([_P] * 6 + [_I] * 8 + [_P], _I),
    "hm_lif_count_stateful": ([_P] * 12 + [_I] * 8 + [_P], _I),
    "hm_iir_lifted_scratch": ([_I] * 5, _L),
    "hm_iir_lifted": ([_P] * 16 + [_I] * 7 + [_P], _I),
    "hm_matched_max_k": ([], _I),
    "hm_matched": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "hm_iir_scan_constants": ([_P], None),
    "hm_iir_scan": ([_P] * 5 + [_I, _L, _I, _I, _I] + [_L] * 6 + [_I, _I, _P], _I),
    "hm_xylo_sim_constants": ([_P], None),
    "hm_xylo_sim": ([_P] * 15 + [_I] * 10 + [_P], _I),
    "hm_xylo_sim_onchip": ([_P] * 15 + [_I] * 12 + [_P], _I),
    "hm_barrier_probe": ([_I] * 4 + [_P, _P], _I),
    "hm_envelope_constants": ([_P], None),
    "hm_envelope": ([_P] * 4 + [_D, _D, _L, _I, _I, _P], _I),
    "hm_envelope_chain": ([_P, _D, _D, _I, _I, _P, _P, _P], _I),
    "hm_envelope_plan": ([_L, _I, _I, _P, _P, _P], _I),
    "hm_track_constants": ([_P], None),
    "hm_track_angles": ([_P, _P, _I, _I, _I, _F, _F, _F, _P], _I),
    "hm_track_multi": ([_P] * 4 + [_I] * 6 + [_F] * 4 + [_P], _I),
    "hm_wrap_chain": ([_F, _F, _I, _I, _P, _P, _P], _I),
    "hm_wrap_apply": ([_P, _P, _L, _I, _P], _I),
    "hm_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _headers():
    return sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"hm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path.  The compilers' reports (registers, shared memory, spills) are kept
    beside it as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for obj, src in zip(objs, _sources())]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
        failed = []
        for cmd, proc in zip(cmds, procs):
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out[-4000:])
        if not failed:
            tmp_so = Path(tmp) / so.name
            cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp_so), *map(str, objs)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout)
            if proc.returncode != 0:
                failed.append(proc.stdout[-4000:])
            else:
                os.replace(tmp_so, so)
    so.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def library_constants(name: str, n: int) -> tuple[int, ...]:
    """The ``n`` ints the library's ``name`` writes: the constants of a
    source that its wrapper mirrors, for the wrapper to hold its own to."""
    out = (ctypes.c_int * n)()
    getattr(library(), name)(ctypes.addressof(out))
    return tuple(out)


def check(rc: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = library().hm_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Validate a tensor handed to a kernel: device, dtype, rank, layout."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes} (got {t.dtype})")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D (got shape {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
