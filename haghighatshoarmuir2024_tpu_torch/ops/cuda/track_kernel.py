"""The two DoA trackers on the card: the wrappers of ``csrc/tracking.cu``,
the routes :func:`utils.tracking.track_angles` and
:func:`utils.tracking.track_multi_angles` take for a tensor off the CPU.

Each runs all T frames of its plain loop (:func:`utils.tracking.
track_angles_plain`, :func:`utils.tracking.track_multi_angles_plain`) in one
launch, a thread a lane of the batch, and equals it bit for bit (the angles,
and ``confirmed``).  They replace no TPU kernel: the JAX package runs each
tracker as one ``lax.scan`` (``haghighatshoarmuir2024_tpu/utils/tracking.py:155``
and ``:400``).  The plain loops' Python scalars (``alpha``, ``beta``, the
gate, pi) reach PyTorch's kernels rounded to float32, so the wrappers pass
them rounded so (:func:`float32`).

On CPU tensors both run the plain loop; on any other device they launch
the kernel or raise.

Two probes of the kernels' ``wrap`` (``atan2f(sinf(x), cosf(x))`` as
``atan2f`` of ``sincosf``'s pair) measure it on the card: :func:`wrap_chain` (one thread's chain of wraps between two
``clock64`` reads: its latency) and :func:`wrap_apply` (the wrap of every
value of a tensor: its bits against PyTorch's ``atan2(sin x, cos x)``).
"""
from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from ...utils import tracking
from ._build import check, launch_counts, library, library_constants, stream_handle

# csrc/tracking.cu's THREADS (lanes a block), M_MAX (track slots) and K_MAX (measurements a frame), as
# hm_track_constants gives them
TRACK_THREADS, M_MAX, K_MAX = 128, 16, 16
INT32 = np.iinfo(np.int32)
# the probes' forms (csrc/tracking.cu wrap_form): the plain loops' three functions, the kernels' wrap (atan2f of
# sincosf's pair), and the chain of each function alone
WRAP_FORMS = {"atan2f(sinf, cosf)": 0, "wrap": 1, "sinf": 2, "cosf": 3, "atan2f": 4}


@functools.lru_cache(maxsize=1)
def checked_library():
    """The kernel library, once its constants are held equal to this
    module's (``TRACK_THREADS``, ``M_MAX``, ``K_MAX``)."""
    got = library_constants("hm_track_constants", 3)
    if got != (TRACK_THREADS, M_MAX, K_MAX):
        raise RuntimeError(f"csrc/tracking.cu's constants {got} differ from track_kernel's "
                           f"{(TRACK_THREADS, M_MAX, K_MAX)}")
    return library()


def float32(v: float) -> float:
    """``v`` rounded to float32, as a PyTorch kernel on a float32 tensor
    takes a Python float."""
    return float(np.float32(v))


def _int32(v, name: str) -> int:
    v = operator.index(v)
    if not INT32.min <= v <= INT32.max:
        raise ValueError(f"{name} {v} is outside int32")
    return v


def _require_card(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} on the card takes float32 angles (got {t.dtype})")
    if t.device.type != "cuda":
        raise ValueError(f"{name}'s kernel runs on CUDA tensors (got {t.device})")


def track_angles(angles: torch.Tensor, alpha: float = 0.35, beta=None, gate_deg: float = 25.0,
                 max_misses: int = 3) -> torch.Tensor:
    """:func:`utils.tracking.track_angles_plain` by the kernel: ``angles``
    (T, ...) float32 on the card, the filtered angles of the same shape, one
    launch for all T frames.  Raises ``TypeError`` for another dtype and
    ``ValueError`` for a tensor off the card."""
    if angles.device.type == "cpu":
        return tracking.track_angles_plain(angles, alpha=alpha, beta=beta, gate_deg=gate_deg,
                                           max_misses=max_misses, device=angles.device)
    if angles.dim() == 0:
        raise ValueError("track_angles takes a (T, ...) sequence (got a scalar)")
    _require_card(angles, "track_angles")
    misses = _int32(max_misses, "max_misses")
    lib = checked_library()
    T = angles.shape[0]
    z = angles.reshape(T, -1).contiguous()
    L = z.shape[1]
    if T == 0 or L == 0:
        return angles.clone()
    out = torch.empty_like(z)
    gate = float(np.deg2rad(gate_deg))
    rc = lib.hm_track_angles(z.data_ptr(), out.data_ptr(), T, L, misses, float32(alpha),
                             float32(tracking._beta(alpha, beta)), float32(gate), stream_handle(angles.device))
    check(rc, "track_angles")
    launch_counts["track_angles"] += 1
    return out.reshape(angles.shape)


def track_multi(z_seq: torch.Tensor, valid_seq: torch.Tensor, num_tracks: int, alpha: float = 0.35, beta=None,
                gate_deg: float = 25.0, max_misses: int = 3, confirm_hits: int = 2):
    """:func:`utils.tracking.track_multi_angles_plain` by the kernel:
    ``z_seq`` (T, ..., K) float32 and ``valid_seq`` (broadcast to it) on the
    card, ``(thetas (T, ..., M), confirmed (T, ..., M))``, one launch for all
    T frames.  Raises ``TypeError`` for another dtype and ``ValueError`` for
    no frame, M or K outside 1-16, or a tensor off the card."""
    if z_seq.device.type == "cpu":
        return tracking.track_multi_angles_plain(z_seq, valid_seq, num_tracks, alpha=alpha, beta=beta,
                                                 gate_deg=gate_deg, max_misses=max_misses,
                                                 confirm_hits=confirm_hits, device=z_seq.device)
    if z_seq.dim() < 2:
        raise ValueError(f"track_multi_angles takes a (T, ..., K) sequence (got shape {tuple(z_seq.shape)})")
    M, K = operator.index(num_tracks), z_seq.shape[-1]
    if not 1 <= M <= M_MAX:
        raise ValueError(f"the tracking kernel takes 1 to {M_MAX} track slots (got {M})")
    if not 1 <= K <= K_MAX:
        raise ValueError(f"the tracking kernel takes 1 to {K_MAX} measurements a frame (got {K})")
    if z_seq.shape[0] == 0:
        raise ValueError("track_multi_angles needs at least one frame")
    _require_card(z_seq, "track_multi_angles")
    misses, hits = _int32(max_misses, "max_misses"), _int32(confirm_hits, "confirm_hits")
    lib = checked_library()
    T, lanes = z_seq.shape[0], z_seq.shape[1:-1]
    z = z_seq.reshape(T, -1, K).contiguous()
    valid = torch.broadcast_to(valid_seq.to(device=z_seq.device, dtype=torch.bool), z_seq.shape).reshape(z.shape)
    valid = valid.contiguous()
    L = z.shape[1]
    thetas = torch.empty((T, L, M), dtype=torch.float32, device=z.device)
    confirmed = torch.empty((T, L, M), dtype=torch.bool, device=z.device)
    if L:
        gate = float(np.deg2rad(gate_deg))
        rc = lib.hm_track_multi(z.data_ptr(), valid.data_ptr(), thetas.data_ptr(), confirmed.data_ptr(), T, L, M, K,
                                misses, hits, float32(alpha), float32(tracking._beta(alpha, beta)), float32(gate),
                                float32(np.pi), stream_handle(z.device))
        check(rc, "track_multi")
        launch_counts["track_multi"] += 1
    shape = (T,) + tuple(lanes) + (M,)
    return thetas.reshape(shape), confirmed.reshape(shape)


def wrap_chain(x0: float, c: float, n: int, form: str = "wrap", device=None) -> tuple[float, int]:
    """``(x, cycles)``: one thread on the card runs ``x = form(x + c)`` ``n``
    times from ``x0`` (``WRAP_FORMS``), ``cycles`` the ``clock64`` cycles of
    the chain (each step one float32 add more than the form)."""
    lib = checked_library()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    rc = lib.hm_wrap_chain(float32(x0), float32(c), _int32(n, "n"), WRAP_FORMS[form], out.data_ptr(),
                           cycles.data_ptr(), stream_handle(dev))
    check(rc, "wrap_chain")
    launch_counts["wrap_chain"] += 1
    return float(out.item()), int(cycles.item())


def wrap_apply(x: torch.Tensor, form: str = "wrap") -> torch.Tensor:
    """The kernels' wrap (or ``"atan2f(sinf, cosf)"``) of every value of
    the float32 CUDA tensor ``x``."""
    if x.dtype != torch.float32 or x.device.type != "cuda":
        raise ValueError(f"wrap_apply takes a float32 CUDA tensor (got {x.dtype} on {x.device})")
    if WRAP_FORMS[form] > 1:
        raise ValueError(f"wrap_apply applies a wrap form ('wrap' or 'atan2f(sinf, cosf)'), not {form!r}")
    lib = checked_library()
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        check(lib.hm_wrap_apply(x.data_ptr(), y.data_ptr(), x.numel(), WRAP_FORMS[form], stream_handle(x.device)),
              "wrap_apply")
        launch_counts["wrap_apply"] += 1
    return y
