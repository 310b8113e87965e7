"""The IIR hand kernels on the card: the wrappers of ``csrc/iir_lifted.cu``,
the route :func:`ops.iir.iir_cumsum_blocked` takes for a CUDA tensor, and of
``csrc/iir_scan.cu``, the route of :func:`ops.iir.iir_scan` (and so of
``iir_filter(method="scan")``).

``iir_lifted`` computes what :func:`ops.iir.iir_cumsum_blocked_plain`
computes, from the same float32 matrices, in two launches (three at level
1), and it replaces no TPU kernel: the JAX package leaves this to XLA.  What
it adds is one fixed order of summation for every output element, whatever
the number of columns, so a stream's encode on the card is the same alone,
in a shard or in the whole batch (the plain version's GEMMs go to cuBLAS,
whose kernel and rounding follow the call's width).

``iir_scan`` runs the per-sample transposed-DF2 recurrence of
:func:`ops.iir.iir_scan_plain` over all T steps in one launch, a thread a
real lane fed by a producer warp that does the block's global copies, and
equals it bit for bit; it replaces no TPU kernel either (JAX runs it as one
``lax.scan``), but the plain loop's four tensor ops a sample made it the
classical paths' whole cost on the card.

On CPU tensors each wrapper runs its plain version; on any other device it
launches its kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import iir
from ._build import check, launch_counts, library, library_constants, stream_handle

SB_MAX, N_MAX, K2_MAX, RT = 64, 8, 512, 8  # csrc/iir_lifted.cu's constants
# csrc/iir_scan.cu's N_MAX (state values a lane), LANES (lanes a block), TS (steps a tile) and VEC (floats a
# 16-byte copy), as hm_iir_scan_constants gives them
SCAN_N_MAX, SCAN_LANES, SCAN_TS, SCAN_VEC = 8, 32, 64, 4


@functools.lru_cache(maxsize=1)
def checked_scan_library():
    """The kernel library, once ``csrc/iir_scan.cu``'s constants are held
    equal to this module's (``SCAN_N_MAX``, ``SCAN_LANES``, ``SCAN_TS``,
    ``SCAN_VEC``): :func:`vector_rows` and the CPU tests' model of the
    kernel's copies read them."""
    want = (SCAN_N_MAX, SCAN_LANES, SCAN_TS, SCAN_VEC)
    got = library_constants("hm_iir_scan_constants", 4)
    if got != want:
        raise RuntimeError(f"csrc/iir_scan.cu's constants {got} differ from iir_kernel's {want}")
    return library()


@functools.lru_cache(maxsize=16)
def kernel_matrices(b_key, a_key, SB: int, Q: int, device: torch.device) -> dict:
    """The plain version's float32 matrices as the kernel reads them:
    ``proj`` (SB+1+N, SB), ``hout`` (SB, N), ``ablk`` (N, N) and ``hblk`` (N,)
    of the outer recurrence, and at level 2 ``tinv``, ``tm``, ``h1m``,
    ``ps``, ``hc``, ``w2`` (``WsBm2``) with ``kend``, the columns up to the
    last nonzero one of each tile of RT rows of ``w2``, and ``w2t``, ``w2``
    transposed with its rows padded with zeros to whole tiles (the kernel
    reads a tile's RT coefficients of one column as four float4s)."""
    m = iir._device_matrices(b_key, a_key, SB, Q, device)
    lvl2 = "Ws" in m
    out = dict(proj=m["proj"], hout=m["H2m" if lvl2 else "H2"], ablk=m["ASBQ" if lvl2 else "ASB"],
               hblk=m["sum_h" if lvl2 else "h1"])
    if lvl2:
        out.update(tinv=m["Tinv"], tm=m["Tm"], h1m=m["h1m"], ps=m["Ps"], hc=m["Hc"], w2=m["WsBm2"])
        nz = (out["w2"] != 0).cpu().numpy()
        tiles = -(-nz.shape[0] // RT)
        kend = [int(np.flatnonzero(nz[t * RT:(t + 1) * RT].any(axis=0)).max(initial=-1)) + 1 for t in range(tiles)]
        out["kend"] = torch.as_tensor(kend, dtype=torch.int32, device=device)
        w2t = out["w2"].new_zeros((out["w2"].shape[1], tiles * RT))
        w2t[:, :out["w2"].shape[0]] = out["w2"].T
        out["w2t"] = w2t
    return {k: v.contiguous() for k, v in out.items()}


def iir_lifted(b, a, x: torch.Tensor, zi: torch.Tensor | None = None, return_state: bool = False,
               sb: int = iir.SB):
    """``cumsum(lfilter(b, a, x), dim 0)`` of time-major ``x`` (T, ...) with
    the arguments of :func:`ops.iir.iir_cumsum_blocked`, by the kernel.
    Raises ``ValueError`` for a block above 64 samples or a state above 8."""
    if x.device.type == "cpu":
        return iir.iir_cumsum_blocked_plain(b, a, x, zi=zi, return_state=return_state, sb=sb)
    lib = library()
    if x.device.type != "cuda":
        raise ValueError(f"iir_lifted runs on CUDA tensors (got {x.device})")
    b_key, a_key, SB, N, xf = iir._lifted_args(b, a, x, return_state, sb)
    if SB > SB_MAX or N > N_MAX:
        raise ValueError(f"iir_lifted takes blocks of at most {SB_MAX} samples and states of at most {N_MAX} "
                         f"(got sb={SB}, N={N})")
    T, rest = x.shape[0], x.shape[1:]
    xf = xf.contiguous()
    L = xf.shape[1]
    nb, Q = iir.lifted_plan(N, T, SB)
    m = kernel_matrices(b_key, a_key, SB, Q, x.device)
    lvl2 = "w2" in m
    zi_t = None if zi is None else zi.to(x.device, torch.float32).reshape(L, N + 1).contiguous()
    scratch = torch.empty((lib.hm_iir_lifted_scratch(L, N, Q, nb, int(lvl2)),), dtype=torch.float32,
                          device=x.device)
    z = torch.empty((T, L), dtype=torch.float32, device=x.device)
    state = torch.empty((L, N + 1), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.hm_iir_lifted(
        xf.data_ptr(), ptr(zi_t), z.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        *(ptr(m.get(k)) for k in ("proj", "hout", "ablk", "hblk", "tinv", "tm", "h1m", "ps", "hc", "w2t", "kend")),
        T, L, SB, N, Q, nb, int(lvl2), stream_handle(x.device))
    check(rc, "iir_lifted")
    launch_counts["iir_lifted"] += 1
    z = z.reshape((T,) + rest)
    return (z, state.reshape(rest + (N + 1,))) if return_state else z


def _collapse(shape, *strides):
    """The dims of ``shape`` merged where every stride set allows it, size-1
    dims dropped: ``(sizes, [strides of each set])``."""
    dims = [(n, [st[k] for st in strides]) for k, n in enumerate(shape) if n != 1]
    out = []
    for n, st in dims:
        if out and all(p == q * n for p, q in zip(out[-1][1], st)):
            out[-1] = (out[-1][0] * n, st)
        else:
            out.append((n, st))
    return [n for n, _ in out], [[st[i] for _, st in out] for i in range(len(strides))]


def _lanes(x: torch.Tensor, y: torch.Tensor):
    """``(D2, (xs1, xs2), (ys1, ys2))``: the non-time dims of ``x`` and ``y``
    as at most two lane dims of the kernel (strides in floats, a complex
    tensor's parts the innermost), or None when they do not collapse to two."""
    xr, yr = (torch.view_as_real(t) if t.is_complex() else t for t in (x, y))
    inner = 2 if x.is_complex() else 1
    rest = xr.shape[1:len(xr.shape) - (inner == 2)]
    sizes, (xs, ys) = _collapse(rest, xr.stride()[1:1 + len(rest)], yr.stride()[1:1 + len(rest)])
    if len(sizes) > 2:
        return None
    sizes, xs, ys = [1] * (2 - len(sizes)) + sizes, [0] * (2 - len(xs)) + xs, [0] * (2 - len(ys)) + ys
    return sizes[1], xs, ys


def scan_layout(x: torch.Tensor, zi: torch.Tensor | None, N: int):
    """The kernel's arguments for ``x`` (T, ...): ``(x, y, state, lanes)``
    with ``y`` the output (``x``'s strides, as the plain version's
    ``empty_like``; ``x`` made contiguous first when its non-time dims do not
    collapse to two lane dims), ``state`` the initial state ``rest + (N,)``
    in ``x``'s dtype (zeros without ``zi``), and ``lanes`` the ints
    ``L, comps, D2, xs0, xs1, xs2, ys0, ys1, ys2`` of ``hm_iir_scan``
    (strides in floats).  Device-independent: the CPU tests model the
    kernel's indexing with it."""
    rest = tuple(x.shape[1:])
    state = torch.zeros(rest + (N,), dtype=x.dtype, device=x.device)
    if zi is not None:
        state.copy_(torch.broadcast_to(zi.to(device=x.device, dtype=x.dtype), rest + (N,)))
    y = torch.empty_like(x)
    lanes = _lanes(x, y)
    if lanes is None:  # more than two lane dims of differing strides: time-major contiguous
        x = x.contiguous()
        y = torch.empty_like(x)
        lanes = _lanes(x, y)
    D2, xs, ys = lanes
    comps = 2 if x.is_complex() else 1
    xr, yr = (torch.view_as_real(t) if t.is_complex() else t for t in (x, y))
    L = comps * int(np.prod(rest))
    return x, y, state, (L, comps, D2, xr.stride(0), *xs, yr.stride(0), *ys)


def vector_rows(L: int, comps: int, D2: int, s0: int, s1: int, s2: int, ptr: int) -> bool:
    """Whether ``csrc/iir_scan.cu`` moves a tensor's lanes by 16-byte
    copies, from ``scan_layout``'s lane arguments for it (strides in floats)
    and its address: lane j lies at float j of its step's row (so a block's
    32 lanes are one run of 128 bytes), and L, the step stride and the base
    are whole 16-byte vectors.  Otherwise a lane's float moves alone."""
    D1 = L // comps // D2
    flat = (D1 == 1 or s1 == D2 * comps) and (D2 == 1 or s2 == comps)
    return flat and L % SCAN_VEC == 0 and s0 % SCAN_VEC == 0 and ptr % (4 * SCAN_VEC) == 0


def iir_scan(b, a, x: torch.Tensor, zi: torch.Tensor | None = None):
    """``lfilter(b, a, x)`` along dim 0 of ``x`` (T, ...), with the
    arguments and returns of :func:`ops.iir.iir_scan`, by the kernel: one
    launch for all T steps.  ``x`` float32 or complex64, any strides (the
    output takes ``x``'s, as the plain version's ``empty_like``).  Raises
    ``TypeError`` for another dtype and ``ValueError`` for a state above 8
    or a tensor off the card."""
    if x.device.type == "cpu":
        return iir.iir_scan_plain(b, a, x, zi)
    if x.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"iir_scan on the card takes float32 or complex64 (got {x.dtype})")
    bp, a_tail = iir.scan_coefficients(b, a)
    N = len(a_tail)
    if N > SCAN_N_MAX:
        raise ValueError(f"iir_scan takes states of at most {SCAN_N_MAX} (got N={N})")
    if x.device.type != "cuda":
        raise ValueError(f"iir_scan runs on CUDA tensors (got {x.device})")
    lib = checked_scan_library()
    x, y, state, lanes = scan_layout(x, zi, N)
    if x.shape[0] == 0 or y.numel() == 0:
        return y, state
    zr, yr, xr = (torch.view_as_real(t) if t.is_complex() else t for t in (state, y, x))
    zf = torch.empty_like(zr)
    coef = np.concatenate([bp, a_tail]).astype(np.float32)  # b0, b_1..b_N, a_1..a_N
    L, comps, D2, xs0, xs1, xs2, ys0, ys1, ys2 = lanes
    vec = (vector_rows(L, comps, D2, xs0, xs1, xs2, xr.data_ptr()),
           vector_rows(L, comps, D2, ys0, ys1, ys2, yr.data_ptr()))
    rc = lib.hm_iir_scan(xr.data_ptr(), zr.data_ptr() if zi is not None else None, yr.data_ptr(), zf.data_ptr(),
                         coef.ctypes.data, N, x.shape[0], L, comps, D2, xs0, xs1, xs2, ys0, ys1, ys2, *map(int, vec),
                         stream_handle(x.device))
    check(rc, "iir_scan")
    launch_counts["iir_scan"] += 1
    return y, (torch.view_as_complex(zf) if x.is_complex() else zf)
