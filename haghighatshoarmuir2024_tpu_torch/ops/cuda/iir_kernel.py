"""The lifted blocked IIR cumsum on the card: the wrapper of
``csrc/iir_lifted.cu``, the route :func:`ops.iir.iir_cumsum_blocked` takes
for a CUDA tensor.

It computes what :func:`ops.iir.iir_cumsum_blocked_plain` computes, from the
same float32 matrices, in two launches (three at level 1), and it replaces
no TPU kernel: the JAX package leaves this to XLA.  What it adds is one
fixed order of summation for every output element, whatever the number of
columns, so a stream's encode on the card is the same alone, in a shard or
in the whole batch (the plain version's GEMMs go to cuBLAS, whose kernel and
rounding follow the call's width).

On CPU tensors :func:`iir_lifted` runs the plain version; on any other
device it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import iir
from ._build import check, launch_counts, library, stream_handle

SB_MAX, N_MAX, K2_MAX, RT = 64, 8, 512, 8  # csrc/iir_lifted.cu's constants


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
