"""The integer simulator's hidden-layer scan on the card: the wrapper of
``csrc/xylo_sim.cu``, the route :func:`models.xylo.sim.scan_hidden` takes
for a CUDA tensor (``XyloSim`` and its readout, ``evolve_to_hidden``,
``XyloSimPushToHidden``'s two stages, ``sim_hidden_batch``).

It runs all T steps of :func:`models.xylo.sim.scan_hidden_plain` in one
launch, in any of the four step conventions, with a uniform or dense
``w_rec``, its records written as the steps go, and equals the plain loop
bit for bit (every value is an integer).  Without a recurrence the B x N
neurons are taken flat, a thread each; with one, a block a batch row
(:func:`sim_launch`).  It replaces no TPU
kernel: the JAX package runs the simulator as one ``lax.scan``
(``models/xylo/sim.py:60-124``).  K3-K6 (``ops/cuda/lif_kernel.py``) keep
the plain loop as their twin (``sim.sim_hidden``), never this kernel.

On CPU tensors :func:`scan_hidden` runs the plain version; on any other
device it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...models.xylo import sim
from ._build import check, launch_counts, library, library_constants, stream_handle

INT32 = np.iinfo(np.int32)
# csrc/xylo_sim.cu's N_MAX (neurons a batch row), FREE_THREADS and THREADS_MAX, as hm_xylo_sim_constants gives them
SIM_N_MAX, SIM_FREE_THREADS, SIM_THREADS_MAX = 4096, 128, 512


@functools.lru_cache(maxsize=1)
def checked_library():
    """The kernel library, once its constants are held equal to this
    module's (``SIM_N_MAX``, ``SIM_FREE_THREADS``, ``SIM_THREADS_MAX``):
    :func:`sim_launch` plans launches from them."""
    got = library_constants("hm_xylo_sim_constants", 3)
    if got != (SIM_N_MAX, SIM_FREE_THREADS, SIM_THREADS_MAX):
        raise RuntimeError(f"csrc/xylo_sim.cu's constants {got} differ from sim_kernel's "
                           f"{(SIM_N_MAX, SIM_FREE_THREADS, SIM_THREADS_MAX)}")
    return library()


def sim_launch(B: int, N: int, recurrent: bool) -> tuple[int, int, int]:
    """``(blocks, threads, neurons a thread)`` of ``hm_xylo_sim`` for B
    rows of N neurons.  Without a recurrence no neuron waits on another: the
    B x N neurons flat, a thread each, ``SIM_FREE_THREADS`` to a block (a
    warp's 32 neurons one 128-byte line of each step's record where B x N is
    a multiple of 32).  With one, a block a row (it must see the row's
    spikes of the step before): the fewest neurons a thread (1, 2, 4 or 8)
    that keep the row within ``SIM_THREADS_MAX`` threads, in whole warps."""
    if not recurrent:
        return -(-B * N // SIM_FREE_THREADS), SIM_FREE_THREADS, 1
    npt = next(k for k in (1, 2, 4, 8) if k * SIM_THREADS_MAX >= N)
    return B, -(-N // (32 * npt)) * 32, npt


def _int32_weights(w, dev) -> torch.Tensor:
    """A dense ``w_rec`` as int32 on ``dev``; raises unless every entry is an
    integer in the int32 range (the plain version's float64 product of such
    entries is exact)."""
    w64 = np.asarray(w, np.float64)
    if not np.array_equal(w64, np.round(w64)) or w64.size and (w64.min() < INT32.min or w64.max() > INT32.max):
        raise ValueError("the simulator kernel takes a w_rec of int32 integers")
    return torch.as_tensor(w64.astype(np.int32), device=dev)


def scan_hidden(inp: torch.Tensor, dash_syn, dash_mem, threshold, state0=None, *, rec_coef: int = 0,
                w_rec=None, ordering: str = "decay_first", reset: str = "subtract", record: bool = True,
                record_state: bool = False, count: bool = False):
    """:func:`models.xylo.sim.scan_hidden` by the kernel, with its arguments
    and returns: ``inp`` (T, ..., N) int32 on the card, one launch for all T
    steps.  Raises ``TypeError`` for another dtype and ``ValueError`` for an
    unknown convention, more than 4096 neurons, or a recurrence outside
    int32."""
    if inp.device.type == "cpu":
        return sim.scan_hidden_plain(inp, dash_syn, dash_mem, threshold, state0, rec_coef=rec_coef, w_rec=w_rec,
                                     ordering=ordering, reset=reset, record=record, record_state=record_state,
                                     count=count)
    if ordering not in sim.ORDERINGS:
        raise ValueError(f"unknown ordering {ordering!r}")
    if reset not in sim.RESETS:
        raise ValueError(f"unknown reset {reset!r}")
    if inp.dtype != torch.int32:
        raise TypeError(f"scan_hidden on the card takes an int32 input current (got {inp.dtype})")
    if inp.dim() < 2:
        raise ValueError(f"inp must be (T, ..., N) (got shape {tuple(inp.shape)})")
    T, shape, N = inp.shape[0], tuple(inp.shape[1:]), inp.shape[-1]
    if N > SIM_N_MAX:
        raise ValueError(f"the simulator kernel takes at most {SIM_N_MAX} neurons (got {N})")
    dense = w_rec is not None
    coef = 0 if dense else int(rec_coef)
    if not INT32.min <= coef <= INT32.max:
        raise ValueError(f"rec_coef {coef} is outside int32")
    if dense and np.shape(w_rec) != (N, N):
        raise ValueError(f"w_rec must be ({N}, {N}) (got {np.shape(w_rec)})")
    if inp.device.type != "cuda":
        raise ValueError(f"scan_hidden's kernel runs on CUDA tensors (got {inp.device})")
    lib = checked_library()
    dev = inp.device
    wr = _int32_weights(w_rec, dev) if dense else None
    per_neuron = [torch.broadcast_to(sim._int32(v, dev), (N,)).contiguous() for v in (dash_syn, dash_mem, threshold)]
    B = int(np.prod(shape[:-1]))
    state = None if state0 is None else [sim._int32(s, dev).expand(shape).contiguous() for s in state0]
    new = lambda: torch.empty((T,) + shape, dtype=torch.int32, device=dev)  # noqa: E731
    spikes = new() if record else None
    isyn_rec, vmem_rec = (new(), new()) if record_state else (None, None)
    counts = torch.zeros(shape, dtype=torch.int32, device=dev) if count else None
    rec = {"Isyn": isyn_rec, "Vmem": vmem_rec} if record_state else {}
    if T == 0 or B == 0 or N == 0:
        final = tuple(torch.zeros(shape, dtype=torch.int32, device=dev) for _ in range(3)) if state is None \
            else tuple(state)
        return spikes, counts, final, rec
    final = [torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3)]
    x = inp.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.hm_xylo_sim(x.data_ptr(), *(ptr(t) for t in per_neuron), *(ptr(s) for s in (state or (None,) * 3)),
                         ptr(wr), ptr(spikes), ptr(isyn_rec), ptr(vmem_rec), ptr(counts), *(ptr(f) for f in final),
                         T, B, N, coef, int(dense), int(ordering == "integrate_first"), int(reset == "zero"),
                         *sim_launch(B, N, dense or coef != 0), stream_handle(dev))
    check(rc, "xylo_sim")
    launch_counts["xylo_sim"] += 1
    return spikes, counts, tuple(final), rec
