"""The integer simulator's hidden-layer scan on the card: the wrapper of
``csrc/xylo_sim.cu``, the route :func:`models.xylo.sim.scan_hidden` takes
for a CUDA tensor (``XyloSim`` and its readout, ``evolve_to_hidden``,
``XyloSimPushToHidden``'s two stages, ``sim_hidden_batch``).

It runs all T steps of :func:`models.xylo.sim.scan_hidden_plain` in one
launch, in any of the four step conventions, with a uniform or dense
``w_rec``, its records written as the steps go, and equals the plain loop
bit for bit (every value is an integer).  Three kernels
(:func:`sim_launch`): without a recurrence the B x N neurons flat, a thread
each (``xylo_sim``); with one, a row on a cluster of CTAs that holds
``w_rec`` in shared memory at its narrowest width (``xylo_sim_onchip``,
:func:`onchip_image`), or, for a dense ``w_rec`` that cannot live on chip,
a block a row reading it from global memory (``xylo_sim_row``).  A model
that holds a dense ``w_rec`` (``XyloSim``, ``XyloSimPushToHidden``) passes
it as a :class:`DenseRec`, which keeps the array its kernel reads on the
card from call to call.  Each launch adds one to ``launch_counts`` under
its kernel's name (``SimPlan.kernel``).  It replaces no TPU kernel:
the JAX package runs the simulator as one ``lax.scan``
(``models/xylo/sim.py:60-124``).  K3-K6 (``ops/cuda/lif_kernel.py``) keep
the plain loop as their twin (``sim.sim_hidden``), never this kernel.

On CPU tensors :func:`scan_hidden` runs the plain version; on any other
device it launches a kernel or raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ...models.xylo import sim
from ._build import check, launch_counts, library, library_constants, stream_handle

INT32 = np.iinfo(np.int32)
# csrc/xylo_sim.cu's N_MAX (neurons a batch row), FREE_THREADS and THREADS_MAX, and its on-chip kernel's
# ONCHIP_THREADS_MAX (threads a CTA), ONCHIP_SMEM_MAX (dynamic shared memory a block, bytes), ONCHIP_BLOCK
# (list entries a gather step) and ONCHIP_CLUSTER_MAX, as hm_xylo_sim_constants gives them
SIM_N_MAX, SIM_FREE_THREADS, SIM_THREADS_MAX = 4096, 128, 512
ONCHIP_THREADS_MAX, ONCHIP_SMEM_MAX, ONCHIP_BLOCK, ONCHIP_CLUSTER_MAX = 512, 232_448, 8, 8
CONSTANTS = (SIM_N_MAX, SIM_FREE_THREADS, SIM_THREADS_MAX, ONCHIP_THREADS_MAX, ONCHIP_SMEM_MAX, ONCHIP_BLOCK,
             ONCHIP_CLUSTER_MAX)
CLUSTERS = (1, 2, 4, 8)  # CTAs a row of the on-chip kernel
# bytes an on-chip entry of w_rec -> the entries' range at that width
WIDTHS = {1: (-128, 127), 2: (-32768, 32767), 4: (int(INT32.min), int(INT32.max))}


@functools.lru_cache(maxsize=1)
def checked_library():
    """The kernel library, once its constants are held equal to this
    module's (:data:`CONSTANTS`): :func:`sim_launch` plans launches from
    them."""
    got = library_constants("hm_xylo_sim_constants", len(CONSTANTS))
    if got != CONSTANTS:
        raise RuntimeError(f"csrc/xylo_sim.cu's constants {got} differ from sim_kernel's {CONSTANTS}")
    return library()


class SimPlan(NamedTuple):
    """A launch of ``csrc/xylo_sim.cu``: ``kernel`` (``"xylo_sim"`` the flat
    kernel, ``"xylo_sim_row"`` the global-memory row kernel, ``"xylo_sim_onchip"``),
    ``blocks`` of ``threads``, ``slots`` neurons a thread, ``cluster`` CTAs
    a row, ``width`` bytes an on-chip entry of a dense ``w_rec`` (0 when
    the matrix is not on chip) and ``smem`` bytes of dynamic shared memory
    a block."""
    kernel: str
    blocks: int
    threads: int
    slots: int
    cluster: int = 1
    width: int = 0
    smem: int = 0


def weight_width(w) -> int:
    """Bytes an entry of the integer matrix ``w`` takes on chip: 1 where
    every entry lies in [-128, 127], 2 in the int16 range, 4 otherwise."""
    w = np.asarray(w)
    lo, hi = (int(w.min()), int(w.max())) if w.size else (0, 0)
    return next(b for b, (a, z) in WIDTHS.items() if a <= lo and hi <= z)


def onchip_threads(N: int, S: int, c: int) -> int:
    """Threads a CTA of the on-chip kernel: each S of its row's N / c
    neurons; on a cluster whole warps, so that lanes 0..c-1 of every warp
    exist to reserve on the c CTAs."""
    per = -(-(-(-N // c)) // S)
    return per if c == 1 else -(-per // 32) * 32


def onchip_cap(N: int) -> int:
    """Entries of a spike-list buffer: N rounded up to a gather step, and
    the step the gather reads past the last one it sums."""
    return -(-N // ONCHIP_BLOCK) * ONCHIP_BLOCK + ONCHIP_BLOCK


def onchip_image_bytes(N: int, nt: int, S: int, W: int) -> int:
    """Bytes of one CTA's image: N + 1 rows (row N the pad) of nt threads'
    S entries of W bytes, padded to 16 bytes."""
    return -(-((N + 1) * nt * S * W) // 16) * 16


def onchip_smem(N: int, nt: int, S: int, W: int, dense: bool) -> int:
    """Dynamic shared memory of a CTA: the image, two lists of uint16 and
    three counts (16 bytes); a uniform ``w_rec`` the counts alone."""
    return onchip_image_bytes(N, nt, S, W) + 4 * onchip_cap(N) + 16 if dense else 16


# neurons a thread of the on-chip kernel with a dense w_rec, by the bytes an entry takes, the only forms the
# kernel is built in: on the dense push-to-hidden block two int8 entries a thread took 11.36 ms against 11.46 at
# one and 13.05 at four; an int16 layer of N = 300 3.58 ms at one against 4.26 at two (an H100, PERF.md §6)
DENSE_SLOTS = {1: 2, 2: 1, 4: 1}
UNIFORM_SLOTS = (1, 2, 4, 8)  # neurons a thread of the on-chip kernel with a uniform w_rec


def sim_launch(B: int, N: int, rec: str = "none", width: int = 4, cluster: int | None = None) -> SimPlan:
    """The launch of ``csrc/xylo_sim.cu`` for B rows of N neurons, chosen by
    their size and the recurrence's kind and width alone, never by a
    launch's outcome.

    - ``rec="none"``: no neuron waits on another: the B x N neurons flat, a
      thread each, ``SIM_FREE_THREADS`` to a block (a warp's 32 neurons one
      128-byte line of each step's record where B x N is a multiple of 32).
    - ``rec="dense"`` (``width`` bytes an entry, :func:`weight_width`): the
      on-chip kernel, ``DENSE_SLOTS[width]`` neurons a thread, on the fewest
      CTAs a row (1, 2, 4, 8) whose slice of ``w_rec`` fits a block's shared
      memory within ``ONCHIP_THREADS_MAX`` threads; where none fits (N =
      4096, or int32 entries past N = 597), the global-memory row kernel, a
      block a row reading ``w_rec`` from global memory, 2, 4 or 8 neurons a
      thread.  The fewest CTAs because a CTA's warps take every
      spiking row whatever c is, so a row's step is no shorter on more CTAs,
      while a cluster barrier costs 734-870 cycles a step against 35-89 for
      ``__syncthreads`` (an H100, PERF.md §6); at N = 477 in int8 one
      CTA a row holds 229 KB and the card takes B rows in one wave up to 132,
      as it would with clusters (two CTAs of 115 KB do not share an SM, four
      of 57 KB take three an SM).  B therefore does not change the choice.
    - ``rec="uniform"``: the on-chip kernel without the matrix, one CTA a
      row, the fewest neurons a thread (``UNIFORM_SLOTS``) that keep the row
      within ``ONCHIP_THREADS_MAX`` threads.

    ``cluster`` forces a dense ``w_rec`` onto that many CTAs a row (raises
    ``ValueError`` where its slice does not fit, and for a uniform one on
    more than one): the dense block's check and sweep across c."""
    if rec == "none":
        return SimPlan("xylo_sim", -(-B * N // SIM_FREE_THREADS), SIM_FREE_THREADS, 1)
    if rec not in ("uniform", "dense"):
        raise ValueError(f"unknown recurrence {rec!r}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"a row takes 1, 2, 4 or 8 CTAs (got {cluster})")
    if rec == "uniform":
        if cluster not in (None, 1):
            raise ValueError("a uniform w_rec takes one CTA a row")
        S = next(k for k in UNIFORM_SLOTS if onchip_threads(N, k, 1) <= ONCHIP_THREADS_MAX)
        return SimPlan("xylo_sim_onchip", B, onchip_threads(N, S, 1), S, 1, 0, onchip_smem(N, 0, S, 0, False))
    if width not in DENSE_SLOTS:
        raise ValueError(f"an on-chip entry takes 1, 2 or 4 bytes (got {width})")
    S = DENSE_SLOTS[width]
    for c in (CLUSTERS if cluster is None else (cluster,)):
        nt = onchip_threads(N, S, c)
        smem = onchip_smem(N, nt, S, width, True)
        if nt <= ONCHIP_THREADS_MAX and smem <= ONCHIP_SMEM_MAX:
            return SimPlan("xylo_sim_onchip", B * c, nt, S, c, width, smem)
    if cluster is not None:
        raise ValueError(f"N = {N} at {width} bytes an entry does not fit {cluster} CTAs a row")
    npt = next(k for k in (2, 4, 8) if k * SIM_THREADS_MAX >= N)
    return SimPlan("xylo_sim_row", B, -(-N // (32 * npt)) * 32, npt)


def _integer_weights(w) -> np.ndarray:
    """A dense ``w_rec`` as int64 integers; raises unless every entry is an
    integer in the int32 range (the plain version's float64 product of such
    entries is exact)."""
    w64 = np.asarray(w, np.float64)
    if not np.array_equal(w64, np.round(w64)) or w64.size and (w64.min() < INT32.min or w64.max() > INT32.max):
        raise ValueError("the simulator kernel takes a w_rec of int32 integers")
    return w64.astype(np.int64)


def onchip_image(w, plan: SimPlan) -> np.ndarray:
    """The on-chip kernel's shared-memory image of the (N, N) integer
    ``w_rec``: (c, ``onchip_image_bytes``) uint8, CTA r's rows m = 0..N of
    ``row_bytes = nt * S * W`` bytes, thread t's S entries ``w_rec[m, r*Vc +
    k*nt + t]`` (Vc = S * nt) side by side at byte ``m*row_bytes + (t*S +
    k)*W``, little-endian (int8 stored + 128, int16 and int32 as two's
    complement); columns past N and row N (the list's pad) hold zeros."""
    w = np.asarray(w, np.int64)
    N = w.shape[0]
    c, nt, S, W = plan.cluster, plan.threads, plan.slots, plan.width
    full = np.zeros((N + 1, c * S * nt), np.int64)
    full[:N, :N] = w
    blocks = full.reshape(N + 1, c, S, nt).transpose(1, 0, 3, 2)  # (c, N + 1, nt, S): column r*Vc + k*nt + t
    store = {1: lambda v: (v + 128).astype(np.uint8), 2: lambda v: v.astype("<i2"),
             4: lambda v: v.astype("<i4")}[W](blocks)
    rows = np.ascontiguousarray(store).view(np.uint8).reshape(c, -1)
    out = np.zeros((c, onchip_image_bytes(N, nt, S, W)), np.uint8)
    out[:, :rows.shape[1]] = rows
    return out


class DenseRec:
    """A dense ``w_rec`` prepared once for the simulator kernel, for a model
    that holds its weights: a copy of the matrix as given (``w_rec``, what
    the CPU's plain loop takes) and, from its first call on the card, its
    check as int32 integers, its width (:func:`weight_width`) and, for each
    device and plan, the array its kernel reads (the on-chip image,
    :func:`onchip_image`, or the int32 matrix of the global-memory row
    kernel).  Built per call in numpy and copied to the card, that array
    took about 3 ms of host work a call at N = 477 (an H100, PERF.md §6)."""

    def __init__(self, w_rec):
        self.w_rec = np.array(w_rec)
        self.shape = self.w_rec.shape
        self._checked = None
        self._operands = {}

    def checked(self) -> tuple[np.ndarray, int]:
        """The matrix as int64 integers (:func:`_integer_weights`) and its
        width in bytes an entry."""
        if self._checked is None:
            w = _integer_weights(self.w_rec)
            self._checked = (w, weight_width(w))
        return self._checked

    def operand(self, plan: SimPlan, dev: torch.device) -> torch.Tensor:
        """The array ``plan``'s kernel reads, on ``dev``: built at the first
        call with that layout there, then kept."""
        key = (plan.kernel, plan.threads, plan.slots, plan.cluster, str(dev))
        if key not in self._operands:
            w = self.checked()[0]
            host = onchip_image(w, plan) if plan.kernel == "xylo_sim_onchip" else w.astype(np.int32)
            self._operands[key] = torch.as_tensor(host, device=dev)
        return self._operands[key]


def scan_hidden(inp: torch.Tensor, dash_syn, dash_mem, threshold, state0=None, *, rec_coef: int = 0,
                w_rec=None, ordering: str = "decay_first", reset: str = "subtract", record: bool = True,
                record_state: bool = False, count: bool = False, cluster: int | None = None):
    """:func:`models.xylo.sim.scan_hidden` by the kernel, with its arguments
    and returns: ``inp`` (T, ..., N) int32 on the card, one launch for all T
    steps (the kernel :func:`sim_launch` plans; ``cluster`` forces a dense
    ``w_rec`` onto that many CTAs a row).  ``w_rec`` may be a
    :class:`DenseRec`.  Raises ``TypeError`` for another dtype and
    ``ValueError`` for an unknown convention, more than 4096 neurons, a
    recurrence outside int32, or a forced plan that does not fit."""
    if inp.device.type == "cpu":
        return sim.scan_hidden_plain(inp, dash_syn, dash_mem, threshold, state0, rec_coef=rec_coef,
                                     w_rec=w_rec.w_rec if isinstance(w_rec, DenseRec) else w_rec, ordering=ordering,
                                     reset=reset, record=record, record_state=record_state, count=count)
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
    dense = None if w_rec is None else w_rec if isinstance(w_rec, DenseRec) else DenseRec(w_rec)
    coef = 0 if dense is not None else int(rec_coef)
    if not INT32.min <= coef <= INT32.max:
        raise ValueError(f"rec_coef {coef} is outside int32")
    if dense is not None and dense.shape != (N, N):
        raise ValueError(f"w_rec must be ({N}, {N}) (got {dense.shape})")
    if cluster is not None and dense is None:
        raise ValueError("cluster is a dense w_rec's: this scan has none")
    if inp.device.type != "cuda":
        raise ValueError(f"scan_hidden's kernel runs on CUDA tensors (got {inp.device})")
    lib = checked_library()
    dev = inp.device
    B = int(np.prod(shape[:-1]))
    plan = sim_launch(B, N, "dense" if dense is not None else ("uniform" if coef else "none"),
                      dense.checked()[1] if dense is not None else 4, cluster)
    per_neuron = [torch.broadcast_to(sim._int32(v, dev), (N,)).contiguous() for v in (dash_syn, dash_mem, threshold)]
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
    head = (x.data_ptr(), *(ptr(t) for t in per_neuron), *(ptr(s) for s in (state or (None,) * 3)))
    outs = (ptr(spikes), ptr(isyn_rec), ptr(vmem_rec), ptr(counts), *(ptr(f) for f in final))
    conv = (int(ordering == "integrate_first"), int(reset == "zero"))
    operand = None if dense is None else dense.operand(plan, dev)
    kind = (coef, int(dense is not None), *conv)
    if plan.kernel == "xylo_sim_onchip":
        rc = lib.hm_xylo_sim_onchip(*head, ptr(operand), *outs, T, B, N, *kind, plan.slots, plan.width, plan.cluster,
                                    plan.threads, 0 if dense is None else operand.shape[1], stream_handle(dev))
    else:
        rc = lib.hm_xylo_sim(*head, ptr(operand), *outs, T, B, N, *kind, plan.blocks, plan.threads, plan.slots,
                             stream_handle(dev))
    check(rc, plan.kernel)
    launch_counts[plan.kernel] += 1
    return spikes, counts, tuple(final), rec


def barrier_cycles(cluster: int, threads: int = 128, reps: int = 4096, on_cluster: bool = True,
                   relaxed: bool = False, device=None) -> list[float]:
    """Cycles a barrier on the card, one a CTA: ``hm_barrier_probe`` runs
    ``reps`` barriers between two ``clock64`` reads on one cluster of
    ``cluster`` CTAs of ``threads`` threads (``barrier.cluster`` arrive, with
    release semantics or ``relaxed``, then wait), or with ``on_cluster``
    false ``__syncthreads`` on one block."""
    lib = checked_library()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    out = torch.zeros(cluster, dtype=torch.int64, device=dev)
    mode = (2 if relaxed else 1) if on_cluster else 0
    check(lib.hm_barrier_probe(cluster, threads, reps, mode, out.data_ptr(), stream_handle(dev)), "barrier_probe")
    launch_counts["barrier_probe"] += 1
    return [v / reps for v in out.tolist()]
