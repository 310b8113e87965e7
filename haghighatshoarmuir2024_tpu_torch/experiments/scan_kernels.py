"""The scan kernels, ``iir_scan`` (``csrc/iir_scan.cu``, the per-sample
IIR scan), ``xylo_sim`` (``csrc/xylo_sim.cu``, the integer simulator's
hidden-layer scan), ``envelope`` (``csrc/envelope.cu``, the envelope
follower) and ``track_angles`` / ``track_multi`` (``csrc/tracking.cu``, the
two DoA trackers), against their plain loops on the card, timed, with
their bounds:

    python -m haghighatshoarmuir2024_tpu_torch.experiments.scan_kernels [--reps 20]
    python -m haghighatshoarmuir2024_tpu_torch.experiments.scan_kernels split [--reps 20] [--only LABEL ...]
                                                                               [--clusters C ...]
    python -m haghighatshoarmuir2024_tpu_torch.experiments.scan_kernels sass [--kernel xylo_sim|envelope]
                                                                              [--against OTHER/csrc/SOURCE.cu]
    python -m haghighatshoarmuir2024_tpu_torch.experiments.scan_kernels wrap
    python -m haghighatshoarmuir2024_tpu_torch.experiments.scan_kernels barrier

The IIR cases are the shapes of the paths that scan (:func:`iir_inputs`):
the Hilbert apply's complex64 (T, B, 7) analytic signal at 1 and 96 of
bench.py's frames through its order-2 1600-1900 Hz bandpass, MUSIC's order-1
band over a (96, T, 7) batch along dim 1 (a strided view), the SNN
beamformer's 14 real columns, and a streaming-fallback chunk of 96 streams x
14 columns with a state carried over two chunks.  Each is made on the CPU
from seeds, so the same inputs reach JAX's scan in the CPU tests
(``tests/test_torch_scan_kernels.py --jax-bounds``).  The simulator cases
(:func:`sim_against_plain`) take a config and a spike raster.  Every check
holds the kernel's outputs and final state to the plain loop's with
``torch.equal``.

``split`` times each kernel alone from CUPTI's kernel records
(``hand_kernels.traced_ms``) at every IIR case and at the simulator's
(12 000, 96, 449) flagship with three records, one record (the readout's
and a spikes-only layer's form) and none, the uniform ``w_rec = -1``, the
dense push-to-hidden block and one batch row (``--only``: those simulator
cases alone, by label, nothing else; ``--pad-mib``: a pad allocated first,
which moves every later tensor in device memory):
each launch's device ms, for the scan its cycles a step at the SM clock
(``sm_clock_mhz``) against the chain's 16, for the simulator its bytes a
second against 3.35 TB/s, beside the card's name and power limit; and the
scan's cycles a step by its order (:func:`iir_by_order`) and PyTorch's
write and read streams on the simulator's bytes (:func:`memory_yardsticks`).
The follower and the trackers (:func:`envelope_inputs`,
:func:`track_inputs`) run at ``Envelope(1e-3, 1e-2, 48 000)`` on one
flagship frame (12 000, 7) and on 96 frames' microphones as lanes (12 000,
672), float32, and one frame in float64; ``track_angles`` at (240, 96), a
minute of 0.25 s frames for 96 streams, and ``track_multi_angles`` at (240,
96, 2) with 4 tracks, from seeds; ``check`` holds each against its plain
loop by ``torch.equal`` (:func:`envelope_against_plain`,
:func:`track_against_plain`, :func:`multi_against_plain`), and ``split``
(``--only envelope track_angles track_multi``: those alone) gives each
launch's device ms from CUPTI beside its chain floor
(:func:`envelope_chain_ms`, :func:`track_chain_ms`, :func:`multi_chain_ms`;
the trackers' from the wrap's latency measured in the same run,
:func:`wrap_latency`; beside the follower's, its step's chain as one warp
runs it from registers, :func:`envelope_chain_latency`) and its bytes.  The dense push-to-hidden block's
bound counts its recurrence (:func:`sim_work`).
``wrap`` measures the trackers' wrap, ``atan2f(sinf(x), cosf(x))`` as
``atan2f`` of ``sincosf``'s pair: its latency in a one-thread chain
(:func:`wrap_latency`) beside the chain of ``atan2f(sinf(x), cosf(x))`` and
of each function alone, its bits against PyTorch's ``atan2(sin x, cos x)``
at every float32 (both forms, :func:`wrap_bits`), and each tracking kernel's registers and stack frame
(``ptxas -v``, :func:`build_resources`) and SASS (:func:`tracker_sass`).
``sass`` compiles this tree's source of a kernel (:data:`SASS_KERNELS`:
``--kernel xylo_sim``, the default, ``csrc/xylo_sim.cu``'s two recurrent
kernels, the global-memory row kernel ``xylo_sim_kernel<NPT>`` and the
on-chip ``xylo_sim_onchip_kernel<S, W, REC, CLUSTER>``; ``--kernel
envelope``, ``csrc/envelope.cu``'s ``envelope_kernel<T>``) and another
tree's (``--against``) with the library's nvcc flags and compares their
instantiations instruction by instruction in ``cuobjdump -sass`` (the
addresses left out), with each instantiation's counts of the opcodes that
kernel's table names (shared loads, atomics, barriers and the like), its
innermost loops (:func:`innermost_loops`: what a recurrence's unrolled
steps issue) in both trees, and its registers and spills (``ptxas -v``).
For the simulator's recurrent cases ``split`` also gives the launch's
cycles a step, its bound by :func:`sim_work` (operations or bytes) and the
share; ``--clusters 1 2 4`` runs the dense block once more through the
on-chip kernel at each cluster size (``sim_kernel.scan_hidden(...,
cluster=c)``; a tree without that kernel refuses it).  The dense
``w_rec`` goes to the kernel as the models hold it (:func:`held_recurrence`:
its on-chip image built once), so CUDA events time the wrapper as
``XyloSim`` calls it.
``barrier`` measures the barriers the recurrent kernels wait on a step
(:func:`barrier_latency`): ``__syncthreads`` on one block of 128 and 512
threads and ``barrier.cluster`` arrive/wait on one cluster of 1, 2, 4 and
8 CTAs, 4096 in a row between two ``clock64`` reads.
Each mode prints one JSON line; ``check`` and ``split`` raise without a GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .hand_kernels import card_line, events_ms, launches_a_call, traced_ms

SEED = 0
STREAM_TC = 2999  # a chunk no lifted block size divides: the streaming encode's scan fallback
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device memory rate
FP32_LATENCY_CYCLES = 4  # a dependent FP32 add or multiply on sm_90 (issue to issue)
FP64_LATENCY_CYCLES = 8  # a dependent FP64 add or multiply on sm_90, as this module counts it
CHAIN_OPS = 4  # the scan's dependent chain a step: b0 x + s_1, a_1 y, the difference, + s_2


def _require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("scan_kernels measures the card: no CUDA device is available")
    return torch.device("cuda", 0)


def iir_inputs(batch: int = 96) -> dict:
    """``{name: (b, a, x, axis, zi)}`` on the CPU: the scanning paths'
    inputs at bench.py's frames (module docstring)."""
    from ..models.beamformer import analytic
    from ..models.xylo import Demo
    from ..models.xylo.flagship import FS, flagship_config, flagship_frames
    from ..ops.filterbank import ButterworthFilterbank
    from ..ops.iir import butter_bandpass
    from ..ops.stht import stht_kernel

    band = (1600.0, 1900.0)
    demo = Demo(**flagship_config("cpu"))
    frames, _ = flagship_frames(demo, batch, seed=SEED)  # (B, T, 7) float32
    h = analytic(frames.movedim(1, 0), stht_kernel(int(FS * 10e-3)))  # (T, B, 7) complex64, the Hilbert apply's
    ba2 = butter_bandpass(2, band, FS)
    ba1 = ButterworthFilterbank([band], order=1, fs=FS).ba_list[0]
    rng = np.random.default_rng(SEED)
    stream = torch.as_tensor(rng.standard_normal((2 * STREAM_TC, batch, 14)).astype(np.float32))
    zi = torch.as_tensor(rng.standard_normal((batch, 14, len(ba1[1]) - 1)).astype(np.float32))
    return {
        "hilbert 1 frame": (*ba2, h[:, :1].contiguous(), 0, None),
        f"hilbert {batch} frames": (*ba2, h, 0, None),
        f"music {batch} frames": (*ba1, frames, 1, None),
        "snn 14 columns": (*ba2, torch.cat([h[:, 0].real, h[:, 0].imag], dim=-1), 0, None),
        f"stream {batch} x 14, two chunks": (*ba1, stream, 0, zi),
    }


def scan_work(T: int, L: int, N: int) -> tuple[float, float]:
    """(float32 operations, bytes) of the scan on (T, L) real lanes: b0 x
    and y's add, then per state value two products, a difference and a sum;
    x read and y written once, the state in and out."""
    return float(T * L * (2 + 4 * N)), 4.0 * (2 * T * L + 2 * L * N)


def sm_clock_mhz() -> float:
    """The card's highest SM clock, ``nvidia-smi``'s ``clocks.max.sm``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return 1980.0  # the H100 SXM's


def chain_floor_ms(T: int, clock_mhz: float) -> float:
    """T steps of the scan's dependent chain (``CHAIN_OPS`` operations of
    ``FP32_LATENCY_CYCLES`` each) at the SM clock: the least time any
    sequential evaluation of the recurrence takes."""
    return T * CHAIN_OPS * FP32_LATENCY_CYCLES / (clock_mhz * 1e3)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of ``a`` that differ from ``b`` (-1 for another shape)."""
    return int((a != b).sum()) if a.shape == b.shape else -1


def _rel64(b, a, x: torch.Tensor, y: torch.Tensor, zi) -> float:
    """The largest |y - lfilter in float64| over the largest |reference|."""
    from scipy.signal import lfilter

    xn = x.cpu().numpy()
    xn = xn.astype(np.complex128 if np.iscomplexobj(xn) else np.float64)
    if zi is None:
        ref = lfilter(b, a, xn, axis=0)
    else:  # the TDF2 state is scipy's zi along the last axis
        ref = lfilter(b, a, xn, axis=0, zi=np.moveaxis(zi.cpu().numpy().astype(np.float64), -1, 0))[0]
    return float(np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max())


def iir_against_plain(b, a, x: torch.Tensor, axis: int, zi=None, reps: int = 0) -> dict:
    """The kernel (``iir.iir_scan`` on a CUDA tensor) against
    ``iir.iir_scan_plain`` on the same card tensors, outputs and final state
    by ``torch.equal``, its float64 error (:func:`_rel64`), and with ``reps``
    its CUDA-event ms beside the plain loop's (one call)."""
    from ..ops import iir
    from ..ops.cuda import _build

    xm = x.movedim(axis, 0)
    zi_d = None if zi is None else zi.to(x.device)
    _build.launch_counts.clear()
    y, s = iir.iir_scan(b, a, xm, zi_d)
    launches = _build.launch_counts.get("iir_scan", 0)
    py, ps = iir.iir_scan_plain(b, a, xm, zi_d)
    _sync(x.device)
    out = dict(shape=tuple(xm.shape), dtype=str(x.dtype).replace("torch.", ""), N=len(a) - 1, launches=launches,
               equal=bool(torch.equal(y, py) and torch.equal(s, ps)), y_mismatches=_mismatches(y, py),
               state_mismatches=_mismatches(s, ps),
               max_abs_err=float(max((y - py).abs().max(), (s - ps).abs().max())),
               rel64=_rel64(b, a, xm, y, zi))
    if reps:
        L = xm[0].numel() * (2 if x.is_complex() else 1)
        ops, nbytes = scan_work(xm.shape[0], L, len(a) - 1)
        out.update(ms=events_ms(lambda: iir.iir_scan(b, a, xm, zi_d), reps),
                   plain_ms=events_ms(lambda: iir.iir_scan_plain(b, a, xm, zi_d), 1), ops=ops, bytes=nbytes,
                   lanes=L)
    return out


def stream_chunks(b, a, x: torch.Tensor, zi: torch.Tensor) -> dict:
    """Two chunks of the streaming fallback with the state carried, by the
    kernel and by the plain loop: each chunk's output and state equal, and
    the two chunks equal to one pass over both (all by ``torch.equal``)."""
    from ..ops import iir

    T = x.shape[0] // 2
    zi = zi.to(x.device)
    y1, s1 = iir.iir_scan(b, a, x[:T], zi)
    y2, s2 = iir.iir_scan(b, a, x[T:], s1)
    p1, q1 = iir.iir_scan_plain(b, a, x[:T], zi)
    p2, q2 = iir.iir_scan_plain(b, a, x[T:], q1)
    yw, sw = iir.iir_scan(b, a, x, zi)
    return dict(shape=tuple(x.shape), chunks_equal=bool(torch.equal(y1, p1) and torch.equal(s1, q1)
                                                        and torch.equal(y2, p2) and torch.equal(s2, q2)),
                one_pass_equal=bool(torch.equal(torch.cat([y1, y2]), yw) and torch.equal(s2, sw)),
                max_abs_err=float(max((y1 - p1).abs().max(), (y2 - p2).abs().max(), (s2 - q2).abs().max())),
                rel64=_rel64(b, a, x, torch.cat([y1, y2]), zi))


def sim_work(T: int, B: int, N: int, records: int, rec_rows: int = 0, dense: bool = False) -> tuple[float, float]:
    """(int32 operations, bytes) of one ``xylo_sim`` call: the LIF count
    kernels' 10 operations a neuron and step (``P1_OPS_PER_STEP``); the
    (T, B, N) int32 input current read once and ``records`` (T, B, N) int32
    records written once, the state (three (B, N)) in and out and the
    counts.  With a ``dense`` ``w_rec`` also the recurrence: each step's
    spiking rows added into the N recurrent inputs of the next (``rec_rows``
    nonzero spike entries that feed a step, × N int32 additions, as K3's
    bound counts set bits × N) and ``w_rec``'s N × N int32 read once."""
    from ..ops.cuda.roofline_kernel import P1_OPS_PER_STEP

    ops = float(P1_OPS_PER_STEP * T * B * N) + (float(rec_rows) * N if dense else 0.0)
    return ops, 4.0 * T * B * N * (1 + records) + 4.0 * B * N * 7 + (4.0 * N * N if dense else 0.0)


def sim_launches(counts) -> int:
    """The simulator's launches in a ``launch_counts``: every kernel named
    ``xylo_sim...`` (the flat, the row and the on-chip kernels; an older
    tree's one name too, so that this module runs in a parent's tree)."""
    return sum(v for k, v in counts.items() if k.startswith("xylo_sim"))


def held_recurrence(sim, w_rec):
    """``(rec_coef, w_rec)`` as the models hold them (``sim.held_recurrence``:
    a dense matrix whose array for the card is built once), or as given in a
    tree whose ``sim`` has no such form."""
    return getattr(sim, "held_recurrence", sim.recurrence)(w_rec)


def hidden_scan(cluster=None):
    """The hidden layer's scan: ``sim.scan_hidden`` (the plan's kernel), or
    with ``cluster`` a dense ``w_rec`` on that many CTAs a row."""
    from ..models.xylo import sim

    if cluster is None:
        return sim.scan_hidden
    from ..ops.cuda import sim_kernel

    return lambda *args, **kw: sim_kernel.scan_hidden(*args, cluster=cluster, **kw)


def sim_against_plain(cfg, spikes_tbc: torch.Tensor, ordering: str, reset: str, split: bool = False,
                      clusters=(None,)) -> dict:
    """``XyloSim``'s two scans on ``spikes_tbc`` (T, B, n_in) int32 on the
    card, the hidden layer with every record, counts and state, then the
    readout on its spikes: the kernel (``sim.scan_hidden``) against
    ``sim.scan_hidden_plain`` on the same card tensors, by ``torch.equal``.
    With ``split`` also two halves carried against one pass (kernel).
    ``clusters``: the hidden layer once for each (None: the plan's kernel;
    an int: a dense ``w_rec`` on that many CTAs a row), each against the
    one plain run; the result's keys for c are suffixed ``@c``.  The
    kernel takes the dense ``w_rec`` as the models hold it
    (``sim.held_recurrence``)."""
    from ..models.xylo import sim
    from ..ops.cuda import _build

    inp = sim.project_input(cfg, spikes_tbc)
    rec_coef, w_rec = sim.recurrence(cfg.w_rec)
    args = (cfg.dash_syn, cfg.dash_mem, cfg.threshold)
    kw = dict(rec_coef=rec_coef, w_rec=w_rec, ordering=ordering, reset=reset, record=True, record_state=True,
              count=True)
    want = sim.scan_hidden_plain(inp, *args, **kw)
    kw["w_rec"] = held_recurrence(sim, cfg.w_rec)[1]
    ro_args = (cfg.dash_syn_out, cfg.dash_mem_out, cfg.threshold_out)
    ro_kw = dict(ordering=ordering, reset=reset)
    out = dict(shape=tuple(inp.shape), spikes=int(want[1].sum()))
    for c in clusters:
        _build.launch_counts.clear()
        got = hidden_scan(c)(inp, *args, **kw)
        ro_in = sim.int_matmul(got[0], cfg.w_out)
        ro = sim.scan_hidden(ro_in, *ro_args, **ro_kw)
        counts = dict(_build.launch_counts)
        ro_want = sim.scan_hidden_plain(ro_in, *ro_args, **ro_kw)
        pairs = {"spikes": (got[0], want[0]), "counts": (got[1], want[1]),
                 "Isyn": (got[3]["Isyn"], want[3]["Isyn"]), "Vmem": (got[3]["Vmem"], want[3]["Vmem"]),
                 "readout": (ro[0], ro_want[0])}
        pairs.update({f"state {n}": (g, w) for n, g, w in zip(("isyn", "vmem", "spk"), got[2], want[2])})
        pairs.update({f"readout state {n}": (g, w) for n, g, w in zip(("isyn", "vmem", "spk"), ro[2], ro_want[2])})
        _sync(inp.device)
        sfx = "" if c is None else f"@{c}"
        out[f"launches{sfx}"] = sim_launches(counts)
        out[f"kernels{sfx}"] = {k: v for k, v in counts.items() if k.startswith("xylo_sim")}
        out[f"mismatches{sfx}"] = {k: _mismatches(g, w) for k, (g, w) in pairs.items()}
        del got, ro, ro_want, pairs
    out["equal"] = not any(any(v.values()) for k, v in out.items() if k.startswith("mismatches"))
    if split:
        got = sim.scan_hidden(inp, *args, **kw)
        T = inp.shape[0] // 2
        a1 = sim.scan_hidden(inp[:T], *args, **kw)
        a2 = sim.scan_hidden(inp[T:], *args, a1[2], **kw)
        out["halves_equal"] = bool(torch.equal(torch.cat([a1[0], a2[0]]), got[0])
                                   and torch.equal(torch.cat([a1[3]["Vmem"], a2[3]["Vmem"]]), got[3]["Vmem"])
                                   and all(torch.equal(p, q) for p, q in zip(a2[2], got[2])))
    return out


def sim_times(cfg, spikes_tbc: torch.Tensor, reps: int) -> dict:
    """The hidden-layer scan with its three records, by the kernel (CUDA
    events over ``reps`` calls) and by the plain loop (one call), and the
    kernel's operations and bytes (:func:`sim_work`); the kernel takes a
    dense ``w_rec`` as the models hold it (``sim.held_recurrence``)."""
    from ..models.xylo import sim

    inp = sim.project_input(cfg, spikes_tbc)
    rec_coef, w_rec = sim.recurrence(cfg.w_rec)
    held = held_recurrence(sim, cfg.w_rec)[1]
    kw = dict(rec_coef=rec_coef, record=True, record_state=True)
    args = (inp, cfg.dash_syn, cfg.dash_mem, cfg.threshold)
    T, B, N = inp.shape
    ops, nbytes = sim_work(T, B, N, 3)
    return dict(ms=events_ms(lambda: sim.scan_hidden(*args, w_rec=held, **kw), reps),
                plain_ms=events_ms(lambda: sim.scan_hidden_plain(*args, w_rec=w_rec, **kw), 1),
                ops=ops, bytes=nbytes, shape=(T, B, N))


def push_to_hidden_block(pdemo, seed: int = SEED):
    """``(psim, block config)``: ``pdemo``'s push-to-hidden simulator with a
    sparse random stage-2 recurrence R from ``seed`` (the fan-out truncation
    zeroes the flagship's own), and its one-layer form with the dense
    ``w_rec = [[0, W], [0, R]]``."""
    import dataclasses

    from ..models.xylo.sim import XyloSimPushToHidden

    p1 = pdemo.xylo
    n2 = p1.n_stage2
    rng = np.random.default_rng(seed)
    r = (rng.integers(-3, 4, size=(n2, n2)) * (rng.random((n2, n2)) < 0.2)).astype(np.int32)
    psim = XyloSimPushToHidden(dataclasses.replace(pdemo.xylo_config, w_rec=r), p1.injection_weight, p1.dash_syn_in,
                               p1.dash_mem_in, p1.threshold_in, device=p1.device)
    return psim, psim.block_config()


def kernel_split(fn, reps: int, prefix: str) -> dict:
    """The launches of kernels named ``prefix...`` in ``reps`` traced calls
    of ``fn``: launches a call and the mean, min and max device ms of a
    launch (CUPTI's records), and their device ms a call."""
    tr = {k: v for k, v in traced_ms(fn, reps).items() if k.startswith(prefix)}
    if not tr:
        raise RuntimeError(f"no {prefix} launch in the trace")
    rec = [ms for v in tr.values() for ms in v]
    calls = launches_a_call(rec, reps)
    return dict(kernels=sorted(tr), launches_a_call=calls, mean_ms=float(np.mean(rec)), min_ms=float(np.min(rec)),
                max_ms=float(np.max(rec)), device_ms=float(np.mean(rec) * calls))


def iir_split(b, a, x: torch.Tensor, axis: int, zi, reps: int, clock_mhz: float) -> dict:
    """One ``iir_scan`` call on the case, traced: :func:`kernel_split` and
    the launch's cycles a step at ``clock_mhz`` beside the chain floor's
    ``CHAIN_OPS * FP32_LATENCY_CYCLES``."""
    from ..ops import iir

    xm = x.movedim(axis, 0)
    T = xm.shape[0] // (2 if zi is not None else 1)  # the carried stream: one chunk
    xm = xm[:T]
    zi_d = None if zi is None else zi.to(x.device)
    out = kernel_split(lambda: iir.iir_scan(b, a, xm, zi_d), reps, "iir_scan")
    out.update(shape=tuple(xm.shape), N=len(a) - 1, lanes=xm[0].numel() * (2 if x.is_complex() else 1),
               cycles_a_step=out["mean_ms"] * 1e3 * clock_mhz / T, chain_cycles=CHAIN_OPS * FP32_LATENCY_CYCLES,
               chain_floor_ms=chain_floor_ms(T, clock_mhz))
    out["chain_share"] = out["chain_floor_ms"] / out["mean_ms"]
    return out


def sim_split(cfg, spikes_tbc: torch.Tensor, reps: int, records: int = 3, cluster=None, clock_mhz=None) -> dict:
    """One hidden-layer ``xylo_sim`` call traced, with ``records`` of the
    three records on (3: spikes, Isyn, Vmem; 1: spikes; 0: the counts
    alone): :func:`kernel_split`, its bytes (:func:`sim_work`), bytes a
    second and the share of the bytes bound.  With a recurrence also the
    launch's cycles a step at ``clock_mhz``, its bound by operations or
    bytes and the share; ``cluster``: a dense ``w_rec`` on that many CTAs a
    row (:func:`hidden_scan`), as the models hold it."""
    from ..models.xylo import sim

    inp = sim.project_input(cfg, spikes_tbc)
    rec_coef, w_rec = held_recurrence(sim, cfg.w_rec)
    kw = dict(rec_coef=rec_coef, w_rec=w_rec, record=records > 0, record_state=records == 3, count=records == 0)
    args = (inp, cfg.dash_syn, cfg.dash_mem, cfg.threshold)
    T, B, N = inp.shape
    rows = 0
    if w_rec is not None:  # the spike entries that feed a step's recurrence: every step's but the last's
        spikes = sim.scan_hidden(*args, rec_coef=rec_coef, w_rec=w_rec, record=True)[0]
        rows = int((spikes[:-1] != 0).sum())
        del spikes
    ops, nbytes = sim_work(T, B, N, records, rows, dense=w_rec is not None)
    scan = hidden_scan(cluster)
    out = kernel_split(lambda: scan(*args, **kw), reps, "xylo_sim")
    out.update(shape=(T, B, N), records=records, recurrence="dense" if w_rec is not None else f"uniform {rec_coef}",
               bytes=nbytes, bytes_per_s=nbytes / (out["device_ms"] * 1e-3),
               bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops=ops, rec_rows=rows, cluster=cluster)
    out["bound_share"] = out["bytes_bound_ms"] / out["device_ms"]
    if w_rec is not None or rec_coef:  # int32 operations over 64 a clock × the SMs × the highest SM clock
        from . import roofline

        out["bound_ms"], out["bound_by"] = roofline.bound(ops, roofline.guide_peaks()["int32_ops_per_s"], nbytes)
        out["share"] = out["bound_ms"] / out["device_ms"]
        if clock_mhz:
            out["cycles_a_step"] = out["device_ms"] * 1e3 * clock_mhz / T
            out["clock_mhz"] = clock_mhz
    return out


def iir_by_order(dev: torch.device, reps: int, clock_mhz: float, T: int = 12_000, L: int = 32) -> dict:
    """The scan's cycles a step by its order N = 0-8 on one block of L real
    lanes (``butter(N, 0.3)``; N = 0 a gain): the chain is the same four
    operations at every N >= 1 while the lane's operations grow as 2 + 4N,
    so a time flat in N is the chain's and one that grows is the issue's."""
    from scipy.signal import butter

    from ..ops import iir

    x = torch.as_tensor(np.random.default_rng(SEED).standard_normal((T, L)).astype(np.float32), device=dev)
    out = {}
    for N in range(9):
        b, a = ([0.7], [1.0]) if N == 0 else butter(N, 0.3)
        r = kernel_split(lambda: iir.iir_scan(b, a, x), reps, "iir_scan")
        out[f"N = {N}"] = dict(mean_ms=r["mean_ms"], cycles_a_step=r["mean_ms"] * 1e3 * clock_mhz / T,
                               lane_ops=2 + 4 * N)
    return out


def memory_yardsticks(inp: torch.Tensor, reps: int, records: int = 3) -> dict:
    """What PyTorch's own kernels reach on the simulator's bytes: writing
    ``records`` tensors of ``inp``'s size (``fill_``), reading ``inp`` once
    (``amax``) and writing its negation (``neg``: as many bytes read as
    written; a ``copy_`` would be a memcpy, not a kernel), each launch's
    device ms (CUPTI) and bytes a second; the first two
    summed are the time the card's memory takes for the kernel's bytes moved
    by plain streams, one direction at a time."""
    outs = [torch.empty_like(inp) for _ in range(records)]
    nbytes = inp.numel() * inp.element_size()

    def fill():
        for o in outs:
            o.fill_(1)

    res = {}
    for label, fn, moved in ((f"write {records} records (fill_)", fill, records * nbytes),
                             ("read the current (amax)", lambda: torch.amax(inp), nbytes),
                             ("negate the current (neg)", lambda: torch.neg(inp, out=outs[0]), 2 * nbytes)):
        tr = traced_ms(fn, reps)
        ms = sum(float(np.mean(v)) * launches_a_call(v, reps) for v in tr.values())
        res[label] = dict(device_ms=ms, bytes=float(moved), bytes_per_s=moved / (ms * 1e-3), kernels=sorted(tr))
    return res


def flagship_rasters(dev: torch.device, batch: int = 96):
    """The flagship demo, its (T, B, 28) int32 spike rasters of bench.py's
    frames, and the dense push-to-hidden block config."""
    from ..models.xylo import Demo, DemoPushToHidden
    from ..models.xylo.flagship import flagship_config, flagship_frames

    demo = Demo(**flagship_config(dev))
    frames, _ = flagship_frames(demo, batch, seed=SEED)
    spk = demo.spike_encoding(frames).transpose(0, 1).contiguous()
    _, block = push_to_hidden_block(DemoPushToHidden(**flagship_config(dev)))
    return demo, spk, block


# ------------------------------------------------------------------ the follower and the trackers
ENVELOPE_ARGS = (1e-3, 1e-2, 48_000.0)  # Envelope(rise, fall, fs) of the follower's cases
TRACK_T, TRACK_B, MULTI_K, MULTI_M = 240, 96, 2, 4  # a minute of 0.25 s frames for 96 streams; 2 peaks, 4 tracks
ENV_CHAIN_OPS = 3  # the follower's chain a step: c·s, the sum, the select (the compare runs beside the product)
ENV_OPS_PER_STEP = 6  # |x|, the compare, c·s, (1/w)·x, ·rise, the sum
# one wrap, atan2f(sinf(x), cosf(x)), as operations of the work (the operations bound): sinf's reduction
# and polynomial (about 14 operations; cosf's beside it) and atan2f's quotient, polynomial and quadrant
# fix-ups (about 20), estimated from CUDA's accurate paths for |x| below 10^5.  The chain floors do not use
# it: they take the wrap's latency as the card gives it (wrap_latency)
WRAP_OPS = 34
TRACK_OPS = 3 * WRAP_OPS + 6  # a tracking step: three wraps; θ+ω, z-pred, α·δ, the sum, β·δ, ω's sum
# a chain link is one (float32 add, wrap): x = wrap(x + c), as wrap_latency times it.  Beside its three
# links a tracking frame's chain holds α·δ and the select of θ
TRACK_CHAIN_EXTRA_OPS = 2
WRAP_SMALL, WRAP_LARGE = (0.3, 0.7), (0.3, 2.0e5)  # (x0, c): |x + c| <= 2 pi; past 105 615 (sinf's slow path)
WRAP_CHAIN_STEPS = 4096
RECURRENCE_CASES = ("envelope", "track_angles", "track_multi")


def envelope_inputs(frames: torch.Tensor) -> dict:
    """``{name: x (T, L)}`` of the follower's cases from (B, T, 7) frames on
    their device: one frame, the B frames' microphones as lanes, and one
    frame in float64."""
    B, T, M = frames.shape
    return {f"one frame ({T}, {M}) float32": frames[0].contiguous(),
            f"{B} frames' microphones ({T}, {B * M}) float32": frames.movedim(0, 1).reshape(T, B * M).contiguous(),
            f"one frame ({T}, {M}) float64": frames[0].double()}


def track_inputs(seed: int = SEED, T: int = TRACK_T, B: int = TRACK_B, K: int = MULTI_K):
    """``(z (T, B), zk (T, B, K), valid (T, B, K))`` on the CPU from ``seed``:
    bearings of targets that move at random rates (some across ±pi) with
    measurement noise, outliers and runs of outliers long enough to force
    re-acquisition, and for the multi-target tracker K peaks a frame of two
    such targets or clutter, a fifth of them invalid, and all-invalid
    frames."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    z = rng.uniform(-np.pi, np.pi, B) + rng.uniform(-0.08, 0.08, B) * t + rng.normal(0, 0.02, (T, B))
    out = rng.random((T, B)) < 0.1
    z[out] = rng.uniform(-np.pi, np.pi, out.sum())
    for b in range(0, B, 7):  # a run of outliers in every seventh lane
        t0 = rng.integers(20, T - 10)
        z[t0:t0 + 6, b] += rng.uniform(1.0, 2.0)
    z2 = rng.uniform(-np.pi, np.pi, (1, B, 2)) + rng.uniform(-0.05, 0.05, (1, B, 2)) * t[..., None] \
        + rng.normal(0, 0.02, (T, B, 2))
    zk = np.concatenate([z2, rng.uniform(-np.pi, np.pi, (T, B, max(K - 2, 0)))], axis=-1)[..., :K]
    clutter = rng.random((T, B, K)) < 0.1
    zk[clutter] = rng.uniform(-np.pi, np.pi, clutter.sum())
    valid = rng.random((T, B, K)) >= 0.2
    valid[T // 3:T // 3 + 3] = False
    perm = np.argsort(rng.random((T, B, K)), axis=-1)
    wrap = lambda a: np.angle(np.exp(1j * a)).astype(np.float32)  # noqa: E731
    return (torch.as_tensor(wrap(z)), torch.as_tensor(wrap(np.take_along_axis(zk, perm, axis=-1))),
            torch.as_tensor(np.take_along_axis(valid, perm, axis=-1)))


def envelope_work(T: int, L: int, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one follower call on (T, L) lanes: the
    signal read and the envelope written once, the state in and out."""
    return float(ENV_OPS_PER_STEP * T * L), float(itemsize * (2 * T * L + 2 * L))


def track_work(T: int, L: int) -> tuple[float, float]:
    """(float32 operations, bytes) of one ``track_angles`` call: three wraps
    (``WRAP_OPS`` each) and six more a lane and frame; the angles read and
    the filtered angles written once."""
    return float(TRACK_OPS) * T * L, 8.0 * T * L


def multi_work(T: int, L: int, M: int, K: int) -> tuple[float, float]:
    """(float32 operations, bytes) of one ``track_multi_angles`` call: a
    wrap a slot (the prediction), a wrap a slot and measurement (the cost),
    a wrap a slot (the update) and the assignment's min(M, K) scans of M·K
    costs; z (float32) and valid (bool) read, thetas (float32) and
    confirmed (bool) written once."""
    ops = (2 * M + M * K) * WRAP_OPS + min(M, K) * 2 * M * K + 8 * M
    return float(ops * T * L), float(T * L * (5 * K + 5 * M))


def envelope_chain_ms(T: int, clock_mhz: float, latency: int = FP32_LATENCY_CYCLES) -> float:
    """T - 1 steps of the follower's chain (``ENV_CHAIN_OPS`` operations of
    ``latency`` cycles) at the SM clock."""
    return (T - 1) * ENV_CHAIN_OPS * latency / (clock_mhz * 1e3)


def envelope_chain_latency(env, dtype, n: int = WRAP_CHAIN_STEPS) -> float:
    """Cycles a step of the follower's chain as the card runs it
    (``envelope_kernel.chain_cycles``: one warp, ``n`` of the kernel's
    steps from registers between two ``clock64`` reads, after a short chain
    that warms the instruction cache)."""
    from ..ops.cuda import envelope_kernel

    envelope_kernel.chain_cycles(env, dtype, 64)
    return envelope_kernel.chain_cycles(env, dtype, n)


def track_chain_cycles(link_cycles: float) -> float:
    """A tracking frame's dependent chain in cycles: three links (an add and
    a wrap, ``link_cycles`` as :func:`wrap_latency` measures them) and
    ``TRACK_CHAIN_EXTRA_OPS`` float32 operations."""
    return 3 * link_cycles + TRACK_CHAIN_EXTRA_OPS * FP32_LATENCY_CYCLES


def track_chain_ms(T: int, clock_mhz: float, link_cycles: float) -> float:
    """T frames of a tracking lane's chain (:func:`track_chain_cycles`) at
    the SM clock."""
    return T * track_chain_cycles(link_cycles) / (clock_mhz * 1e3)


def multi_chain_ops(M: int, K: int) -> int:
    """A multi-target frame's dependent float32 and integer operations
    beside its three links (the prediction's, a cost's, the update's; the K
    costs of a slot are independent): a cost's |.|, the gate's compare and
    the select; min(M, K) rounds of a minimum over M·K costs (a tree of
    ceil(log2(M·K)) compares and selects, the least depth any evaluation
    has) and the closing of its row and column; α·δ and the update's select;
    the spawn's two selects."""
    depth = max(1, int(np.ceil(np.log2(M * K))))
    return 3 + min(M, K) * (2 * depth + 1) + 2 + 2


def multi_chain_cycles(M: int, K: int, link_cycles: float) -> float:
    return 3 * link_cycles + multi_chain_ops(M, K) * FP32_LATENCY_CYCLES


def multi_chain_ms(T: int, M: int, K: int, clock_mhz: float, link_cycles: float) -> float:
    return T * multi_chain_cycles(M, K, link_cycles) / (clock_mhz * 1e3)


def wrap_latency(n: int = WRAP_CHAIN_STEPS) -> dict:
    """The wrap's latency on the card: one thread's chain ``x = form(x +
    c)``, ``n`` steps between two ``clock64`` reads (``track_kernel.
    wrap_chain``), for every form of ``track_kernel.WRAP_FORMS`` at
    arguments |x| <= 2 pi (``WRAP_SMALL``) and past 105 615, where the
    accurate sine reduces by its slow path (``WRAP_LARGE``): cycles a step
    (each step one float32 add more than the form), after a short chain
    that warms the instruction cache."""
    from ..ops.cuda import track_kernel

    _require_cuda()
    out = {}
    for form in track_kernel.WRAP_FORMS:
        out[form] = {}
        for label, (x0, c) in (("|x| <= 2 pi", WRAP_SMALL), ("past 105 615", WRAP_LARGE)):
            track_kernel.wrap_chain(x0, c, 64, form)
            _, cycles = track_kernel.wrap_chain(x0, c, n, form)
            out[form][label] = cycles / n
    return out


def wrap_bits(form: str = "wrap", stride: int = 1, chunk: int = 1 << 28) -> dict:
    """The kernels' wrap form ``form`` (``track_kernel.wrap_apply``) against
    PyTorch's ``atan2(sin x, cos x)`` on the card at every ``stride``-th
    float32 bit pattern (1: all 2^32), ``chunk`` patterns at a time:
    values that differ (NaN equal to NaN, as :func:`same_bits`), bit
    patterns that differ outside NaN (the sign of a zero), the patterns
    checked and the seconds."""
    import time

    from ..ops.cuda import track_kernel

    dev = _require_cuda()
    t0 = time.perf_counter()
    differ = bits_differ = checked = 0
    span = chunk * stride
    for lo in range(-(1 << 31), 1 << 31, span):
        x = torch.arange(lo, min(lo + span, 1 << 31), stride, dtype=torch.int64, device=dev).to(torch.int32)
        x = x.view(torch.float32)
        want = torch.atan2(torch.sin(x), torch.cos(x))
        got = track_kernel.wrap_apply(x, form)
        nan = got.isnan() & want.isnan()
        differ += int((~((got == want) | nan)).sum())
        bits_differ += int(((got.view(torch.int32) != want.view(torch.int32)) & ~nan).sum())
        checked += x.numel()
        del x, want, got, nan
    torch.cuda.synchronize(dev)
    return dict(form=form, stride=stride, checked=checked, differ=differ, bits_differ=bits_differ,
                s=time.perf_counter() - t0)


TRACK_KERNELS = ("track_angles_kernel", "track_multi_kernel")


def kernel_resources(log: str, names=TRACK_KERNELS) -> dict:
    """``{kernel[<template argument>]: {registers, stack, spill_stores,
    spill_loads}}`` of the kernels named ``names`` from a build log's
    ``ptxas -v`` report (``_build``'s ``<library>.log``)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            mangled = m.group(1)
            name = next((n for n in names if n in mangled), None)
            if name is None:
                cur = None
                continue
            arg = re.search(re.escape(name) + r"I((?:L\w\d+E)+)E", mangled)
            targs = ", ".join(re.findall(r"L\w(\d+)E", arg.group(1))) if arg else ""
            cur = out.setdefault(name + (f"<{targs}>" if arg else ""), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def build_resources(names=TRACK_KERNELS) -> dict:
    """:func:`kernel_resources` of the built library's log."""
    from ..ops.cuda import _build

    return kernel_resources(_build.library_path().with_suffix(".log").read_text(), names)


def tracker_sass(listing=None) -> dict:
    """Each tracking kernel's SASS (:func:`kernel_sass` of
    ``csrc/tracking.cu``): its instructions, its local loads and stores
    (``LDL``, ``STL``), calls, branches and reconvergence points; with
    ``listing`` (a path) every instruction written there, kernel by
    kernel."""
    cu = Path(__file__).resolve().parent.parent / "csrc" / "tracking.cu"
    out, text = {}, []
    for name in TRACK_KERNELS:
        for inst, ins in kernel_sass(cu, name).items():
            ops = [_opcode(i) for i in ins]
            out[inst] = dict(instructions=len(ins), **{op: ops.count(op) for op in SASS_COUNTED})
            text += [f"== {inst}"] + [f"{i:5d} {x}" for i, x in enumerate(ins)]
    if listing:
        Path(listing).write_text("\n".join(text) + "\n")
    return out


SASS_COUNTED = ("LDL", "STL", "CALL", "BRA", "BSSY", "MUFU", "SHFL", "REDUX", "VOTE")


def _opcode(ins: str) -> str:
    """A SASS instruction's opcode without its modifiers or predicate."""
    toks = ins.split()
    return (toks[1] if toks[0].startswith("@") and len(toks) > 1 else toks[0]).split(".")[0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal`` with NaN taken equal to NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(((a == b) | (a.isnan() & b.isnan())).all())


def once_ms(fn, timed: bool):
    """``(fn(), its ms)``: with ``timed`` CUDA events around the one call,
    else ``None`` for the time (a plain loop is run once, for its outputs and
    its time alike)."""
    if not timed:
        return fn(), None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _counted(name: str, fn):
    """``(fn(), launches of kernel name)`` with the counts set to 0 first."""
    from ..ops.cuda import _build

    _build.launch_counts.clear()
    out = fn()
    return out, _build.launch_counts.get(name, 0)


def envelope_against_plain(x: torch.Tensor, state=None, reps: int = 0, env_args=ENVELOPE_ARGS) -> dict:
    """``Envelope.evolve`` on a CUDA tensor (the kernel) against
    ``evolve_plain`` on the same tensors: outputs and final state by
    :func:`same_bits`, the kernel's launches, and with ``reps`` its
    CUDA-event ms beside the plain loop's (one call)."""
    from ..ops.envelope import Envelope

    env = Envelope(*env_args)
    (y, s), launches = _counted("envelope", lambda: env.evolve(x, state, return_state=True))
    (py, ps), plain_ms = once_ms(lambda: env.evolve_plain(x, state, return_state=True), bool(reps))
    _sync(x.device)
    out = dict(shape=tuple(x.shape), dtype=str(x.dtype).replace("torch.", ""), launches=launches,
               equal=same_bits(y, py) and same_bits(s, ps),
               mismatches=int((~((y == py) | (y.isnan() & py.isnan()))).sum()),
               max_abs_err=float((y - py).abs().nan_to_num(0.0).max()) if y.numel() else 0.0)
    if reps:
        ops, nbytes = envelope_work(x.shape[0], x[0].numel(), x.element_size())
        out.update(ms=events_ms(lambda: env.evolve(x, state), reps), plain_ms=plain_ms, ops=ops, bytes=nbytes)
    return out


def track_against_plain(z: torch.Tensor, reps: int = 0, **kw) -> dict:
    """``track_angles`` on a CUDA tensor (the kernel) against
    ``track_angles_plain`` on the same tensor by ``torch.equal``, the
    launches, and with ``reps`` the CUDA-event ms beside the plain loop's."""
    from ..utils import tracking

    got, launches = _counted("track_angles", lambda: tracking.track_angles(z, device=z.device, **kw))
    want, plain_ms = once_ms(lambda: tracking.track_angles_plain(z, device=z.device, **kw), bool(reps))
    _sync(z.device)
    out = dict(shape=tuple(z.shape), launches=launches, equal=bool(torch.equal(got, want)),
               mismatches=_mismatches(got, want),
               max_abs_err=float((got - want).abs().max()) if got.numel() else 0.0)
    if reps:
        ops, nbytes = track_work(z.shape[0], z[0].numel())
        out.update(ms=events_ms(lambda: tracking.track_angles(z, device=z.device, **kw), reps), plain_ms=plain_ms,
                   ops=ops, bytes=nbytes)
    return out


def multi_against_plain(z: torch.Tensor, valid: torch.Tensor, num_tracks: int, reps: int = 0, **kw) -> dict:
    """``track_multi_angles`` on CUDA tensors (the kernel) against
    ``track_multi_angles_plain``: thetas and confirmed by ``torch.equal``,
    the launches, the confirmed tracks of the last frame, and with ``reps``
    the CUDA-event ms beside the plain loop's."""
    from ..utils import tracking

    def kernel():
        return tracking.track_multi_angles(z, valid, num_tracks, device=z.device, **kw)

    def plain():
        return tracking.track_multi_angles_plain(z, valid, num_tracks, device=z.device, **kw)

    (th, cf), launches = _counted("track_multi", kernel)
    (pth, pcf), plain_ms = once_ms(plain, bool(reps))
    _sync(z.device)
    out = dict(shape=tuple(z.shape), M=num_tracks, launches=launches,
               equal=bool(torch.equal(th, pth) and torch.equal(cf, pcf)), theta_mismatches=_mismatches(th, pth),
               confirmed_mismatches=_mismatches(cf, pcf), confirmed=int(pcf.sum()),
               max_abs_err=float((th - pth).abs().max()) if th.numel() else 0.0)
    if reps:
        ops, nbytes = multi_work(z.shape[0], z[0, ..., 0].numel(), num_tracks, z.shape[-1])
        out.update(ms=events_ms(kernel, reps), plain_ms=plain_ms, ops=ops, bytes=nbytes)
    return out


def recurrence_split(frames: torch.Tensor, reps: int, clock_mhz: float, only=None) -> dict:
    """The follower's and the trackers' launches at their cases, traced
    (:func:`kernel_split`), each beside its chain floor, bytes and bytes
    bound; ``only``: of ``RECURRENCE_CASES``."""
    from ..ops.envelope import Envelope
    from ..utils import tracking

    dev = frames.device
    out = {}
    if only is None or "envelope" in only:
        env = Envelope(*ENVELOPE_ARGS)
        for name, x in envelope_inputs(frames).items():
            r = kernel_split(lambda: env.evolve(x), reps, "envelope_kernel")
            T, L = x.shape
            latency = FP64_LATENCY_CYCLES if x.dtype == torch.float64 else FP32_LATENCY_CYCLES
            r.update(shape=(T, L), chain_floor_ms=envelope_chain_ms(T, clock_mhz, latency),
                     bytes=envelope_work(T, L, x.element_size())[1], cycles_a_step=r["mean_ms"] * 1e3 * clock_mhz / T,
                     chain_cycles=ENV_CHAIN_OPS * latency, step_cycles=envelope_chain_latency(env, x.dtype))
            out[f"envelope {name}"] = r
    z, zk, valid = (t.to(dev) for t in track_inputs())
    T, B = z.shape
    if only is None or {"track_angles", "track_multi"} & set(only):
        link = wrap_latency()["wrap"]["|x| <= 2 pi"]  # the chain floors' link, measured on this card
    if only is None or "track_angles" in only:
        r = kernel_split(lambda: tracking.track_angles(z, device=dev), reps, "track_angles_kernel")
        r.update(shape=(T, B), chain_floor_ms=track_chain_ms(T, clock_mhz, link), bytes=track_work(T, B)[1],
                 cycles_a_frame=r["mean_ms"] * 1e3 * clock_mhz / T, chain_cycles=track_chain_cycles(link),
                 link_cycles=link)
        out[f"track_angles ({T}, {B})"] = r
    if only is None or "track_multi" in only:
        r = kernel_split(lambda: tracking.track_multi_angles(zk, valid, MULTI_M, device=dev), reps,
                         "track_multi_kernel")
        r.update(shape=(T, B, MULTI_K), M=MULTI_M, chain_floor_ms=multi_chain_ms(T, MULTI_M, MULTI_K, clock_mhz, link),
                 bytes=multi_work(T, B, MULTI_M, MULTI_K)[1], cycles_a_frame=r["mean_ms"] * 1e3 * clock_mhz / T,
                 chain_cycles=multi_chain_cycles(MULTI_M, MULTI_K, link), link_cycles=link)
        out[f"track_multi ({T}, {B}, {MULTI_K}), {MULTI_M} tracks"] = r
    for r in out.values():
        r["bytes_bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["chain_share"] = r["chain_floor_ms"] / r["mean_ms"]
    return out


SIM_CASES = ("flagship, 3 records", "flagship, spikes only", "flagship, counts only", "uniform w_rec = -1, 3 records",
             "dense push-to-hidden block, 3 records", "one row, 3 records")
SIM_DENSE = "dense push-to-hidden block, 3 records"  # the case --clusters sweeps


def split(reps: int = 20, only=None, pad_mib: int = 0, clusters=()) -> dict:
    """Both kernels' device times by CUPTI at every case (module docstring);
    with ``only`` (labels of ``SIM_CASES``) those simulator cases alone.
    ``pad_mib``: a device tensor of that many MiB allocated first, so that
    every later tensor lands elsewhere in device memory (how much of a time
    its inputs' and outputs' placement decides).  ``clusters``: the dense
    block (:data:`SIM_DENSE`) once more at each cluster size through the
    on-chip kernel, labelled ``"..., c = C"``."""
    import dataclasses

    dev = _require_cuda()
    pad = torch.empty(pad_mib << 20, dtype=torch.uint8, device=dev) if pad_mib else None  # noqa: F841
    clock = sm_clock_mhz()
    out = {"card": card_line(), "clock_mhz": clock, "pad_mib": pad_mib, "iir_scan": {}, "xylo_sim": {}}
    if only is None:
        for name, (b, a, x, axis, zi) in iir_inputs().items():
            out["iir_scan"][name] = iir_split(b, a, x.to(dev), axis, zi, reps, clock)
    elif set(only) - set(SIM_CASES) - set(RECURRENCE_CASES):
        raise ValueError(f"unknown cases {sorted(set(only) - set(SIM_CASES) - set(RECURRENCE_CASES))}: the cases "
                         f"are {SIM_CASES + RECURRENCE_CASES}")
    if only is None or set(only) & set(RECURRENCE_CASES):
        from ..models.xylo import Demo
        from ..models.xylo.flagship import flagship_config, flagship_frames

        frames, _ = flagship_frames(Demo(**flagship_config(dev)), TRACK_B, seed=SEED)
        out["recurrences"] = recurrence_split(frames, reps, clock, None if only is None else set(only))
        if only is not None and not set(only) & set(SIM_CASES):
            return out
    demo, spk, block = flagship_rasters(dev)
    uniform = dataclasses.replace(demo.xylo_config, w_rec=np.full_like(np.asarray(demo.xylo_config.w_rec), -1))
    sim_reps = max(2, reps // 4)
    cases = dict(zip(SIM_CASES, ((demo.xylo_config, spk, 3), (demo.xylo_config, spk, 1), (demo.xylo_config, spk, 0),
                                 (uniform, spk, 3), (block, spk, 3), (demo.xylo_config, spk[:, :1].contiguous(), 3))))
    for label, (cfg, x, records) in cases.items():
        if only is None or label in only:
            out["xylo_sim"][label] = sim_split(cfg, x, sim_reps, records, clock_mhz=clock)
            for c in clusters if label == SIM_DENSE else ():
                out["xylo_sim"][f"{label}, c = {c}"] = sim_split(cfg, x, sim_reps, records, cluster=c,
                                                                  clock_mhz=clock)
    if only is None:
        out["iir_scan by order"] = iir_by_order(dev, reps, clock)
        from ..models.xylo import sim

        out["memory yardsticks"] = memory_yardsticks(sim.project_input(demo.xylo_config, spk), sim_reps)
    return out


def kernel_sass(cu: Path, name: str) -> dict:
    """``{instantiation: [instruction, ...]}`` of the kernels whose mangled
    name holds ``name`` in ``cu`` compiled to a cubin with the library's
    flags (``_build.NVCC_FLAGS``), from ``cuobjdump -sass``, each line's
    address comment and the instantiation's namespace prefix left out
    (an anonymous namespace's name holds the file's path)."""
    from ..ops.cuda import _build

    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(cubin), str(cu)], check=True,
                       capture_output=True, text=True)
        text = subprocess.run(["cuobjdump", "-sass", str(cubin)], check=True, capture_output=True, text=True).stdout
    return parse_sass(text, name)


def parse_sass(text: str, name: str) -> dict:
    """:func:`kernel_sass` of ``cuobjdump -sass``'s ``text``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inst = re.search(re.escape(name) + r"(\w*)", m.group(1))
            cur = out.setdefault(name + inst.group(1), []) if inst else None
        elif cur is not None:
            ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if ins:
                cur.append(ins.group(1))
    return out


SASS_INSTRUCTION_BYTES = 16  # every Hopper instruction: the n-th of a kernel lies at address 16 n


def innermost_loops(code) -> list:
    """The innermost loops of one kernel's instructions (:func:`kernel_sass`):
    for each backward branch (a ``BRA`` to an address before its own; the
    branch to itself after ``EXIT`` is no loop) whose span holds no other
    backward branch, ``{first, last, instructions, opcodes}`` (the span's
    addresses, and its count of each opcode, :func:`_opcode`)."""
    spans = []
    for i, ins in enumerate(code):
        m = re.search(r"\bBRA\b[^;]*?\b0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) <= i * SASS_INSTRUCTION_BYTES:
            spans.append((int(m.group(1), 16), i * SASS_INSTRUCTION_BYTES))
    out = []
    for lo, hi in spans:
        if lo == hi or any(lo <= a <= b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue
        body = [_opcode(ins) for ins in code[lo // SASS_INSTRUCTION_BYTES:hi // SASS_INSTRUCTION_BYTES + 1]]
        out.append(dict(first=hex(lo), last=hex(hi), instructions=len(body),
                        opcodes=dict(sorted(collections.Counter(body).items(), key=lambda kv: -kv[1]))))
    return out


# the SASS opcodes counted for the simulator's recurrent kernels: shared loads and stores, atomics (shared,
# generic: distributed shared memory), barriers, ballots, shuffles, byte permutes and global loads
SIM_SASS_COUNTED = ("LDS", "STS", "ATOMS", "ATOM", "RED", "BAR", "UCGABAR_ARV", "UCGABAR_WAIT", "VOTE", "SHFL",
                    "PRMT", "LDG", "STG", "LDGSTS", "BRA")
# the SASS opcodes counted for the follower: global and shared loads and stores, asynchronous copies, barriers,
# branches, the integer work of a counter or an address, and the step's float operations
ENV_SASS_COUNTED = ("LDG", "STG", "LDS", "STS", "LDGSTS", "BAR", "MEMBAR", "BRA", "ISETP", "IADD3", "IMAD", "LEA",
                    "MOV", "FMUL", "FADD", "FSETP", "FSEL", "DMUL", "DADD", "DSETP", "SEL")
# sass --kernel: each kernel's source in csrc/, the names of its kernels and the opcodes counted
SASS_KERNELS = {
    "xylo_sim": ("xylo_sim.cu", ("xylo_sim_kernel", "xylo_sim_onchip_kernel"), SIM_SASS_COUNTED),
    "envelope": ("envelope.cu", ("envelope_kernel",), ENV_SASS_COUNTED),
}


def sass_against(other, kernel: str = "xylo_sim", listing=None) -> dict:
    """This tree's source of ``kernel`` (:data:`SASS_KERNELS`) against
    ``other`` (another tree's copy of that source; None: this tree alone)
    by :func:`kernel_sass`: for each instantiation of the source's kernels
    in either, its instruction counts, how many positions differ, its counts
    of the table's opcodes and its innermost loops (:func:`innermost_loops`)
    in each tree, and its registers and spills from the built library's
    ``ptxas -v`` (:func:`build_resources`; here, where a card is present).
    ``listing``: a path that receives each tree's instructions with their
    addresses, instantiation by instantiation."""
    source, names, counted = SASS_KERNELS[kernel]
    cu = Path(__file__).resolve().parent.parent / "csrc" / source
    trees = {"here": {k: v for name in names for k, v in kernel_sass(cu, name).items()},
             "other": {k: v for name in names for k, v in kernel_sass(Path(other), name).items()} if other else {}}
    if listing:
        Path(listing).write_text("\n".join(
            f"== {tree} {k}\n" + "\n".join(f"{SASS_INSTRUCTION_BYTES * i:05x} {x}" for i, x in enumerate(v))
            for tree, code in trees.items() for k, v in code.items()) + "\n")
    out = {"card": card_line() if torch.cuda.is_available() else None, "kernels": {},
           "ptxas": build_resources(names) if torch.cuda.is_available() else None}
    mine, theirs = trees["here"], trees["other"]
    for k in sorted(set(mine) | set(theirs)):
        a, b = mine.get(k), theirs.get(k)
        out["kernels"][k] = dict(
            here=None if a is None else len(a), other=None if b is None else len(b),
            identical=a == b, differing=None if a is None or b is None else
            sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)),
            counts={tree: _opcode_counts(code[k], counted) for tree, code in trees.items() if k in code},
            loops={tree: innermost_loops(code[k]) for tree, code in trees.items() if k in code})
    return out


def _opcode_counts(code, counted) -> dict:
    """How many of ``code``'s instructions have each opcode of ``counted``."""
    ops = collections.Counter(_opcode(i) for i in code)
    return {op: ops[op] for op in counted}


def barrier_latency(reps: int = WRAP_CHAIN_STEPS) -> dict:
    """Cycles a barrier on the card (``sim_kernel.barrier_cycles``), the
    largest over a cluster's CTAs: ``__syncthreads`` on one block of 128 and
    512 threads, ``barrier.cluster`` arrive/wait on one cluster of 1, 2, 4
    and 8 CTAs of 128 threads (the kernel's release/acquire pair, and a
    relaxed arrive), after a short run that warms the instruction cache."""
    from ..ops.cuda import sim_kernel

    _require_cuda()
    out = {}
    for threads in (128, 512):
        sim_kernel.barrier_cycles(1, threads, 64, on_cluster=False)
        out[f"__syncthreads, {threads} threads"] = max(sim_kernel.barrier_cycles(1, threads, reps, on_cluster=False))
    for c in sim_kernel.CLUSTERS:
        for relaxed in (False, True):
            sim_kernel.barrier_cycles(c, 128, 64, relaxed=relaxed)
            out[f"barrier.cluster{' (arrive.relaxed)' if relaxed else ''}, {c} CTAs of 128 threads"] = max(
                sim_kernel.barrier_cycles(c, 128, reps, relaxed=relaxed))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="check", choices=("check", "split", "sass", "wrap", "barrier"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=SIM_CASES + RECURRENCE_CASES, help="split: these cases alone")
    ap.add_argument("--pad-mib", type=int, default=0, help="split: MiB allocated on the card first")
    ap.add_argument("--clusters", nargs="+", type=int, default=(),
                    help="split: the dense block also through the on-chip kernel at these cluster sizes")
    ap.add_argument("--kernel", default="xylo_sim", choices=list(SASS_KERNELS), help="sass: the kernel's source")
    ap.add_argument("--against", help="sass: the other tree's copy of the kernel's source (csrc/SOURCE.cu)")
    ap.add_argument("--sass-listing", help="wrap, sass: write the kernels' SASS to this file")
    args = ap.parse_args(argv)
    if args.mode == "wrap":
        out = {"card": card_line(), "clock_mhz": sm_clock_mhz(), "cycles a step": wrap_latency(),
               "bits": [wrap_bits(form) for form in ("wrap", "atan2f(sinf, cosf)")], "ptxas": build_resources(),
               "sass": tracker_sass(args.sass_listing)}
        print(json.dumps(out, default=str))
        return out
    if args.mode == "barrier":
        out = {"card": card_line(), "clock_mhz": sm_clock_mhz(), "cycles a barrier": barrier_latency()}
        print(json.dumps(out, default=str))
        return out
    if args.mode in ("split", "sass"):
        out = split(args.reps, args.only, args.pad_mib, args.clusters) if args.mode == "split" \
            else sass_against(args.against, args.kernel, listing=args.sass_listing)
        print(json.dumps(out, default=str))
        return out
    from ..models.xylo.sim import ORDERINGS, RESETS

    dev = _require_cuda()
    out = {"card": card_line(), "iir_scan": {}, "xylo_sim": {}, "clock_mhz": sm_clock_mhz()}
    for name, (b, a, x, axis, zi) in iir_inputs().items():
        if zi is None:
            out["iir_scan"][name] = iir_against_plain(b, a, x.to(dev), axis, reps=args.reps)
        else:
            out["iir_scan"][name] = stream_chunks(b, a, x.to(dev), zi)
    out["chain_floor_ms"] = chain_floor_ms(12_000, out["clock_mhz"])
    demo, spk, block = flagship_rasters(dev)
    for label, cfg in (("uniform", demo.xylo_config), ("dense", block)):
        for o in ORDERINGS:
            for r in RESETS:
                out["xylo_sim"][f"{o}/{r}, {label}"] = sim_against_plain(cfg, spk, o, r)
    out["xylo_sim times"] = sim_times(demo.xylo_config, spk, max(1, args.reps // 4))
    from ..models.xylo.flagship import flagship_frames

    frames, _ = flagship_frames(demo, TRACK_B, seed=SEED)
    out["envelope"] = {name: envelope_against_plain(x, reps=args.reps) for name, x in envelope_inputs(frames).items()}
    z, zk, valid = (t.to(dev) for t in track_inputs())
    out["track_angles"] = track_against_plain(z, reps=args.reps)
    out["track_multi"] = multi_against_plain(zk, valid, MULTI_M, reps=args.reps)
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
