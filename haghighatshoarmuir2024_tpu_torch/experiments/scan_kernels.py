"""The two scan kernels, ``iir_scan`` (``csrc/iir_scan.cu``, the per-sample
IIR scan) and ``xylo_sim`` (``csrc/xylo_sim.cu``, the integer simulator's
hidden-layer scan), against their plain loops on the card, timed, with
their bounds:

    python -m haghighatshoarmuir2024_tpu_torch.experiments.scan_kernels [--reps 20]

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
``torch.equal``.  Prints one JSON line; raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .hand_kernels import events_ms

SEED = 0
STREAM_TC = 2999  # a chunk no lifted block size divides: the streaming encode's scan fallback
FP32_LATENCY_CYCLES = 4  # a dependent FP32 add or multiply on sm_90 (issue to issue)
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


def sim_work(T: int, B: int, N: int, records: int) -> tuple[float, float]:
    """(int32 operations, bytes) of one ``xylo_sim`` call: the LIF count
    kernels' 10 operations a neuron and step (``P1_OPS_PER_STEP``); the
    (T, B, N) int32 input current read once and ``records`` (T, B, N) int32
    records written once, the state (three (B, N)) in and out and the
    counts."""
    from ..ops.cuda.roofline_kernel import P1_OPS_PER_STEP

    return float(P1_OPS_PER_STEP * T * B * N), 4.0 * T * B * N * (1 + records) + 4.0 * B * N * 7


def sim_against_plain(cfg, spikes_tbc: torch.Tensor, ordering: str, reset: str, split: bool = False) -> dict:
    """``XyloSim``'s two scans on ``spikes_tbc`` (T, B, n_in) int32 on the
    card, the hidden layer with every record, counts and state, then the
    readout on its spikes: the kernel (``sim.scan_hidden``) against
    ``sim.scan_hidden_plain`` on the same card tensors, by ``torch.equal``.
    With ``split`` also two halves carried against one pass (kernel)."""
    from ..models.xylo import sim
    from ..ops.cuda import _build

    inp = sim.project_input(cfg, spikes_tbc)
    rec_coef, w_rec = sim.recurrence(cfg.w_rec)
    args = (cfg.dash_syn, cfg.dash_mem, cfg.threshold)
    kw = dict(rec_coef=rec_coef, w_rec=w_rec, ordering=ordering, reset=reset, record=True, record_state=True,
              count=True)
    _build.launch_counts.clear()
    got = sim.scan_hidden(inp, *args, **kw)
    ro_args = (cfg.dash_syn_out, cfg.dash_mem_out, cfg.threshold_out)
    ro_kw = dict(ordering=ordering, reset=reset)
    ro_in = sim.int_matmul(got[0], cfg.w_out)
    ro = sim.scan_hidden(ro_in, *ro_args, **ro_kw)
    launches = _build.launch_counts.get("xylo_sim", 0)
    want = sim.scan_hidden_plain(inp, *args, **kw)
    ro_want = sim.scan_hidden_plain(ro_in, *ro_args, **ro_kw)
    pairs = {"spikes": (got[0], want[0]), "counts": (got[1], want[1]), "Isyn": (got[3]["Isyn"], want[3]["Isyn"]),
             "Vmem": (got[3]["Vmem"], want[3]["Vmem"]), "readout": (ro[0], ro_want[0])}
    pairs.update({f"state {n}": (g, w) for n, g, w in zip(("isyn", "vmem", "spk"), got[2], want[2])})
    pairs.update({f"readout state {n}": (g, w) for n, g, w in zip(("isyn", "vmem", "spk"), ro[2], ro_want[2])})
    _sync(inp.device)
    out = dict(shape=tuple(inp.shape), launches=launches, spikes=int(want[1].sum()),
               mismatches={k: _mismatches(g, w) for k, (g, w) in pairs.items()})
    out["equal"] = not any(out["mismatches"].values())
    if split:
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
    kernel's operations and bytes (:func:`sim_work`)."""
    from ..models.xylo import sim

    inp = sim.project_input(cfg, spikes_tbc)
    rec_coef, w_rec = sim.recurrence(cfg.w_rec)
    kw = dict(rec_coef=rec_coef, w_rec=w_rec, record=True, record_state=True)
    args = (inp, cfg.dash_syn, cfg.dash_mem, cfg.threshold)
    T, B, N = inp.shape
    ops, nbytes = sim_work(T, B, N, 3)
    return dict(ms=events_ms(lambda: sim.scan_hidden(*args, **kw), reps),
                plain_ms=events_ms(lambda: sim.scan_hidden_plain(*args, **kw), 1),
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    from ..models.xylo import Demo, DemoPushToHidden
    from ..models.xylo.flagship import flagship_config, flagship_frames
    from ..models.xylo.sim import ORDERINGS, RESETS

    dev = _require_cuda()
    out = {"iir_scan": {}, "xylo_sim": {}, "clock_mhz": sm_clock_mhz()}
    for name, (b, a, x, axis, zi) in iir_inputs().items():
        if zi is None:
            out["iir_scan"][name] = iir_against_plain(b, a, x.to(dev), axis, reps=args.reps)
        else:
            out["iir_scan"][name] = stream_chunks(b, a, x.to(dev), zi)
    out["chain_floor_ms"] = chain_floor_ms(12_000, out["clock_mhz"])
    demo = Demo(**flagship_config(dev))
    frames, _ = flagship_frames(demo, 96, seed=SEED)
    spk = demo.spike_encoding(frames).transpose(0, 1).contiguous()  # (T, B, 28)
    _, block = push_to_hidden_block(DemoPushToHidden(**flagship_config(dev)))
    for label, cfg in (("uniform", demo.xylo_config), ("dense", block)):
        for o in ORDERINGS:
            for r in RESETS:
                out["xylo_sim"][f"{o}/{r}, {label}"] = sim_against_plain(cfg, spk, o, r)
    out["xylo_sim times"] = sim_times(demo.xylo_config, spk, max(1, args.reps // 4))
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
