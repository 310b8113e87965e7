"""The two hand kernels with no TPU kernel behind them, ``iir_lifted``
(``csrc/iir_lifted.cu``) and ``matched`` (``csrc/matched.cu``), on the card:
their launches split by CUPTI's kernel records, their outputs saved for a
comparison across two trees, and the band-stacked estimators' width question.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.hand_kernels split [--reps 20]
    python -m haghighatshoarmuir2024_tpu_torch.experiments.hand_kernels dump OUT.npz
    python -m haghighatshoarmuir2024_tpu_torch.experiments.hand_kernels compare A.npz B.npz
    python -m haghighatshoarmuir2024_tpu_torch.experiments.hand_kernels stacked

``split`` traces ``--reps`` calls of each kernel's wrapper at the flagship's
shapes (the encode input (T, B, 2M) = (12 000, 96, 14) of ``forward_batch``,
and its (96, 449) rates against the 449 x 449 table) with
``utils.profiling.device_trace`` and prints each launch's mean device time
by kernel name and their sum a call, beside CUDA events around the same
calls.  ``dump`` writes both wrappers' inputs and outputs at the flagship and
at the IIR's other paths (``IIR_PLAIN_CASES``, the cases of ``chip_smoke.py`` phase 27) to an
``.npz``; ``compare`` counts the outputs of two dumps that differ (the
inputs must be equal), so that a tree's kernels can be held to another's on
the same inputs: copy this file into the other tree, dump from each, and
compare.  ``stacked`` designs the three-band model of
``experiments/multiband_bench.py`` on the card, calibrates it band-stacked,
and counts the ``matched_stacked`` and ``matched_auto`` scores and DoAs of
the first w of 96 frames (w in ``WIDTHS``) that differ from the same frames
scored among all 96.  Each mode prints one JSON line; ``split`` and
``stacked`` raise without a GPU, ``dump`` runs the plain versions with
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

SEED = 0
# chip_smoke.py phase 27's cases of the IIR beyond the flagship: (T, columns, sb, carried zi)
IIR_PLAIN_CASES = ((64, 14, 32, False), (8224, 28, 32, False), (12_001, 42, 32, False), (12_000, 98, 48, True),
                   (12_000, 70, 40, True), (6000, 14, 24, True), (480, 14, 8, True))
WIDTHS = (1, 4, 7, 12, 24, 48)
STACKED = ("matched_stacked", "matched_auto")


def _require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("hand_kernels split/stacked measure the card: no CUDA device is available")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def flagship_inputs(dev: torch.device, batch: int = 96):
    """The flagship demo (bundled design and table), the lifted IIR's input
    in ``forward_batch`` (the STHT of the frames, (T, B, 2M)) and its
    filter, and the (B, G) rates and the (G, G) table of the matched
    epilogue."""
    from ..models.xylo import Demo
    from ..models.xylo.flagship import flagship_config, flagship_frames
    from ..ops.stht import stht

    demo = Demo(**flagship_config(dev))
    demo.calibrate_profiles()
    frames, _ = flagship_frames(demo, batch, seed=SEED)
    inphase, quad = stht(frames.transpose(0, 1), demo.kernel)
    sig = torch.cat([inphase, quad], dim=-1)
    rate = demo.fold(demo.rates_batch(frames))
    return demo, sig, demo.filterbank.ba_list[0], rate, demo._profiles_t


def short_name(name: str) -> str:
    """A kernel's name in a trace without its namespace, template and
    arguments (``increments_kernel``, ``matched_kernel``)."""
    found = [n for n in re.findall(r"([A-Za-z_]\w*)(?=[<(])", name) if n not in ("void", "namespace")]
    return found[0] if found else name


TRACE_ATTEMPTS = 3  # traces taken before a trace without kernel records counts as CUPTI being unavailable


def traced_ms(fn, reps: int) -> dict:
    """``{kernel: [device ms of each launch]}`` over ``reps`` calls of
    ``fn`` under ``utils.profiling.device_trace`` (CUPTI's kernel records),
    after one untraced call.  A trace that holds no kernel record is taken
    again, up to ``TRACE_ATTEMPTS`` traces, and each such trace is printed
    (a ``[trace]`` line) so that the caller's output shows it: on the H100
    machine a trace once came back without the GPU's records where the same
    trace in other runs held them, for a reason not found."""
    from ..utils.profiling import device_trace

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with tempfile.TemporaryDirectory() as tmp:
            with device_trace(tmp):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            files = sorted(Path(tmp).glob("*.json"))
            if not files:
                raise RuntimeError("device_trace wrote no trace file")
            events = json.loads(files[0].read_text())["traceEvents"]
        kern = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
        if kern:
            break
        print(f"[trace] trace {attempt} of {TRACE_ATTEMPTS} held no kernel record ({len(events)} events, "
              f"{sum(1 for e in events if str(e.get('cat', '')).lower() == 'cuda_runtime')} CUDA runtime calls)"
              + ("; taken again" if attempt < TRACE_ATTEMPTS else ""), flush=True)
    else:
        raise RuntimeError(f"device_trace recorded no CUDA kernel in {TRACE_ATTEMPTS} traces "
                           "(CUPTI activity tracing unavailable)")
    out: dict = {}
    for e in sorted(kern, key=lambda e: e["ts"]):
        out.setdefault(short_name(e.get("name", "")), []).append(e["dur"] / 1e3)
    return out


def launches_a_call(records: list, calls: int) -> int:
    """A kernel's launches a call from its records over ``calls`` calls:
    the nearest whole number, at least one (CUPTI may drop a record at the
    edge of the traced window)."""
    return max(1, round(len(records) / calls))


def device_ms(traced: dict, calls: int) -> float:
    """Device ms a call: each kernel's mean launch times its launches a
    call, summed over the kernels of :func:`traced_ms`'s records."""
    return float(sum(np.mean(v) * launches_a_call(v, calls) for v in traced.values()))


def events_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` by CUDA events around ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split(reps: int = 20, inputs=None) -> dict:
    """Each kernel's launches at the flagship, traced: per kernel name the
    launches a call and the mean, min and max device ms of a launch, the
    device ms a call, and CUDA events around the same calls."""
    from ..ops import iir
    from ..ops.cuda import matched_kernel

    dev = _require_cuda()
    _, sig, (b, a), rate, table = inputs or flagship_inputs(dev)
    calls = {"iir_lifted": lambda: iir.iir_cumsum_blocked(b, a, sig),
             "matched": lambda: matched_kernel.matched_scores(rate, table)}
    out = {}
    for label, fn in calls.items():
        tr = traced_ms(fn, reps)
        per = {k: dict(launches_a_call=launches_a_call(v, reps), records=len(v), mean_ms=float(np.mean(v)),
                       min_ms=float(np.min(v)), max_ms=float(np.max(v))) for k, v in tr.items()}
        out[label] = dict(kernels=per, device_ms_a_call=device_ms(tr, reps), events_ms=events_ms(fn, reps))
    return out


# ------------------------------------------------------------------ dump and compare
def _iir_cases(dev: torch.device, sig, ba):
    """(name, x, zi, sb) of the flagship's encode input and IIR_PLAIN_CASES
    (chip_smoke.py's draws: ``default_rng(SEED + 27)`` in order)."""
    b, a = ba
    N = len(a) - 1
    T = sig.shape[0]
    yield "flagship", sig.reshape(T, -1), None, 32
    rng = np.random.default_rng(SEED + 27)
    for Tc, L, sb, carried in IIR_PLAIN_CASES:
        x = torch.as_tensor(rng.standard_normal((Tc, L)).astype(np.float32), device=dev)
        zi = torch.as_tensor(rng.standard_normal((L, N + 1)).astype(np.float32), device=dev) if carried else None
        yield f"T{Tc}-L{L}-sb{sb}{'-carried' if carried else ''}", x, zi, sb


def dump(path: str, device=None, inputs=None) -> dict:
    """Both wrappers' inputs and outputs (module docstring) into ``path``;
    returns the arrays saved."""
    from ..ops import iir
    from ..ops.cuda import matched_kernel

    dev = torch.device(device) if device is not None else _require_cuda()
    _, sig, (b, a), rate, table = inputs or flagship_inputs(dev)
    arrays = {}
    for name, x, zi, sb in _iir_cases(dev, sig, (b, a)):
        carried = zi is not None
        got = iir.iir_cumsum_blocked(b, a, x, zi=zi, return_state=carried, sb=sb)
        z, state = got if carried else (got, None)
        arrays[f"iir/{name}/in"] = x.cpu().numpy()
        arrays[f"iir/{name}/out"] = z.cpu().numpy()
        if carried:
            arrays[f"iir/{name}/zi"] = zi.cpu().numpy()
            arrays[f"iir/{name}/state"] = state.cpu().numpy()
    arrays["matched/rate"] = rate.cpu().numpy()
    arrays["matched/table"] = table.cpu().numpy()
    arrays["matched/scores"] = matched_kernel.matched_scores(rate, table).cpu().numpy()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return arrays


OUTPUTS = ("/out", "/state", "/scores")


def compare(a_path: str, b_path: str) -> dict:
    """Per output of two dumps: elements whose values differ, whose bits
    differ, and the largest difference; raises if an input differs."""
    A, B = np.load(a_path), np.load(b_path)
    if sorted(A.files) != sorted(B.files):
        raise ValueError(f"the dumps hold other arrays: {sorted(set(A.files) ^ set(B.files))}")
    out = {}
    for k in sorted(A.files):
        x, y = A[k], B[k]
        if x.shape != y.shape:
            raise ValueError(f"{k}: shape {x.shape} against {y.shape}")
        bits = int((x.view(np.int32) != y.view(np.int32)).sum())
        if not k.endswith(OUTPUTS):
            if bits:
                raise ValueError(f"input {k} differs in {bits} elements: the dumps are not of the same inputs")
            continue
        out[k] = dict(elements=int(x.size), differ=int((x != y).sum()), bits_differ=bits,
                      max_abs_diff=float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max()))
    return out


# ------------------------------------------------------------------ the stacked estimators' widths
def stacked_width(demo, frames, widths=WIDTHS) -> dict:
    """``{method: {w: (scores whose bits differ, DoAs that differ)}}``: the
    first w frames of ``frames`` scored alone against the same frames scored
    among all of them, for the band-stacked estimators of ``demo``
    (calibrated with ``band_stacked=True``)."""
    rate = demo.rates_batch(frames)
    out = {}
    for method in STACKED:
        full = demo.doa_scores(rate, method)
        full_doa = demo.estimate_doa_from_rate(rate, method)
        out[method] = {}
        for w in widths:
            s = demo.doa_scores(rate[:w], method)
            d = demo.estimate_doa_from_rate(rate[:w], method)
            out[method][w] = (int((s.contiguous().view(torch.int32) != full[:w].contiguous().view(torch.int32)).sum()),
                              int((d != full_doa[:w]).sum()))
    return out


EPS32 = float(np.finfo(np.float32).eps)


def cpu_route(demo):
    """A shallow copy of ``demo`` whose score tables lie on the CPU: its
    ``doa_scores`` of CPU rates is the CPU route (the plain versions)."""
    import copy

    c = copy.copy(demo)
    for k in ("_profiles_t", "_stacked_t", "_stacked_cos_t"):
        v = getattr(demo, k)
        setattr(c, k, None if v is None else v.cpu())
    return c


def of_bound(got, ref, terms, K: int):
    """The worst ``|got - ref|`` as a fraction of a K-term sum's error bound
    ``2 K eps terms`` (``terms`` the sum of the terms' magnitudes), and the
    largest ``|got - ref|``."""
    d = (got.double().cpu() - ref.double().cpu()).abs()
    tol = 2 * K * EPS32 * terms.double().cpu()
    return float(torch.where(d == 0, 0.0, d / tol).max()), float(d.max())


def stacked_tolerance(rate, table, cos_t, G: int, method: str):
    """The bound on the distance of a band-stacked estimator's float32
    scores from the CPU route's, from the CPU route's intermediates (all
    arguments on the CPU).  ``matched_stacked``: ``2 K eps sum |r t|`` with r
    the block-normalized rates, t the normalized table, K = F·G.
    ``matched_auto`` (its ``"peak2"`` weights): each component score (the F
    band cosines and the folded one) off by at most ``e = 2 K eps sum |r t|``
    of its own terms, so each weight ``pk²`` by at most ``2 |pk| e' + e'²``
    (e' the largest e of the row), and the blend by ``sum_f |w_f| e_f +
    |comp_f| dw_f`` plus its own (F + 1)-term sum's ``2 (F + 1) eps sum |w comp|``."""
    from ..models.xylo.pipeline import _blockcos, _cos1

    K = rate.shape[-1]
    if method == "matched_stacked":
        return 2 * K * EPS32 * (_blockcos(rate, G).double().abs() @ cos_t.double().abs().T)
    if method != "matched_auto":
        raise ValueError(f"{method!r} is not a band-stacked estimator")
    F, P = K // G, table.shape[0]
    cb = _blockcos(rate, G).reshape(-1, F, G).double()
    pb = _blockcos(table, G).reshape(P, F, G).double()
    rf = _cos1(rate.reshape(-1, F, G).mean(dim=-2)).double()
    pf = _cos1(table.reshape(P, F, G).mean(dim=-2)).double()
    comp = torch.cat([torch.einsum("bfg,pfg->bfp", cb, pb), (rf @ pf.T)[:, None]], dim=1)
    e = 2 * K * EPS32 * torch.cat([torch.einsum("bfg,pfg->bfp", cb.abs(), pb.abs()),
                                   (rf.abs() @ pf.abs().T)[:, None]], dim=1)
    pk, de = comp.amax(dim=-1), e.amax(dim=-1)
    w, dw = pk**2, 2 * pk.abs() * de + de**2
    return ((w.abs()[..., None] * e + comp.abs() * dw[..., None]).sum(dim=1)
            + 2 * (F + 1) * EPS32 * (w.abs()[..., None] * comp.abs()).sum(dim=1))


def stacked_against_cpu(demo, frames) -> dict:
    """The band-stacked estimators' scores of ``demo`` (calibrated with
    ``band_stacked=True``) on its device against the CPU route's on the same
    rates moved to the CPU: per method the worst distance as a fraction of
    :func:`stacked_tolerance`, the largest distance, the DoAs (argmaxes) that
    differ, and of those the ones at a tie (the CPU route's top score and the
    device's pick within the sum of their bounds)."""
    rate = demo.rates_batch(frames)
    cpu, r = cpu_route(demo), rate.cpu()
    G = len(demo.doa_list)
    out = {}
    for m in STACKED:
        got = demo.doa_scores(rate, m).cpu()
        ref = cpu.doa_scores(r, m)
        tol = stacked_tolerance(r, cpu._stacked_t, cpu._stacked_cos_t, G, m)
        d = (got.double() - ref.double()).abs()
        gi, ri = got.argmax(dim=-1), ref.argmax(dim=-1)
        rows = torch.arange(len(ri))
        ref64 = ref.double()
        tie = ref64[rows, ri] - ref64[rows, gi] <= tol[rows, ri] + tol[rows, gi]
        differ = gi != ri
        out[m] = dict(of_bound=float(torch.where(d == 0, 0.0, d / tol).max()), max_abs_err=float(d.max()),
                      doas_differ=int(differ.sum()), doas_differ_at_ties=int((differ & tie).sum()))
    return out


def stacked_parts_against_plain(demo, frames) -> dict:
    """The band-stacked estimators' routes through ``csrc/matched.cu`` on
    ``demo``'s device against their plain versions on the same tensors, at
    the shapes ``doa_scores`` gives them: ``{part: (of_bound, max_abs)}``
    (:func:`of_bound`) for ``matched_scores(center=False)`` of the
    block-normalized rates against the stacked table (K = F·G),
    ``band_scores`` (K = G), and ``row_sums`` of the band means (K = F), of
    the blend (K = F + 1) and of a band block (K = G)."""
    from ..models.xylo.pipeline import _blockcos, _cos1, _mean
    from ..ops.cuda.matched_kernel import band_scores, band_scores_plain, matched_scores, matched_scores_plain, \
        row_sums
    from ..ops.fir import full_fp32

    full_fp32()
    rate = demo.rates_batch(frames)
    G = len(demo.doa_list)
    B, K = rate.shape
    F = K // G
    cb, ct = _blockcos(rate, G), demo._stacked_cos_t
    out = {f"matched_scores(center=False) K={K}": of_bound(matched_scores(cb, ct, center=False),
                                                          matched_scores_plain(cb, ct, center=False),
                                                          cb.double().abs() @ ct.double().abs().T, K)}
    cb3 = cb.reshape(B, F, G)
    pb3 = _blockcos(demo._stacked_t, G).reshape(-1, F, G)
    out[f"band_scores K={G}"] = of_bound(band_scores(cb3, pb3), band_scores_plain(cb3, pb3),
                                         torch.einsum("bfg,pfg->bfp", cb3.double().abs(), pb3.double().abs()), G)
    rf = _cos1(_mean(rate.reshape(B, F, G), -2))
    pf = _cos1(_mean(demo._stacked_t.reshape(-1, F, G), -2))
    comp = torch.cat([band_scores(cb3, pb3), matched_scores(rf, pf, center=False)[:, None]], dim=1)
    blend = (comp * (comp.amax(dim=-1) ** 2)[..., None]).movedim(-2, -1)
    for x in (rate.reshape(B, F, G).movedim(-2, -1), blend, rate.reshape(B, F, G)):
        out[f"row_sums K={x.shape[-1]}"] = of_bound(row_sums(x), x.sum(dim=-1), x.double().abs().sum(dim=-1),
                                                    x.shape[-1])
    return out


def stacked(fs: int = 48_000, batch: int = 96) -> dict:
    """:func:`stacked_width` on the three-band model designed on the card,
    calibrated folded and band-stacked on the wideband template, and
    ``batch`` of its frames (``multiband_frames``, seed 0)."""
    from ..models.xylo import Demo
    from ..models.xylo.multiband import multiband_config, multiband_frames

    dev = _require_cuda()
    demo = Demo(**multiband_config(dev, fs), use_cache=False)
    frames, _, template = multiband_frames(demo, batch, seed=SEED)
    demo.calibrate_profiles(template=template, use_cache=False, band_stacked=True)
    return stacked_width(demo, frames)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("split")
    p.add_argument("--reps", type=int, default=20)
    p = sub.add_parser("dump")
    p.add_argument("out")
    p.add_argument("--device", default=None, help="cpu: the plain versions (the card by default)")
    p = sub.add_parser("compare")
    p.add_argument("a")
    p.add_argument("b")
    sub.add_parser("stacked")
    args = ap.parse_args(argv)
    if args.mode == "split":
        res = dict(card=card_line(), split=split(args.reps))
    elif args.mode == "dump":
        arrays = dump(args.out, args.device)
        res = dict(dumped=args.out, arrays=len(arrays))
    elif args.mode == "compare":
        res = dict(compare=compare(args.a, args.b))
    else:
        res = dict(card=card_line(), stacked=stacked())
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
