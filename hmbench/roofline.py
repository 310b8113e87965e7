"""The yardstick's peaks and the work each kernel's function needs, counted
from its inputs (copied from the port's ``experiments/roofline.py``
``lif_work``, ``pack_work``, ``k1_work``/``round_work`` in their byte form,
and PERF.md's ``iir_lifted`` and ``matched`` counts).

A kernel's bound is the larger of its operations over the peak of their kind
and its bytes over the memory rate; its roofline share is the bound over its
measured time.  A step's share of the chip's peak (``step_mfu``) is the sum
of its kernels' bounds over the step's measured wall time.
"""
from __future__ import annotations

PEAKS = {
    # one NVIDIA H100 SXM at 700 W: NVIDIA's data sheet
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    # int32 operations: the port's probe P1 (csrc/roofline.cu), its best point
    # on an H100 80GB HBM3 at 700 W (31.3e12/s, above the 16.7e12 that 64 lanes
    # x 132 SMs x 1980 MHz give, by dual issue): the highest rate measured
    "int32_ops_per_s": 31.3e12,
}

LIF_OPS_PER_STEP = 10  # operations a neuron and step of the integer LIF (the port's P1_OPS_PER_STEP)


def bound_s(ops: float, peak: str, nbytes: float) -> float:
    """Least seconds for ``ops`` operations at ``PEAKS[peak]`` and ``nbytes``
    bytes at the memory rate, whichever is larger."""
    return max(ops / PEAKS[peak], nbytes / PEAKS["hbm_bytes_per_s"])


def fir_work(T: int, B: int, M: int, K: int):
    """The STHT's causal FIR of K taps over (T, B, M) float32: 2 operations a
    tap and output; the signal in and the quadrature out."""
    return 2.0 * K * T * B * M, 8.0 * T * B * M


def iir_lifted_work(T: int, B: int, C: int):
    """``iir_lifted`` for one band over (T, B, C) float32: x in and the
    integrated z out (bytes bound; PERF.md's 1.291e8 at the flagship)."""
    return 0.0, 8.0 * T * B * C


def k1_work(T: int, R: int):
    """K1 on (T, R) float32 ``cs``: ``cs`` in, four masks out."""
    return 0.0, 4.0 * T * R + 4.0 * T * R


def k2_work(T: int, R: int):
    """One K2 round: two masks in, two out."""
    return 0.0, 4.0 * T * R


def pack_work(T: int, B: int, C: int):
    """K3/K4's pack pass: the two (T, B, C) masks in, a mask word a step and
    row out (4 bytes where 2C <= 32, 8 where 2C <= 64, else 16)."""
    word = 4 if 2 * C <= 32 else 8 if 2 * C <= 64 else 16
    return 4.0 * T * B * C, 2.0 * T * B * C + word * T * B


def lif_work(nnz: float, T: int, B: int, N: int, C_in: int, stateful: bool = False):
    """K3 (K4 ``stateful``): 10 operations a neuron and step, one a set input
    bit and neuron; the one-byte inputs, the int32 weights and per-neuron
    integers, the counts, and K4's three state arrays in and out."""
    ops = LIF_OPS_PER_STEP * T * B * N + nnz * N
    nbytes = T * B * C_in + 4 * (C_in * N + 3 * N + B * N) + (24 * B * N if stateful else 0)
    return float(ops), float(nbytes)


def matched_work(B: int, G: int):
    """The matched scores of B folded rates against the G x G profiles."""
    return 2.0 * B * G * G + 2.0 * B * G, 4.0 * (B * G + G * G + B * G)


def step_bound_s(shape: dict, nnz: float) -> dict:
    """{kernel: least seconds} of one call of the pipeline at ``shape``
    (T samples a call, B frames or streams, M microphones, F bands, C
    channels a polarity, N neurons, G grid points, K taps, ``L`` the RZCC
    rows' length and ``stateful`` for a stream step) with ``nnz`` set input
    bits."""
    T, B, M, F, C, N, G, K = (shape[k] for k in ("T", "B", "M", "F", "C", "N", "G", "K"))
    L = shape.get("L", T)
    stateful = bool(shape.get("stateful", False))
    fir_t = T + K - 1 if stateful else T
    out = {
        "fir": bound_s(*_ops_peak(fir_work(fir_t, B, M, K), "fp32_flops_per_s")),
        "iir_lifted": F * bound_s(*_ops_peak(iir_lifted_work(T, B, 2 * M), "fp32_flops_per_s")),
        "rzcc_k1": bound_s(*_ops_peak(k1_work(L, B * C), "int32_ops_per_s")),
        "rzcc_k2": bound_s(*_ops_peak(k2_work(L, B * C), "int32_ops_per_s")),
        "lif_pack": bound_s(*_ops_peak(pack_work(T, B, C), "int32_ops_per_s")),
        "lif": bound_s(*_ops_peak(lif_work(nnz, T, B, N, 2 * C, stateful), "int32_ops_per_s")),
        "matched": bound_s(*_ops_peak(matched_work(B, G), "fp32_flops_per_s")),
    }
    return out


def _ops_peak(work, peak):
    ops, nbytes = work
    return ops, peak, nbytes
