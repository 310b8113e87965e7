"""IIR filtering along the time axis (counterpart of
``haghighatshoarmuir2024_tpu/ops/iir.py``; reference call sites:
micloc/beamformer.py:137-138, micloc/music_beamformer.py:119-121).

The float64 host builders are copied from the JAX package
(``iir.py:34-205``).  :func:`iir_filter` is ``scipy.signal.lfilter`` with
JAX's three evaluation methods, on real or complex input: the sequential
transposed-DF2 scan (:func:`iir_scan`: on the CPU one step of tensor ops per
sample, on the card the hand kernel ``csrc/iir_scan.cu``),
the Hillis-Steele parallel prefix over host matrix powers, and the lifted
block form.  :func:`iir_cumsum_blocked` is the torch form of
``_iir_cumsum_blocked_impl`` (``iir.py:375-517``), with the level-2 modal
lifting, the exactly-carried integrator offset and the streaming state carry.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .fir import fir_block_matmul, full_fp32

SB = 32  # default lifted block size: the TPU form's (``iir.py:375-396``)


def butter_bandpass(order: int, freq_range, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side Butterworth bandpass design (micloc/beamformer.py:69-71)."""
    from scipy.signal import butter

    b, a = butter(order, list(freq_range), btype="bandpass", analog=False, output="ba", fs=fs)
    return np.asarray(b, dtype=np.float64), np.asarray(a, dtype=np.float64)


def _tdf2_matrices(b: np.ndarray, a: np.ndarray):
    """Transposed direct-form II state-space matrices (host, float64).

    s_i[n] = (b_i - a_i b0) x[n] - a_i s_1[n-1] + s_{i+1}[n-1]
    y[n]   = b0 x[n] + s_1[n-1]
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    N = len(a) - 1
    bp = np.zeros(N + 1)
    bp[: len(b)] = b
    A = np.zeros((N, N))
    for i in range(N):
        A[i, 0] = -a[i + 1]
        if i + 1 < N:
            A[i, i + 1] += 1.0
    Bvec = bp[1:] - a[1:] * bp[0]
    return A, Bvec, float(bp[0])


def _modal_transform(A: np.ndarray):
    """Real modal basis of ``A`` (host, float64): columns are [Re v, Im v]
    per conjugate eigenpair (plus real eigenvectors), normalized.  In this
    basis every power of A is norm-bounded by the pole radius, so the
    explicitly-powered lifted matrices are float-safe (the companion form's
    non-normal transients would amplify float error ~1e3x, ``CLAUDE.md:57-60``).

    Returns (T, Tinv) or None when the eigenbasis is ill-conditioned.
    """
    N = A.shape[0]
    eigvals, eigvecs = np.linalg.eig(A)
    used = np.zeros(N, bool)
    cols = []
    for i in range(N):
        if used[i]:
            continue
        lam, v = eigvals[i], eigvecs[:, i]
        if abs(lam.imag) <= 1e-12 * max(1.0, abs(lam.real)):
            used[i] = True
            re = v.real
            cols.append(re / np.linalg.norm(re))
        else:
            js = [
                j
                for j in range(i + 1, N)
                if not used[j] and abs(eigvals[j] - np.conj(lam)) < 1e-8 * abs(lam)
            ]
            if not js:
                return None
            used[i] = used[js[0]] = True
            re, im = v.real, v.imag
            sc = max(np.linalg.norm(re), np.linalg.norm(im))
            cols.extend([re / sc, im / sc])
    T = np.stack(cols, axis=1)
    if np.linalg.cond(T) > 1e8:
        return None
    return T, np.linalg.inv(T)


@functools.lru_cache(maxsize=64)
def _cached_powers(key, log2T: int) -> np.ndarray:
    """(log2T, N, N) host powers A^(2^k) of the TDF2 matrix (``iir.py:62-68``)."""
    A = np.array(key, dtype=np.float64)
    pows = [A]
    for _ in range(log2T - 1):
        pows.append(pows[-1] @ pows[-1])
    return np.stack(pows)


@functools.lru_cache(maxsize=64)
def _cached_block_matrices(b_key, a_key, SB: int):
    """Lifted SB-sample block form of the recurrence (host, float64):

        y_blk = G @ x_blk + H @ s_in        (intra-block, batched matmuls)
        s_out = A^SB @ s_in + Bm @ x_blk    (inter-block, tiny scan)
    """
    b = np.asarray(b_key, np.float64)
    a = np.asarray(a_key, np.float64)
    A, Bv, b0 = _tdf2_matrices(b, a)
    N = A.shape[0]
    c = np.zeros(N)
    c[0] = 1.0

    Apow = [np.eye(N)]
    for _ in range(SB):
        Apow.append(A @ Apow[-1])

    G = np.zeros((SB, SB))
    H = np.zeros((SB, N))
    Bm = np.zeros((N, SB))
    for j in range(SB):
        H[j] = c @ Apow[j]
        G[j, j] = b0
        for i in range(j):
            G[j, i] = c @ Apow[j - 1 - i] @ Bv
    for i in range(SB):
        Bm[:, i] = Apow[SB - 1 - i] @ Bv
    return G, H, Bm, Apow[SB]


@functools.lru_cache(maxsize=64)
def _cached_level2_matrices(b_key, a_key, SB: int, Q: int):
    """Second lifting level over ``Q`` SB-sample blocks (host, float64), in
    the modal basis of A (see ``iir.py:116-170`` of the JAX package):

        s_prev(all q)  = Ws @ vec(sP) + Ps @ s_in
        c_prev(all q)  = c_in + cumE + Hc @ s_in
        s_out          = A^(SB·Q) s_in + Bm2 @ vec(sP)
        c_out          = c_in + Σ_q e_q + sum_h · s_in

    Returns None when no well-conditioned modal basis exists.
    """
    G_np, H_np, Bm_np, ASB = _cached_block_matrices(b_key, a_key, SB)
    A_np, _, _ = _tdf2_matrices(np.asarray(b_key), np.asarray(a_key))
    tr = _modal_transform(A_np)
    if tr is None:
        return None
    T, Tinv = tr
    N = ASB.shape[0]
    ASBm = Tinv @ ASB @ T
    Bm_m = Tinv @ Bm_np
    LT = np.tril(np.ones((SB, SB)))
    H2m = (LT @ H_np) @ T
    h1m = H_np.sum(axis=0) @ T

    Apow = [np.eye(N)]
    for _ in range(Q):
        Apow.append(ASBm @ Apow[-1])

    Ws = np.zeros((Q * N, Q * N))
    Ps = np.zeros((Q * N, N))
    Bm2 = np.zeros((N, Q * N))
    hvec = np.zeros((Q, N))
    for q in range(Q):
        Ps[q * N : (q + 1) * N] = Apow[q]
        hvec[q] = h1m @ Apow[q]
        Bm2[:, q * N : (q + 1) * N] = Apow[Q - 1 - q]
        for j in range(q):
            Ws[q * N : (q + 1) * N, j * N : (j + 1) * N] = Apow[q - 1 - j]
    LTex = np.tril(np.ones((Q, Q)), k=-1)
    Hc = LTex @ hvec
    sum_h = hvec.sum(axis=0)
    return Ws, Ps, Bm2, h1m, Hc, sum_h, LTex, Apow[Q], T, Tinv, Bm_m, H2m


@functools.lru_cache(maxsize=16)
def _device_matrices(b_key, a_key, SB: int, Q: int, device: torch.device):
    """float32 device copies of the lifted maps, made once per config."""
    G_np, H_np, Bm_np, ASB_np = _cached_block_matrices(b_key, a_key, SB)
    LT = np.tril(np.ones((SB, SB)))
    out = {
        "G2": LT @ G_np, "H2": LT @ H_np, "g1": G_np.sum(axis=0),
        "h1": H_np.sum(axis=0), "Bm": Bm_np, "ASB": ASB_np,
    }
    lvl2 = _cached_level2_matrices(b_key, a_key, SB, Q) if Q > 2 else None
    if lvl2 is not None:
        names = ("Ws", "Ps", "Bm2", "h1m", "Hc", "sum_h", "LTex", "ASBQ", "Tm", "Tinv", "Bmm", "H2m")
        out.update(dict(zip(names, lvl2)))
        # the level-2 maps of the block increments in one matrix, and the
        # exclusive prefix with the full sum below it (iir_cumsum_blocked)
        out["WsBm2"] = np.concatenate([out["Ws"], out["Bm2"]])
        out["LTexSum"] = np.concatenate([out["LTex"], np.ones((1, Q))])
    # every per-block projection of the input in one matrix: the within-block
    # prefix sums, the block sums and the state increments
    out["proj"] = np.concatenate([out["G2"], out["g1"][None], out["Bmm"] if lvl2 is not None else Bm_np])
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in out.items()}


def scan_coefficients(b, a):
    """``(bp, a_tail)``, float64: ``b`` over ``a[0]`` padded to N + 1 taps,
    and ``a[1:] / a[0]``, the coefficients of the transposed-DF2 scan."""
    b64 = np.asarray(b, np.float64)
    a64 = np.asarray(a, np.float64)
    N = len(a64) - 1
    bp = np.zeros(N + 1)
    bp[: len(b64)] = b64 / a64[0]
    return bp, a64[1:] / a64[0]


def iir_scan(b, a, x: torch.Tensor, zi: torch.Tensor | None = None):
    """``lfilter(b, a, x)`` along dim 0 of ``x`` (T, ...) as the sequential
    transposed-DF2 recurrence (JAX ``iir_filter(method="scan")``,
    ``iir.py:256-281``): ``y = b0 x + s_1``, ``s_i = (b_i x − a_i y) + s_{i+1}``,
    in that order of operations, in ``x``'s dtype (real or complex).

    ``zi``: initial state, ``x.shape[1:] + (N,)`` (zeros when None).
    Returns ``(y, final state)``.  On a CPU tensor this is
    :func:`iir_scan_plain`; on any other it is the hand kernel
    ``csrc/iir_scan.cu`` (``ops/cuda/iir_kernel.iir_scan``: one launch for
    all T steps, float32 or complex64, N ≤ 8), which computes the same
    outputs bit for bit and raises off the card.  The Hilbert and MUSIC
    apply paths run it as JAX does; the streaming encode falls back to it
    for chunk lengths no lifted block size divides.
    """
    from .cuda.iir_kernel import iir_scan as scan_kernel

    return scan_kernel(b, a, x, zi)


def iir_scan_plain(b, a, x: torch.Tensor, zi: torch.Tensor | None = None):
    """:func:`iir_scan` in tensor ops: the CPU's route, and the plain
    version the kernel is held to on the card.  Four tensor ops a sample:
    ``b0 x`` for all samples and ``b_i x`` for a block of them are taken
    ahead of the recurrence, and the state lives in two buffers of N + 1
    columns whose last stays 0, so the shift is a view."""
    bp, a_tail64 = scan_coefficients(b, a)
    N = len(a_tail64)
    b_tail = torch.as_tensor(bp[1:], dtype=x.dtype, device=x.device)
    a_tail = torch.as_tensor(a_tail64, dtype=x.dtype, device=x.device)
    T = x.shape[0]
    buf = x.new_zeros((2,) + x.shape[1:] + (N + 1,))
    if zi is not None:
        buf[0, ..., :N] = zi.to(x.dtype)
    first, shifted, head = ([v[..., k] for v in buf] for k in (0, slice(1, None), slice(None, N)))
    y = torch.empty_like(x)
    ys, ys_col = y.unbind(0), y[..., None].unbind(0)
    b0xs = (float(bp[0]) * x).unbind(0)
    block = max(1, (1 << 22) // max(x[:1].numel() * N, 1))  # b_i x of about 4M elements at a time
    cur = 0
    for t0 in range(0, T, block):
        for t, bx in enumerate((x[t0:t0 + block, ..., None] * b_tail).unbind(0), start=t0):
            torch.add(b0xs[t], first[cur], out=ys[t])
            torch.add(bx - ys_col[t] * a_tail, shifted[cur], out=head[1 - cur])
            cur = 1 - cur
    return y, head[cur].clone()


def _iir_parallel(A_np: np.ndarray, Bv: np.ndarray, b0: float, x: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele prefix over the time axis of ``x`` (T, ...): starting
    from ``s[n] = B x[n]``, pass k adds ``A^(2^k) s[n - 2^k]`` (JAX
    ``iir.py:324-348``), then ``y[n] = b0 x[n] + s[n-1][0]``."""
    T = x.shape[0]
    log2T = max(1, int(np.ceil(np.log2(max(T, 2)))))
    pows = _cached_powers(tuple(map(tuple, A_np)), log2T)
    s = x[..., None] * torch.as_tensor(Bv, dtype=x.dtype, device=x.device)
    for k in range(log2T):
        shift = 1 << k
        if shift >= T:
            break
        Ak = torch.as_tensor(pows[k], dtype=x.dtype, device=x.device)
        s_shifted = torch.cat([torch.zeros_like(s[:shift]), s[:-shift]], dim=0)
        s = s + s_shifted @ Ak.T
    return b0 * x + torch.cat([torch.zeros_like(s[:1]), s[:-1]], dim=0)[..., 0]


def _iir_blocked(b, a, x: torch.Tensor, zi, return_state: bool, SB: int):
    """The lifted SB-sample block form along dim 0 of ``x`` (T, ...) (JAX
    ``iir.py:283-319``): in-block outputs and state increments as batched
    matmuls, a sequential recurrence over the blocks only.  Safe for stable
    filters: the lifted matrices round in the working dtype."""
    G_np, H_np, Bm_np, ASB_np = _cached_block_matrices(
        tuple(np.asarray(b, np.float64).tolist()), tuple(np.asarray(a, np.float64).tolist()), SB)
    cast = lambda m: torch.as_tensor(m, dtype=x.dtype, device=x.device)
    G, H, Bm, ASB = cast(G_np), cast(H_np), cast(Bm_np), cast(ASB_np)
    N = ASB.shape[0]
    T = x.shape[0]
    rest = x.shape[1:]
    xf = x.reshape(T, -1)
    L = xf.shape[1]
    pad = (-T) % SB
    if pad and return_state:
        raise ValueError("return_state with method='blocked' requires the time axis to be a multiple of "
                         f"the block size {SB} (got T={T})")
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, L))], dim=0)
    nb = xf.shape[0] // SB
    xb = xf.reshape(nb, SB, L)
    yP = torch.einsum("ji,bil->bjl", G, xb)
    sP = torch.einsum("ni,bil->bnl", Bm, xb)
    s = xf.new_zeros((N, L)) if zi is None else zi.to(x.dtype).reshape(L, N).T
    s_prev = []
    for i in range(nb):  # the block recurrence: one step per SB samples
        s_prev.append(s)
        s = ASB @ s + sP[i]
    y = yP + torch.einsum("jn,bnl->bjl", H, torch.stack(s_prev))
    y = y.reshape(nb * SB, L)[:T].reshape((T,) + rest)
    if return_state:
        return y, s.T.reshape(rest + (N,))
    return y


def iir_filter(b, a, x: torch.Tensor, axis: int = 0, method: str = "scan", zi: torch.Tensor | None = None,
               return_state: bool = False, sb: int | None = None):
    """``scipy.signal.lfilter(b, a, x, axis=axis)`` on real or complex
    ``x`` with zero initial state, or ``zi`` (JAX ``iir_filter``,
    ``iir.py:207-359``).  The arithmetic runs in ``x``'s dtype on its
    device; TF32 stays off for the matrix forms.

    Args:
        b, a: host filter coefficients.
        method: ``"scan"`` (the sequential recurrence, the form JAX's
            Hilbert and MUSIC apply paths run), ``"parallel"`` (the
            log2(T)-pass prefix) or ``"blocked"`` (the lifted ``sb``-sample
            block form, ``sb`` = 32 when None).
        zi: initial state, ``batch_shape + (N,)`` (scan, blocked).
        return_state: also return the final state (scan, and blocked when
            T is a multiple of the block).
        sb: the block size of ``"blocked"``.  The scan and the prefix have
            no block: a given ``sb`` raises for them rather than being
            ignored.
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    if sb is not None and method in ("scan", "parallel"):
        raise ValueError(f"sb is the block size of the blocked methods; method={method!r} has none")
    full_fp32()
    xm = x.movedim(axis, 0)
    if len(a) == 1:  # a pure FIR
        if return_state:
            raise ValueError("return_state is not supported for pure-FIR filters")
        taps = b / a[0]
        y = (torch.complex(fir_block_matmul(taps, xm.real), fir_block_matmul(taps, xm.imag))
             if xm.is_complex() else fir_block_matmul(taps, xm))
        return y.movedim(0, axis)
    if method == "scan":
        y, s = iir_scan(b, a, xm, zi)
        return (y.movedim(0, axis), s) if return_state else y.movedim(0, axis)
    if method == "parallel":
        if zi is not None or return_state:
            raise ValueError("zi/return_state require method='scan'")
        A_np, Bv, b0 = _tdf2_matrices(b, a)
        return _iir_parallel(A_np, Bv, b0, xm).movedim(0, axis)
    if method == "blocked":
        out = _iir_blocked(b, a, xm, zi, return_state, SB if sb is None else int(sb))
        return (out[0].movedim(0, axis), out[1]) if return_state else out.movedim(0, axis)
    raise ValueError(f"unknown IIR method: {method}")


def _dot_terms(h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``h`` (N,) · ``s`` (N, ...) with its N terms added in order: a
    vector-matrix product's kernel, and so its rounding, follows the width
    of ``s`` even on the CPU."""
    acc = h[0] * s[0]
    for n in range(1, h.shape[0]):
        acc = acc + h[n] * s[n]
    return acc


def lifted_plan(N: int, T: int, SB: int):
    """``(nb, Q)``: the SB-sample blocks of a ragged ``T`` padded to whole
    blocks, and the level-2 super-block of Q blocks (the largest divisor of
    nb up to ``512 // N``, so that Q·N ≤ 512)."""
    nb = -(-int(T) // SB)
    Qmax = max(1, 512 // max(N, 1))
    Q = max((q for q in range(1, min(nb, Qmax) + 1) if nb % q == 0), default=1)
    return nb, Q


def _lifted_args(b, a, x: torch.Tensor, return_state: bool, sb: int):
    """The keys, sizes and float32 (T, L) view of an ``iir_cumsum_blocked``
    call, after its checks."""
    full_fp32()
    SB = int(sb)
    b_key = tuple(np.asarray(b, np.float64).tolist())
    a_key = tuple(np.asarray(a, np.float64).tolist())
    N = len(a_key) - 1
    T = x.shape[0]
    if T % SB and return_state:
        raise ValueError(
            "return_state requires the time axis to be a multiple of the block "
            f"size {SB} (got T={T})"
        )
    xf = x.reshape(T, -1).to(torch.float32)
    return b_key, a_key, SB, N, xf


def iir_cumsum_blocked(b, a, x: torch.Tensor, zi: torch.Tensor | None = None,
                       return_state: bool = False, sb: int = SB):
    """``cumsum(lfilter(b, a, x), dim 0)`` as one lifted blocked pass;
    ``x`` is time-major (T, ...) float32 (JAX ``iir_filter(method=
    "blocked_cumsum")``, ``iir.py:375-517``).

    The integrator is part of the lifted block form of the stable filter:
    within-block prefix sums are ``z_blk = (LT·G) x_blk + (LT·H) s_in + c_in``
    and the carried offset updates like a blocked cumsum — all instability
    confined to the float addition of per-block sums.  Q level-1 block steps
    collapse into matmuls in the modal basis (level 2); with Q ≤ 2 or no
    well-conditioned modal basis the plain level-1 recurrence runs.

    On a CPU tensor this is :func:`iir_cumsum_blocked_plain`; on any other
    it is the hand kernel ``csrc/iir_lifted.cu`` (``ops/cuda/iir_kernel.py``),
    which raises off the card, and whose every output is a sum taken in one
    fixed order per column: a stream's result does not depend on how many
    other columns share the call.

    Args:
        zi: initial state, ``x.shape[1:] + (N+1,)``: the TDF2 filter state
            with the running integrator total appended (zeros when None).
        return_state: also return the final state in the same layout; T must
            then be a multiple of ``sb``.  Otherwise a ragged T is
            zero-padded.
        sb: the lifted block size (32, the tuned default; a streaming caller
            passes a divisor of its chunk length).
    """
    if x.device.type == "cpu":
        return iir_cumsum_blocked_plain(b, a, x, zi=zi, return_state=return_state, sb=sb)
    from .cuda.iir_kernel import iir_lifted

    return iir_lifted(b, a, x, zi=zi, return_state=return_state, sb=sb)


def iir_cumsum_blocked_plain(b, a, x: torch.Tensor, zi: torch.Tensor | None = None,
                             return_state: bool = False, sb: int = SB, stages: dict | None = None):
    """:func:`iir_cumsum_blocked` in tensor ops: the CPU's route, and the
    plain version the kernel is held to on the card.  ``stages``, when a
    dict, receives the intermediates ``P`` (nb, SB+1+N, L), ``UV`` and
    ``cs`` (level 2 only) for the width diagnostic of ``chip_smoke.py``.

    Each contraction over the block's samples or the super-block's blocks
    runs as one GEMM of many rows, and the N-term vector products are
    written out, so that on the CPU a column's result does not depend on L.
    On the card the GEMMs' kernels, and so their rounding, still follow L
    (below 336 columns the level-2 products' do), which is why the card runs
    the hand kernel instead."""
    b_key, a_key, SB, N, xf = _lifted_args(b, a, x, return_state, sb)
    T = x.shape[0]
    rest = x.shape[1:]
    L = xf.shape[1]
    nb, Q = lifted_plan(N, T, SB)
    if nb * SB > T:
        xf = torch.cat([xf, xf.new_zeros((nb * SB - T, L))], dim=0)
    xb = xf.reshape(nb, SB, L)
    m = _device_matrices(b_key, a_key, SB, Q, x.device)

    P = torch.einsum("ji,bil->bjl", m["proj"], xb)
    if stages is not None:
        stages["P"] = P
    zP = P[:, :SB]  # within-block prefix sums of y
    cP = P[:, SB]  # per-block sums of y
    sP = P[:, SB + 1:]  # state increments (modal basis at level 2)
    if zi is None:
        s = xf.new_zeros((N, L))
        c = xf.new_zeros((L,))
    else:
        zif = zi.to(torch.float32).reshape(L, N + 1)
        s = zif[:, :N].T
        c = zif[:, N]

    if "Ws" in m:
        nb2 = nb // Q
        s = m["Tinv"] @ s  # the carried state enters the modal basis
        sP2 = sP.reshape(nb2, Q * N, L)
        cP2 = cP.reshape(nb2, Q, L)
        UV = torch.einsum("ab,ibl->ial", m["WsBm2"], sP2)
        U, V = UV[:, :Q * N], UV[:, Q * N:]  # (nb2, Q·N, L), (nb2, N, L)
        e = cP2 + _dot_terms(m["h1m"], U.reshape(nb2, Q, N, L).movedim(2, 0))
        cs = torch.einsum("pq,iql->ipl", m["LTexSum"], e)
        if stages is not None:
            stages.update(UV=UV, cs=cs)
        cumE, sumE = cs[:, :Q], cs[:, Q]  # exclusive in-super prefix, (nb2, L) sums
        s_prev, c_prev = [], []
        for i in range(nb2):  # outer recurrence: nb2 sequential steps
            s_prev.append(U[i] + m["Ps"] @ s)
            c_prev.append(c[None, :] + cumE[i] + m["Hc"] @ s)
            s, c = m["ASBQ"] @ s + V[i], c + sumE[i] + _dot_terms(m["sum_h"], s)
        s_prev = torch.stack(s_prev).reshape(nb, N, L)
        c_prev = torch.stack(c_prev).reshape(nb, L)
        s = m["Tm"] @ s  # and leaves it, back in the TDF2 basis
        Hout = m["H2m"]
    else:
        s_prev, c_prev = [], []
        for i in range(nb):  # level-1 recurrence: one step per block
            s_prev.append(s)
            c_prev.append(c)
            s, c = m["ASB"] @ s + sP[i], c + cP[i] + _dot_terms(m["h1"], s)
        s_prev = torch.stack(s_prev)
        c_prev = torch.stack(c_prev)
        Hout = m["H2"]
    z = zP + torch.einsum("jn,bnl->bjl", Hout, s_prev) + c_prev[:, None, :]
    z = z.reshape(nb * SB, L)[:T].reshape((T,) + rest)
    if return_state:
        return z, torch.cat([s.T, c[:, None]], dim=1).reshape(rest + (N + 1,))
    return z
