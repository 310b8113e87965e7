"""Roofline probes P1–P3: wrappers of ``csrc/roofline.cu``, counterparts of
the Pallas probes of the TPU's roofline harness ``experiments/vpu_roofline.py``.

- P1, :func:`lif_peak` (``_peak_kernel``, ``:77``): the integer LIF op mix on
  register-resident int32 chains, ``ilp`` independent chains per thread;
  10 nominal operations per element and iteration, as the TPU harness
  counts them (``:129``).
- P2, :func:`shiftmax` (``_shiftmax_peak_kernel``, ``:163``): dilated doubling
  max-down / min-up chains over (352, 32) float32 tiles, the tile of K2/K7's
  first design at the flagship (the suppression kernels have since moved to
  bit words and a 512-sample tile), ``rep`` times; :func:`shiftmax_pairs` counts the chain steps it
  executes (a shifted shared-memory read plus a max or min each).
- P3, :func:`lif_count_kstep` (``_lif_kernel_bipolar_k``, ``:226``): K3's
  counts on the flagship fast path, dense currents staged per chunk and
  ``k`` steps per unrolled iteration.

They serve the harness ``experiments/roofline.py``; nothing on the
localizer's paths calls them.  On CPU tensors each wrapper runs its plain
version; on CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from . import lif_kernel
from ._build import check, launch_counts, library, require_cuda, stream_handle

P1_OPS_PER_STEP = 10  # 9 ALU operations + 1 for the loop, the TPU harness's nominal count
P2_ROWS = 32  # rows per P2 tile, as the suppression kernels' blocks
P2_TBE = 352  # samples per P2 tile: 256 plus the halo _margin(11) = 48 on each side (K2/K7's first tile)
P2_LOW, P2_HIGH = -3.0e38, 3.0e38  # the Pallas probe's fills


def chain_len(L: int) -> int:
    """Steps of the dilated doubling loop over a window of L (a copy of
    ``experiments/vpu_roofline._chain_len``)."""
    n, k = 0, 1
    while k < L:
        step = min(k, L - k)
        n += 1
        k += step
    return n


def suppression_shiftmax_pairs(w: int, W: int, rounds: int = 2) -> int:
    """Shift+max pairs per element of the fused bipolar round-1 kernel in the
    doubling formulation (a copy of
    ``experiments/vpu_roofline.suppression_shiftmax_pairs``): the extrema
    chains (trailing max and leading min over W, and the d-shift), plus per
    round and polarity window_max(h) + leading_any + window_max(winners).
    What the TPU's kernels execute; the least a kernel needs is counted by
    ``experiments/roofline.py``."""
    round_pairs = 2 * (2 * chain_len(w + 1)) + 1 + chain_len(w)
    return 2 * chain_len(W) + 1 + rounds * 2 * round_pairs


def shiftmax_pairs(shape, w: int, rep: int) -> int:
    """Chain steps P2 executes per element, summed over a tensor of ``shape``
    (..., TBe, rows)."""
    n = 1
    for d in shape:
        n *= int(d)
    return 2 * chain_len(w + 1) * rep * n


# ------------------------------------------------------------- plain versions
def lif_peak_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """What P1 computes, elementwise: ``isyn + vmem + cnt`` after ``iters``
    steps of the LIF op mix from ``isyn = x``, ``vmem = x + 1``."""
    x = x.to(torch.int32)
    isyn, vmem, cnt = x.clone(), x + 1, torch.zeros_like(x)
    for _ in range(iters):
        isyn = isyn - (isyn >> 2) + x
        vmem = vmem - (vmem >> 2) + isyn
        fired = vmem >= 127
        vmem = torch.where(fired, vmem - 127, vmem)
        cnt = cnt + fired.to(torch.int32)
    return isyn + vmem + cnt


def _shift_time(v: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """``out[..., t, :] = v[..., t - s, :]`` along dim -2 (s < 0 shifts up),
    ``fill`` where the source is out of range."""
    n = v.shape[-2]
    k = min(abs(s), n)
    pad = torch.full(v.shape[:-2] + (k, v.shape[-1]), fill, dtype=v.dtype, device=v.device)
    if s > 0:
        return torch.cat([pad, v[..., : n - k, :]], dim=-2)
    return torch.cat([v[..., k:, :], pad], dim=-2)


def shiftmax_plain(x: torch.Tensor, w: int, rep: int) -> torch.Tensor:
    """What P2 computes along dim -2: ``rep`` times a max-down chain then a
    min-up chain, each over a window of w + 1 by dilated doubling."""
    v = x
    for _ in range(rep):
        for op, sign, fill in ((torch.maximum, 1, P2_LOW), (torch.minimum, -1, P2_HIGH)):
            k = 1
            while k < w + 1:
                step = min(k, w + 1 - k)
                v = op(v, _shift_time(v, sign * step, fill))
                k += step
    return v


# ------------------------------------------------------------------- kernels
def lif_peak(x: torch.Tensor, iters: int, ilp: int = 1, threads: int = 256, blocks: int | None = None):
    """P1 on int32 ``x`` of any shape: one chain per element, ``ilp`` chains
    per thread, ``blocks`` × ``threads`` threads (enough for ``x`` when
    None)."""
    if x.device.type == "cpu":
        return lif_peak_plain(x, iters)
    require_cuda(x, "x", (torch.int32,), x.dim())
    if ilp not in (1, 2, 4, 8):
        raise ValueError(f"ilp must be 1, 2, 4 or 8 (got {ilp})")
    if not 1 <= threads <= 1024:
        raise ValueError(f"threads must be in [1, 1024] (got {threads})")
    n = x.numel()
    if blocks is None:
        blocks = max(1, -(-n // (threads * ilp)))
    if blocks * threads * ilp < n:
        raise ValueError(f"{blocks} x {threads} threads x {ilp} chains cover fewer than {n} elements")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().hm_probe_p1(x.data_ptr(), out.data_ptr(), n, iters, ilp, blocks, threads,
                                   stream_handle(x.device))
    check(rc, "probe_p1")
    launch_counts["probe_p1"] += 1
    return out


def shiftmax(x: torch.Tensor, w: int, rep: int) -> torch.Tensor:
    """P2 on (NB, 352, 32) float32 tiles, one block per tile."""
    if x.device.type == "cpu":
        return shiftmax_plain(x, w, rep)
    require_cuda(x, "x", (torch.float32,), 3)
    nb, tbe, rows = x.shape
    if (tbe, rows) != (P2_TBE, P2_ROWS):
        raise ValueError(f"P2 takes (NB, {P2_TBE}, {P2_ROWS}) tiles (got {tuple(x.shape)})")
    if w < 1:
        raise ValueError(f"w must be at least 1 (got {w})")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().hm_probe_p2(x.data_ptr(), out.data_ptr(), nb, tbe, w, rep, stream_handle(x.device))
    check(rc, "probe_p2")
    launch_counts["probe_p2"] += 1
    return out


def lif_count_kstep(config, kp_tbc: torch.Tensor, kn_tbc: torch.Tensor, k: int) -> torch.Tensor:
    """P3: the (B, N) int32 counts of :func:`lif_kernel.lif_count_rates_bipolar`
    from the two (T, B, C) polarity masks, by dense currents per staged chunk
    and ``k`` ∈ {2, 4} steps per unrolled iteration.  Flagship fast path
    only: no recurrence, clips proven dead, int8 weights, C ≤ 16."""
    if kp_tbc.device.type == "cpu":
        return lif_kernel.lif_count_plain(config, kp_tbc, kn_tbc)
    if k not in (2, 4):
        raise ValueError(f"k must be 2 or 4 (got {k})")
    params = lif_kernel.lif_params(config, kp_tbc.device, spike_bound=1)
    T, B, C, N = lif_kernel._check_masks(params, kp_tbc, kn_tbc)
    if params.rec_coef != 0 or not params.no_sat:
        raise ValueError("P3 takes the flagship fast path only: no recurrence and clips proven dead")
    if C > library().hm_probe_p3_max_channels():
        raise ValueError(f"{C} channels per polarity exceed P3's {library().hm_probe_p3_max_channels()}")
    if int(params.w_in.min()) < -128 or int(params.w_in.max()) > 127:
        raise ValueError("P3 packs the weights as int8; w_in has values outside [-128, 127]")
    counts = torch.empty((B, N), dtype=torch.int32, device=kp_tbc.device)
    with torch.cuda.device(kp_tbc.device):
        rc = library().hm_probe_p3(
            kp_tbc.data_ptr(), kn_tbc.data_ptr(), params.w_in.data_ptr(), params.dash_syn.data_ptr(),
            params.dash_mem.data_ptr(), params.threshold.data_ptr(), counts.data_ptr(),
            T, B, C, N, k, stream_handle(kp_tbc.device),
        )
    check(rc, "probe_p3")
    launch_counts["probe_p3"] += 1
    return counts
