"""Integer-LIF spike counts: wrappers of kernels K3/K4 (``csrc/lif.cu``)
and K5/K6 (``csrc/lif_raster.cu``).

- K3, :func:`lif_count_rates_bipolar`: counterpart of
  ``lif_count_rates_bipolar`` in
  ``haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:407`` (Pallas kernel
  ``_lif_kernel_bipolar``, ``:275``), counts from a zero state.
- K4, :func:`lif_count_stateful_bipolar`: counterpart of
  ``lif_count_stateful_bipolar`` (``:605``, Pallas kernel
  ``_lif_kernel_bipolar_stateful``, ``:468``), the streaming runtime's
  per-chunk LIF with the (B, N) state carried in and out.
- K3 and K4 first launch the pack pass, :func:`pack_bipolar_masks`: the two
  (T, B, C) masks become one mask word and one word of slots per (b, t),
  row-major (B, Tp), and the most set bits of each 32 steps (the Pallas
  kernel's mask combination, ``lif_kernel.py:300-307``); the chain kernel
  then reads its row's slots.  Both on the current stream, no host sync.
- K5, :func:`lif_count_rates`: counterpart of ``lif_count_rates`` (``:218``,
  Pallas kernel ``_lif_kernel``, ``:76``), counts from one int8 raster of any
  values (multi-count and negative spikes included): the single-frame
  ``Demo.forward`` and the unipolar batch.
- K6, :func:`lif_count_stateful`: counterpart of ``lif_count_stateful``
  (``:802``, Pallas kernel ``_lif_kernel_stateful``, ``:666``), K5 with the
  (B, N) state: the unipolar streaming step.
- K5 and K6 first launch the raster pack pass, :func:`pack_raster`: the
  (T, B, C) raster becomes row-major (B, Tp, Cpad) int8, a step's channels
  side by side and zero-padded to whole k-tiles of 16.  The chain kernel
  then computes the input current as the Pallas body does (``:106-115``),
  an int8 x int8 -> int32 product on the tensor cores (``mma.sync``) ahead
  of the step loop, 32 neurons x 16 steps a warp at a time; the weights
  reach it as mma fragments (:func:`weight_fragments`), made once a
  :class:`LifParams` at its first K5/K6 call: one int8 plane where ``w_in`` fits int8 (the Pallas
  wrapper's ``int8_mm`` route, ``:252-255``), else two to four byte planes
  of the same product (its float32 route's counterpart), exact for any
  int32 weights in wrapping int32 arithmetic.

All take the uniform recurrence ``w_rec = c·ones``; a dense ``w_rec``
raises.  On CPU tensors a wrapper runs the plain simulator
(``models/xylo/sim.sim_hidden``); on CUDA tensors it launches its kernel or
raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...models.xylo.sim import STATE_MAX, project_input, sim_hidden, uniform_rec_coef
from ._build import check, launch_counts, library, require_cuda, stream_handle

_MASK_DTYPES = (torch.bool, torch.uint8, torch.int8)
_SPIKE_DTYPES = (torch.int8, torch.bool)
PACK_STEPS = 32  # csrc/lif_common.cuh's PACK_T: the packed rows' length Tp is T rounded up to it
RASTER_K = 16  # csrc/lif_raster.cu's RASTER_K: channels of one k-tile of K5/K6's mma (m16n8k16, int8)
PACK_SLOTS = 6  # csrc/lif.cu's SLOTS: set bits a step's word of slots names


class PackedMasks(NamedTuple):
    """The pack pass's outputs, row-major with Tp = T rounded up to
    :data:`PACK_STEPS` steps (zeros past T).  Unsigned words held as int32
    (int64 for 64-bit mask words, two int64 for 128-bit ones) of the same
    bits."""

    # bit c = kp & ~kn of channel c, bit C + c = kn: (B, Tp) int32 where 2C <= 32, (B, Tp) int64 where
    # 2C <= 64, else (B, Tp, 2) int64, bits 0-63 then 64-127 (csrc/lif.cu's Word128)
    words: torch.Tensor
    slots: torch.Tensor  # (B, Tp) int64: the PACK_SLOTS lowest set bits c as bytes c + 1 (0 for none)
    most: torch.Tensor  # (B, Tp / PACK_STEPS) int32: the most set bits a step of [b, k]'s 32 has


@dataclasses.dataclass(frozen=True, eq=False)
class LifParams:
    """A config's LIF integers as tensors on one device, made once by
    :func:`lif_params` so that a caller launching every step uploads
    nothing per launch."""

    w_in: torch.Tensor  # (C', N) int32: 2C rows for K3/K4 ([:C] positive, [C:] negative)
    dash_syn: torch.Tensor  # (N,) int32
    dash_mem: torch.Tensor  # (N,) int32
    threshold: torch.Tensor  # (N,) int32
    rec_coef: int
    no_sat: bool  # the 16-bit clips are proven dead for the spike bound given
    w_host: np.ndarray  # w_in on the host, which w_frag is laid out from

    @functools.cached_property
    def w_frag(self) -> torch.Tensor:
        """:func:`weight_fragments` of ``w_in`` on its device,
        (ceil(N/32), P, KT, 4, 32) int32: what K5/K6 read in place of
        ``w_in``.  Laid out and uploaded at its first use, once."""
        return torch.as_tensor(weight_fragments(self.w_host), device=self.w_in.device).contiguous()


def _no_saturation_possible(config, spike_bound: int, rec_coef: int) -> bool:
    """Static proof that the 16-bit state clips can never bind
    (``lif_kernel.py:53-73``).

    With per-step input current bounded by ``cur_max`` the decayed integrator
    satisfies ``|isyn| <= (cur_max + 1) << ds`` (the +1 absorbs the floor of
    the arithmetic shift), and likewise ``|vmem| <= (B_isyn + 1) << dm``
    (threshold subtraction only moves vmem toward 0).  When both bounds fit in
    int16 the clips are dead and the kernel may skip them.
    """
    w = np.abs(np.asarray(config.w_in)).sum(axis=0)
    if w.size == 0:
        return False
    n_hid = np.asarray(config.w_in).shape[1]
    cur_max = int(spike_bound) * int(w.max()) + abs(int(rec_coef)) * n_hid
    ds = int(np.max(config.dash_syn))
    dm = int(np.max(config.dash_mem))
    b_isyn = (cur_max + 1) << ds
    b_vmem = (b_isyn + 1) << dm
    return b_isyn <= STATE_MAX and b_vmem <= STATE_MAX


def lif_params(config, device, spike_bound: int | None = 1) -> LifParams:
    """``config``'s LIF integers on ``device``.  ``spike_bound`` is a
    caller-guaranteed bound on the per-step input spike values (1 for RZCC
    masks); with it the static proof may drop the 16-bit clips in the kernel
    (identical integers).  None keeps the clips.  A ``LifParams`` passes
    through as it is: its proof was made when it was."""
    if isinstance(config, LifParams):
        return config
    rec_coef = uniform_rec_coef(config)
    as_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device).contiguous()
    return LifParams(
        w_in=as_dev(config.w_in), dash_syn=as_dev(config.dash_syn),
        dash_mem=as_dev(config.dash_mem), threshold=as_dev(config.threshold),
        rec_coef=rec_coef,
        no_sat=spike_bound is not None and _no_saturation_possible(config, spike_bound, rec_coef),
        w_host=np.asarray(config.w_in),
    )


def weight_planes(w_in: np.ndarray) -> int:
    """Byte planes K5/K6's product takes for these weights: 1 where they fit
    int8 (one signed plane, the tensor cores' int8 x int8 product as it
    is), else the fewest of 2-4 (a signed top plane over unsigned lower
    ones) that hold their range."""
    lo, hi = (int(w_in.min()), int(w_in.max())) if w_in.size else (0, 0)
    return next(p for p in (1, 2, 3, 4) if -(1 << (8 * p - 1)) <= lo and hi < (1 << (8 * p - 1)))


def weight_fragments(w_in: np.ndarray) -> np.ndarray:
    """``w_in`` (C, N) int32 as the A fragments (16 neurons x 16 channels)
    of K5/K6's ``mma.m16n8k16``: (ceil(N/32), P, KT, 4, 32) int32 with P =
    :func:`weight_planes` and KT = ceil(C/16).  The word of warp ``w``,
    plane ``p``, k-tile ``kt``, index ``i`` and lane ``l`` holds, from its
    low byte, byte ``p`` of ``w_in[16 kt + 4 (l % 4) + j, 32 w + 8 i +
    l // 4]`` for j = 0..3 (m-tile ``i // 2``; its rows ``l // 4`` for even
    ``i``, ``l // 4 + 8`` for odd), zero past C and N: ``w = sum_p plane_p
    << 8p`` with the top plane signed and the lower ones unsigned."""
    w_in = np.asarray(w_in, dtype=np.int32)
    C, N = w_in.shape
    P, KT, NW = weight_planes(w_in), -(-C // RASTER_K), -(-N // 32)
    w = np.zeros((KT * RASTER_K, NW * 32), dtype=np.int32)
    w[:C, :N] = w_in
    planes = np.stack([(w >> (8 * p)) & 0xFF for p in range(P)]).astype(np.uint8)  # the top byte keeps the sign
    # (P, KT, lane % 4, j, NW, i, lane // 4) -> (NW, P, KT, i, lane // 4, lane % 4, j)
    frag = planes.reshape(P, KT, 4, 4, NW, 4, 8).transpose(4, 0, 1, 5, 6, 2, 3)
    return np.ascontiguousarray(frag).view("<u4").reshape(NW, P, KT, 4, 32).view(np.int32)


def _rec_coef(config) -> int:
    return config.rec_coef if isinstance(config, LifParams) else uniform_rec_coef(config)


# ------------------------------------------------------------- plain versions
def lif_count_plain(config, kp_tbc: torch.Tensor, kn_tbc: torch.Tensor) -> torch.Tensor:
    """What K3 computes, by the plain simulator: (B, N) int32 counts of the
    (T, B, 2C) raster ``[kp & ~kn, kn]`` (the reference's overwrite: −1 wins
    on collision, micloc/xylo_snn_localization.py:344-355)."""
    return lif_count_stateful_bipolar_plain(config, kp_tbc, kn_tbc, None, None, None)[0]


def lif_count_stateful_bipolar_plain(config, kp_tbc, kn_tbc, isyn0, vmem0, spk0):
    """What K4 computes, by the plain simulator: :func:`lif_count_stateful_plain`
    of the raster ``[kp & ~kn, kn]`` from ``(isyn0, vmem0, spk0)`` ((B, N)
    each; None for zeros).  Returns ``(counts, isyn, vmem, spk)``, all
    (B, N) int32."""
    kp, kn = kp_tbc != 0, kn_tbc != 0
    return lif_count_stateful_plain(config, torch.cat([kp & ~kn, kn], dim=-1), isyn0, vmem0, spk0)


def pack_bipolar_masks_plain(kp_tbc: torch.Tensor, kn_tbc: torch.Tensor) -> PackedMasks:
    """What K3/K4's pack pass computes from the (T, B, C) masks: see
    :class:`PackedMasks` (−1 wins on collision: bit c is ``kp & ~kn``)."""
    T, B, C = kp_tbc.shape
    Tp = _words_steps(T)
    kp, kn = kp_tbc != 0, kn_tbc != 0
    bits = torch.cat([kp & ~kn, kn], dim=-1).to(torch.int64)  # (T, B, 2C)
    c = torch.arange(2 * C, dtype=torch.int64, device=bits.device)
    rank = bits.cumsum(dim=-1) * bits  # 1, 2, ... along the set bits
    slots = sum(((rank == k) * (c + 1)).sum(dim=-1) << (8 * (k - 1)) for k in range(1, PACK_SLOTS + 1))
    most = torch.zeros((B, Tp), dtype=torch.int32, device=bits.device)
    most[:, :T] = bits.sum(dim=-1).T
    most = most.reshape(B, Tp // PACK_STEPS, PACK_STEPS).amax(dim=-1)
    shifted = bits << (c % 64)  # each bit at its place in its 64-bit word; distinct bits: a sum is their OR
    halves = [shifted[..., k:k + 64].sum(dim=-1) for k in range(0, 2 * C, 64)]  # (T, B) each
    words = torch.zeros(_words_shape(B, Tp, C), dtype=torch.int64, device=bits.device)
    words[:, :T] = (halves[0] if len(halves) == 1 else torch.stack(halves, dim=-1)).transpose(0, 1)
    slots_p = torch.zeros((B, Tp), dtype=torch.int64, device=bits.device)
    slots_p[:, :T] = slots.T
    return PackedMasks(words=_as_int32(words) if _word_dtype(C) == torch.int32 else words,
                       slots=slots_p, most=most)


def padded_channels(C: int) -> int:
    """C rounded up to whole k-tiles of :data:`RASTER_K` channels: the row
    width of K5/K6's packed raster."""
    return -(-C // RASTER_K) * RASTER_K


def pack_raster_plain(spikes_tbc: torch.Tensor) -> torch.Tensor:
    """What K5/K6's pack pass computes from the (T, B, C) raster (int8 or
    bool): row-major (B, Tp, Cpad) int8 with Tp = T rounded up to
    :data:`PACK_STEPS` and Cpad = :func:`padded_channels`, zeros past T and
    C."""
    T, B, C = spikes_tbc.shape
    packed = torch.zeros((B, _words_steps(T), padded_channels(C)), dtype=torch.int8,
                         device=spikes_tbc.device)
    packed[:, :T, :C] = spikes_tbc.to(torch.int8).transpose(0, 1)
    return packed


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 → int32 of the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _word_dtype(C: int) -> torch.dtype:
    return torch.int32 if 2 * C <= 32 else torch.int64


def _words_shape(B: int, Tp: int, C: int) -> tuple[int, ...]:
    """The mask words' shape: one word per (b, t), two int64 where 2C > 64."""
    return (B, Tp) if 2 * C <= 64 else (B, Tp, 2)


def _words_steps(T: int) -> int:
    return -(-T // PACK_STEPS) * PACK_STEPS


def lif_count_stateful_plain(config, spikes_tbc, isyn0=None, vmem0=None, spk0=None):
    """What K5 (state None) and K6 compute, by the plain simulator: the
    stateful ``sim_hidden`` on ``project_input(spikes)`` of a time-major
    (T, B, C) raster of any integer values (as int8).  Returns ``(counts,
    isyn, vmem, spk)``, all (B, N) int32."""
    inp = project_input(config, spikes_tbc.to(torch.int8))  # (T, B, N)
    state0 = None if isyn0 is None else (isyn0, vmem0, spk0)
    _, counts, (isyn, vmem, spk) = sim_hidden(
        inp, config.dash_syn, config.dash_mem, config.threshold, _rec_coef(config),
        record=False, state0=state0,
    )
    return counts, isyn, vmem, spk


# ------------------------------------------------------------------ kernels
def _check_mask_pair(kp_tbc: torch.Tensor, kn_tbc: torch.Tensor):
    """Validate two polarity masks for the pack pass; returns (T, B, C)."""
    require_cuda(kp_tbc, "kp_tbc", _MASK_DTYPES, 3)
    require_cuda(kn_tbc, "kn_tbc", _MASK_DTYPES, 3)
    if kn_tbc.shape != kp_tbc.shape or kn_tbc.dtype != kp_tbc.dtype or kn_tbc.device != kp_tbc.device:
        raise ValueError("kp_tbc and kn_tbc must have the same shape, dtype and device")
    T, B, C = kp_tbc.shape
    if C > library().hm_lif_max_channels():
        raise ValueError(f"{C} channels per polarity exceed the kernel's {library().hm_lif_max_channels()}")
    return T, B, C


def _check_masks(params: LifParams, kp_tbc: torch.Tensor, kn_tbc: torch.Tensor):
    """Validate the masks against the params; returns (T, B, C, N)."""
    T, B, C = _check_mask_pair(kp_tbc, kn_tbc)
    if params.w_in.device != kp_tbc.device:
        raise ValueError(f"the LIF params live on {params.w_in.device}, the masks on {kp_tbc.device}")
    N = params.w_in.shape[1]
    if params.w_in.shape[0] != 2 * C:
        raise ValueError(f"w_in has {params.w_in.shape[0]} rows; the masks need 2C = {2 * C}")
    _check_rec(params, N)
    return T, B, C, N


def _check_rec(params: LifParams, N: int) -> None:
    if params.rec_coef != 0 and N > library().hm_lif_max_rec_neurons():
        raise ValueError(
            f"the uniform recurrence (rec_coef = {params.rec_coef}) couples the {N} neurons of a "
            f"row, and one block holds at most {library().hm_lif_max_rec_neurons()}"
        )


def _check_state(B: int, N: int, device, isyn0, vmem0, spk0) -> None:
    for name, s in (("isyn0", isyn0), ("vmem0", vmem0), ("spk0", spk0)):
        require_cuda(s, name, (torch.int32,), 2)
        if s.shape != (B, N) or s.device != device:
            raise ValueError(f"{name} must be ({B}, {N}) on {device} (got {tuple(s.shape)} on {s.device})")


def lif_launch_shape(B: int, C: int, N: int, rec_coef: int = 0) -> tuple[int, int, int]:
    """How K3 and K4 launch: (blocks along the neurons, blocks along the
    batch, threads per block)."""
    out = (ctypes.c_int * 3)()
    library().hm_lif_launch_shape(B, C, N, rec_coef, ctypes.cast(out, ctypes.c_void_p))
    return tuple(out)


def pack_bipolar_masks(kp_tbc: torch.Tensor, kn_tbc: torch.Tensor) -> PackedMasks:
    """K3/K4's pack pass: the two time-major (T, B, C) polarity masks (bool,
    uint8 or int8; nonzero is a spike) → :class:`PackedMasks`."""
    if kp_tbc.device.type == "cpu":
        return pack_bipolar_masks_plain(kp_tbc, kn_tbc)
    T, B, C = _check_mask_pair(kp_tbc, kn_tbc)
    Tp = _words_steps(T)
    new = lambda shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device=kp_tbc.device)  # noqa: E731
    packed = PackedMasks(words=new(_words_shape(B, Tp, C), _word_dtype(C)), slots=new((B, Tp), torch.int64),
                         most=new((B, Tp // PACK_STEPS)))
    with torch.cuda.device(kp_tbc.device):
        rc = library().hm_lif_pack_bipolar(kp_tbc.data_ptr(), kn_tbc.data_ptr(),
                                           *(x.data_ptr() for x in packed), T, Tp, B, C,
                                           stream_handle(kp_tbc.device))
    check(rc, "lif_pack")
    launch_counts["lif_pack"] += 1
    return packed


def lif_count_rates_bipolar(config, kp_tbc: torch.Tensor, kn_tbc: torch.Tensor,
                            spike_bound: int | None = 1) -> torch.Tensor:
    """Hidden-layer spike counts (B, N_hid) int32 straight from the two
    time-major (T, B, C) RZCC polarity masks; ``config`` (a ``XyloConfig``
    or its :class:`LifParams`) has a ``w_in`` of 2C rows ([:C] positive,
    [C:] negative).  ``spike_bound``: see :func:`lif_params`."""
    if kp_tbc.device.type == "cpu":
        return lif_count_plain(config, kp_tbc, kn_tbc)
    params = lif_params(config, kp_tbc.device, spike_bound)
    T, B, C, N = _check_masks(params, kp_tbc, kn_tbc)
    packed = pack_bipolar_masks(kp_tbc, kn_tbc)
    counts = torch.empty((B, N), dtype=torch.int32, device=kp_tbc.device)
    with torch.cuda.device(kp_tbc.device):
        rc = library().hm_lif_count_bipolar(
            *(x.data_ptr() for x in packed), params.w_in.data_ptr(), params.dash_syn.data_ptr(),
            params.dash_mem.data_ptr(), params.threshold.data_ptr(), counts.data_ptr(),
            T, packed.slots.shape[1], B, C, N, params.rec_coef, int(not params.no_sat),
            stream_handle(kp_tbc.device),
        )
    check(rc, "lif_k3")
    launch_counts["lif_k3"] += 1
    return counts


def lif_count_stateful_bipolar(config, kp_tbc: torch.Tensor, kn_tbc: torch.Tensor,
                               isyn0: torch.Tensor, vmem0: torch.Tensor, spk0: torch.Tensor,
                               spike_bound: int | None = 1):
    """Stateful bipolar LIF: time-major (T, B, C) polarity masks and the
    (B, N) int32 initial state → ``(counts, isyn, vmem, spk)``, all (B, N)
    int32 — the streaming form of :func:`lif_count_rates_bipolar`: the
    state carries across chunk calls.  ``spk0`` holds 0/1 values.

    ``spike_bound`` (see :func:`lif_params`): the caller additionally
    guarantees that the initial state was produced by the same bounded
    dynamics (zeros plus earlier chunks of the same stream), so the
    no-saturation invariant carries across chunk boundaries and the clips
    stay provably dead (``lif_kernel.py:810-813``).  A state from elsewhere
    needs ``spike_bound=None``.
    """
    if kp_tbc.device.type == "cpu":
        return lif_count_stateful_bipolar_plain(config, kp_tbc, kn_tbc, isyn0, vmem0, spk0)
    params = lif_params(config, kp_tbc.device, spike_bound)
    T, B, C, N = _check_masks(params, kp_tbc, kn_tbc)
    _check_state(B, N, kp_tbc.device, isyn0, vmem0, spk0)
    packed = pack_bipolar_masks(kp_tbc, kn_tbc)
    out = tuple(torch.empty((B, N), dtype=torch.int32, device=kp_tbc.device) for _ in range(4))
    with torch.cuda.device(kp_tbc.device):
        rc = library().hm_lif_count_stateful_bipolar(
            *(x.data_ptr() for x in packed), params.w_in.data_ptr(), params.dash_syn.data_ptr(),
            params.dash_mem.data_ptr(), params.threshold.data_ptr(), isyn0.data_ptr(),
            vmem0.data_ptr(), spk0.data_ptr(), *(o.data_ptr() for o in out),
            T, packed.slots.shape[1], B, C, N, params.rec_coef, int(not params.no_sat),
            stream_handle(kp_tbc.device),
        )
    check(rc, "lif_k4")
    launch_counts["lif_k4"] += 1
    return out


def _as_spikes_tbc(spikes: torch.Tensor, time_major: bool) -> torch.Tensor:
    """int8 or bool spikes as they are, any other dtype cast with
    ``.to(torch.int8)`` (the Pallas wrapper's ``jnp.asarray(spikes,
    jnp.int8)``, ``lif_kernel.py:250``: values outside int8 wrap there too);
    time-major (T, B, C) and contiguous."""
    if spikes.dtype not in _SPIKE_DTYPES:
        spikes = spikes.to(torch.int8)
    if not time_major:
        spikes = spikes.transpose(0, 1)
    return spikes.contiguous()


def _check_raster(params: LifParams, spikes_tbc: torch.Tensor):
    """Validate a K5/K6 raster against the params; returns (T, B, C, N)."""
    require_cuda(spikes_tbc, "spikes", _SPIKE_DTYPES, 3)
    if params.w_in.device != spikes_tbc.device:
        raise ValueError(f"the LIF params live on {params.w_in.device}, the spikes on {spikes_tbc.device}")
    T, B, C = spikes_tbc.shape
    N = params.w_in.shape[1]
    if params.w_in.shape[0] != C:
        raise ValueError(f"w_in has {params.w_in.shape[0]} rows; the spikes have {C} channels")
    if C > library().hm_lif_max_raster_channels():
        raise ValueError(f"{C} input channels exceed the kernel's {library().hm_lif_max_raster_channels()}")
    _check_rec(params, N)
    return T, B, C, N


def pack_raster(spikes_tbc: torch.Tensor) -> torch.Tensor:
    """K5/K6's pack pass: the time-major (T, B, C) raster (int8, or bool
    read as 0/1) → (B, Tp, Cpad) int8, see :func:`pack_raster_plain`."""
    if spikes_tbc.device.type == "cpu":
        return pack_raster_plain(spikes_tbc)
    require_cuda(spikes_tbc, "spikes", _SPIKE_DTYPES, 3)
    T, B, C = spikes_tbc.shape
    if C > library().hm_lif_max_raster_channels():
        raise ValueError(f"{C} input channels exceed the kernel's {library().hm_lif_max_raster_channels()}")
    packed = torch.empty((B, _words_steps(T), padded_channels(C)), dtype=torch.int8,
                         device=spikes_tbc.device)
    with torch.cuda.device(spikes_tbc.device):
        rc = library().hm_lif_pack_raster(spikes_tbc.data_ptr(), packed.data_ptr(), T, packed.shape[1], B, C,
                                          stream_handle(spikes_tbc.device))
    check(rc, "lif_pack_raster")
    launch_counts["lif_pack_raster"] += 1
    return packed


def _raster_args(params: LifParams, packed: torch.Tensor, T: int, N: int):
    """The integer arguments both K5 and K6 take after their pointers."""
    _, P, KT, _, _ = params.w_frag.shape
    return T, packed.shape[1], packed.shape[0], KT, P, N, params.rec_coef, int(not params.no_sat)


def lif_count_rates(config, spikes: torch.Tensor, time_major: bool = False,
                    spike_bound: int | None = None) -> torch.Tensor:
    """Hidden-layer spike counts (B, N_hid) int32 of the quantized LIF
    network from a zero state; the sum over time of
    ``sim_hidden_batch(config, spikes)`` without the raster.

    ``spikes`` is (B, T, C), or (T, B, C) with ``time_major=True``, with any
    integer values: int8 or bool as they are, any other dtype cast with
    ``.to(torch.int8)``, so values outside [-128, 127] wrap, as in the
    Pallas wrapper.  ``config`` is a ``XyloConfig`` or its
    :class:`LifParams` (w_in of C rows).  ``spike_bound``: a
    caller-guaranteed bound on the per-step spike values (1 for RZCC masks)
    that lets the static proof drop the 16-bit clips; None keeps them (see
    :func:`lif_params`)."""
    spikes_tbc = _as_spikes_tbc(spikes, time_major)
    if spikes_tbc.device.type == "cpu":
        return lif_count_stateful_plain(config, spikes_tbc)[0]
    params = lif_params(config, spikes_tbc.device, spike_bound)
    T, B, C, N = _check_raster(params, spikes_tbc)
    packed = pack_raster(spikes_tbc)
    counts = torch.empty((B, N), dtype=torch.int32, device=spikes_tbc.device)
    with torch.cuda.device(spikes_tbc.device):
        rc = library().hm_lif_count(
            packed.data_ptr(), params.w_frag.data_ptr(), params.dash_syn.data_ptr(),
            params.dash_mem.data_ptr(), params.threshold.data_ptr(), counts.data_ptr(),
            *_raster_args(params, packed, T, N), stream_handle(spikes_tbc.device),
        )
    check(rc, "lif_k5")
    launch_counts["lif_k5"] += 1
    return counts


def lif_count_stateful(config, spikes: torch.Tensor, isyn0: torch.Tensor, vmem0: torch.Tensor,
                       spk0: torch.Tensor, spike_bound: int | None = None, time_major: bool = False):
    """Stateful LIF: spikes (as :func:`lif_count_rates` takes them) and the
    (B, N) int32 initial state → ``(counts, isyn, vmem, spk)``, all (B, N)
    int32: the streaming form of :func:`lif_count_rates`, whose state
    carries across chunk calls.  ``spk0`` holds 0/1 values.

    ``spike_bound``: as in :func:`lif_count_rates`; the caller additionally
    guarantees that the initial state came from the same bounded dynamics
    (zeros plus earlier chunks of the same stream), so the no-saturation
    invariant carries across chunks (``lif_kernel.py:810-813``).  A state
    from elsewhere needs ``spike_bound=None``."""
    spikes_tbc = _as_spikes_tbc(spikes, time_major)
    if spikes_tbc.device.type == "cpu":
        return lif_count_stateful_plain(config, spikes_tbc, isyn0, vmem0, spk0)
    params = lif_params(config, spikes_tbc.device, spike_bound)
    T, B, C, N = _check_raster(params, spikes_tbc)
    _check_state(B, N, spikes_tbc.device, isyn0, vmem0, spk0)
    packed = pack_raster(spikes_tbc)
    out = tuple(torch.empty((B, N), dtype=torch.int32, device=spikes_tbc.device) for _ in range(4))
    with torch.cuda.device(spikes_tbc.device):
        rc = library().hm_lif_count_stateful(
            packed.data_ptr(), params.w_frag.data_ptr(), params.dash_syn.data_ptr(),
            params.dash_mem.data_ptr(), params.threshold.data_ptr(), isyn0.data_ptr(),
            vmem0.data_ptr(), spk0.data_ptr(), *(o.data_ptr() for o in out),
            *_raster_args(params, packed, T, N), stream_handle(spikes_tbc.device),
        )
    check(rc, "lif_k6")
    launch_counts["lif_k6"] += 1
    return out
