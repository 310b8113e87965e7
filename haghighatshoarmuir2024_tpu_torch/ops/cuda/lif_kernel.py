"""Integer-LIF spike counts from the RZCC polarity masks: wrapper of kernel
K3 (``csrc/lif.cu``), counterpart of ``lif_count_rates_bipolar`` in
``haghighatshoarmuir2024_tpu/ops/pallas/lif_kernel.py:407`` (Pallas kernel
``_lif_kernel_bipolar``, ``:275``).

On CPU tensors the wrapper runs the plain simulator
(``models/xylo/sim.sim_hidden``); on CUDA tensors it launches K3 or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ...models.xylo.sim import STATE_MAX, project_input, sim_hidden, uniform_rec_coef
from ._build import check, launch_counts, library, require_cuda, stream_handle

_MASK_DTYPES = (torch.bool, torch.uint8, torch.int8)


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


def lif_count_plain(config, kp_tbc: torch.Tensor, kn_tbc: torch.Tensor) -> torch.Tensor:
    """What K3 computes, by the plain simulator: (B, N) int32 counts of the
    (T, B, 2C) raster ``[kp & ~kn, kn]`` (the reference's overwrite: −1 wins
    on collision, micloc/xylo_snn_localization.py:344-355)."""
    kp, kn = kp_tbc != 0, kn_tbc != 0
    inp = project_input(config, torch.cat([kp & ~kn, kn], dim=-1))  # (T, B, N)
    _, counts = sim_hidden(inp, config.dash_syn, config.dash_mem, config.threshold,
                           uniform_rec_coef(config), record=False)
    return counts


def lif_count_rates_bipolar(config, kp_tbc: torch.Tensor, kn_tbc: torch.Tensor,
                            spike_bound: int | None = 1) -> torch.Tensor:
    """Hidden-layer spike counts (B, N_hid) int32 straight from the two
    time-major (T, B, C) RZCC polarity masks; ``config.w_in`` has 2C rows
    ([:C] positive, [C:] negative).

    ``spike_bound``: a caller-guaranteed bound on the per-step input spike
    values (1 for RZCC masks); with it the static proof may drop the 16-bit
    clips in the kernel (identical integers).
    """
    rec_coef = uniform_rec_coef(config)
    if kp_tbc.device.type == "cpu":
        return lif_count_plain(config, kp_tbc, kn_tbc)
    if rec_coef != 0:
        raise ValueError(
            "the CUDA LIF kernel does not implement the uniform recurrence "
            f"(w_rec = {rec_coef}·ones); run this config on CPU tensors"
        )
    require_cuda(kp_tbc, "kp_tbc", _MASK_DTYPES, 3)
    require_cuda(kn_tbc, "kn_tbc", _MASK_DTYPES, 3)
    if kn_tbc.shape != kp_tbc.shape or kn_tbc.dtype != kp_tbc.dtype or kn_tbc.device != kp_tbc.device:
        raise ValueError("kp_tbc and kn_tbc must have the same shape, dtype and device")
    T, B, C = kp_tbc.shape
    w_in = np.asarray(config.w_in)
    if w_in.shape[0] != 2 * C:
        raise ValueError(f"w_in has {w_in.shape[0]} rows; the masks need 2C = {2 * C}")
    lib = library()
    if C > lib.hm_lif_max_channels():
        raise ValueError(f"{C} channels per polarity exceed the kernel's {lib.hm_lif_max_channels()}")
    no_sat = spike_bound is not None and _no_saturation_possible(config, spike_bound, rec_coef)

    dev = kp_tbc.device
    N = w_in.shape[1]
    w = torch.as_tensor(w_in, dtype=torch.int32, device=dev).contiguous()
    ds = torch.as_tensor(np.asarray(config.dash_syn), dtype=torch.int32, device=dev)
    dm = torch.as_tensor(np.asarray(config.dash_mem), dtype=torch.int32, device=dev)
    th = torch.as_tensor(np.asarray(config.threshold), dtype=torch.int32, device=dev)
    counts = torch.empty((B, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hm_lif_count_bipolar(
            kp_tbc.data_ptr(), kn_tbc.data_ptr(), w.data_ptr(), ds.data_ptr(), dm.data_ptr(),
            th.data_ptr(), counts.data_ptr(), T, B, C, N, int(not no_sat), stream_handle(dev),
        )
    check(rc, "lif_k3")
    launch_counts["lif_k3"] += 1
    return counts
