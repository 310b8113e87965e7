"""Integer LIF simulator, plain PyTorch (counterpart of ``_sim_hidden`` in
``haghighatshoarmuir2024_tpu/models/xylo/sim.py:61-123``, decay_first /
subtract; reference: rockpool ``XyloSim`` as used at
micloc/xylo_snn_localization.py:286-377).

Per step, per hidden neuron, all int32:

    isyn ← sat(isyn − (isyn >> dash_syn) + inp + rec_coef·Σ spk_prev)
    vmem ← sat(vmem − (vmem >> dash_mem) + isyn)
    spk  ← vmem ≥ threshold;  vmem ← vmem − spk·threshold

with ``>>`` arithmetic and ``sat`` the 16-bit state range.  This is the plain
version of kernels K3 and K4 (``ops/cuda/lif_kernel.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .quantize import XyloConfig

STATE_MIN = -(2**15)
STATE_MAX = 2**15 - 1


def uniform_rec_coef(config: XyloConfig) -> int:
    """The scalar c of a uniform ``w_rec = c·ones`` (0 for an empty one);
    raises for a non-uniform recurrence, which only a dense scan handles."""
    wr = np.asarray(config.w_rec)
    if wr.size and not np.all(wr == wr.flat[0]):
        raise ValueError("the integer LIF here requires a uniform w_rec")
    return int(wr.flat[0]) if wr.size else 0


def project_input(config: XyloConfig, spikes: torch.Tensor) -> torch.Tensor:
    """Input current ``spikes @ w_in`` as int32 (float64 products, exact for
    integer operands below 2^53)."""
    w = torch.as_tensor(config.w_in, device=spikes.device).to(torch.float64)
    return torch.matmul(spikes.to(torch.float64), w).to(torch.int32)


def sim_hidden(inp: torch.Tensor, dash_syn, dash_mem, threshold, rec_coef: int = 0,
               record: bool = True, state0=None):
    """Scan the hidden-layer integer LIF over time.

    Args:
        inp: (T, ..., N) int32 input current per step (time leading, any
            batch dims between).
        dash_syn, dash_mem, threshold: (N,) integers (arrays or tensors).
        rec_coef: uniform recurrence coefficient (feedback ``c·Σ_n spk``,
            summed over the N neurons of the same batch row).
        record: also return the (T, ..., N) int32 spike raster.
        state0: initial ``(isyn, vmem, spk)``, each (..., N) int32; zeros
            when None (the ``state0`` of JAX ``_sim_hidden``).

    Returns:
        ``(spikes or None, counts, (isyn, vmem, spk))``: counts (..., N)
        int32 and the final state.  With T = 0 the final state is ``state0``.
    """
    dev = inp.device
    ds, dm, th = (torch.as_tensor(a, device=dev).to(torch.int32) for a in (dash_syn, dash_mem, threshold))
    if state0 is None:
        isyn = torch.zeros(inp.shape[1:], dtype=torch.int32, device=dev)
        vmem = torch.zeros_like(isyn)
        spk = torch.zeros_like(isyn)
    else:
        isyn, vmem, spk = (torch.as_tensor(s, device=dev).to(torch.int32) for s in state0)
    counts = torch.zeros(inp.shape[1:], dtype=torch.int32, device=dev)
    raster = [] if record else None
    for t in range(inp.shape[0]):
        cur = inp[t]
        if rec_coef:
            cur = cur + rec_coef * spk.sum(dim=-1, keepdim=True, dtype=torch.int32)
        isyn = torch.clamp(isyn - (isyn >> ds) + cur, STATE_MIN, STATE_MAX)
        vmem = torch.clamp(vmem - (vmem >> dm) + isyn, STATE_MIN, STATE_MAX)
        spk = (vmem >= th).to(torch.int32)
        vmem = vmem - spk * th
        counts += spk
        if record:
            raster.append(spk)
    spikes = torch.stack(raster) if record else None
    return spikes, counts, (isyn, vmem, spk)


def sim_hidden_batch(config: XyloConfig, spikes_in_batch: torch.Tensor) -> torch.Tensor:
    """Stateless batched evolve: (B, T, N_in) → hidden spikes (B, T, N_hid)
    (counterpart of ``sim_hidden_batch``, ``sim.py:365``)."""
    inp = project_input(config, spikes_in_batch.transpose(0, 1))  # (T, B, N)
    spikes, _, _ = sim_hidden(inp, config.dash_syn, config.dash_mem, config.threshold,
                           uniform_rec_coef(config))
    return spikes.transpose(0, 1)
