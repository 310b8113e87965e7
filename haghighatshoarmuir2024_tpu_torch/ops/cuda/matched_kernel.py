"""Matched scoring on the card: the wrapper of ``csrc/matched.cu``, the
epilogue of the ``"matched"`` estimator (``models/xylo/pipeline.Demo.
doa_scores``).

The scores are the centred rates' dot products with the calibrated profiles,
``(rate - mean(rate)) · tableᵀ``.  The plain version is one ``torch.matmul``,
whose rounding on the card follows the number of frames in the call; the
kernel gives each frame its scores by one fixed order of summation, whatever
the batch (a frame alone, in a shard, or among 96).  It replaces no TPU
kernel: the JAX package computes this through XLA.

On CPU tensors :func:`matched_scores` runs the plain version; on any other
device it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ._build import check, launch_counts, library, require_cuda, stream_handle


def matched_scores_plain(rate: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(..., K) rates and a (G, K) table → the (..., G) matched scores."""
    return torch.matmul(rate - rate.mean(dim=-1, keepdim=True), table.T)


def matched_scores(rate: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """:func:`matched_scores_plain` by the kernel for a CUDA ``rate``.
    Raises ``ValueError`` for rows longer than the kernel's shared memory
    holds (12 000 entries)."""
    if rate.device.type == "cpu":
        return matched_scores_plain(rate, table)
    lib = library()
    lead, K = rate.shape[:-1], rate.shape[-1]
    G = table.shape[0]
    r = rate.to(torch.float32).reshape(-1, K).contiguous()
    t = table.to(torch.float32).contiguous()
    require_cuda(r, "rate", (torch.float32,), 2)
    require_cuda(t, "table", (torch.float32,), 2)
    if K > lib.hm_matched_max_k():
        raise ValueError(f"matched_scores takes rows of at most {lib.hm_matched_max_k()} entries (got {K})")
    out = torch.empty((r.shape[0], G), dtype=torch.float32, device=r.device)
    if r.shape[0]:
        check(lib.hm_matched(r.data_ptr(), t.data_ptr(), out.data_ptr(), r.shape[0], K, G, stream_handle(r.device)),
              "matched")
        launch_counts["matched"] += 1
    return out.reshape(*lead, G)
