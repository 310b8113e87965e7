"""Matched scoring on the card: the wrapper of ``csrc/matched.cu``, the
epilogue of the ``"matched"`` estimator (``models/xylo/pipeline.Demo.
doa_scores``).

The scores are the centred rates' dot products with the calibrated profiles,
``(rate - mean(rate)) · tableᵀ``.  The plain version is one ``torch.matmul``,
whose rounding on the card follows the number of frames in the call; the
kernel gives each frame its scores by one fixed order of summation, whatever
the batch (a frame alone, in a shard, or among 96).  It replaces no TPU
kernel: the JAX package computes this through XLA.

The band-stacked estimators (``matched_stacked``, ``matched_auto``) score
through the same kernel without the centring (``center=False``): their
products are of rates the caller has already normalized, and
:func:`band_scores` takes their per-band products one band a launch.  Their
normalizations' sums (means, norms, the blend's weighted sum) are sums of a
row against a row of ones by the same kernel, :func:`row_sums`, so each is
taken in one fixed order too (a reduction's order on the card otherwise
follows the number of rows in the call).

On CPU tensors :func:`matched_scores`, :func:`band_scores` and
:func:`row_sums` run their plain versions; on any other device they launch
the kernel or raise.
"""
from __future__ import annotations

import torch

from ._build import check, launch_counts, library, require_cuda, stream_handle

K_MAX = 12_000  # csrc/matched.cu's K_MAX: the longest rate row it takes (hm_matched_max_k)


def matched_scores_plain(rate: torch.Tensor, table: torch.Tensor, center: bool = True) -> torch.Tensor:
    """(..., K) rates and a (G, K) table → the (..., G) matched scores; with
    ``center=False`` the rates' plain products with the table."""
    return torch.matmul(rate - rate.mean(dim=-1, keepdim=True) if center else rate, table.T)


def matched_scores(rate: torch.Tensor, table: torch.Tensor, center: bool = True) -> torch.Tensor:
    """:func:`matched_scores_plain` by the kernel for a CUDA ``rate``.
    Raises ``ValueError`` for rows longer than the kernel takes (12 000
    entries)."""
    if rate.device.type == "cpu":
        return matched_scores_plain(rate, table, center)
    lib = library()
    lead, K = rate.shape[:-1], rate.shape[-1]
    G = table.shape[0]
    r = rate.to(torch.float32).reshape(-1, K).contiguous()
    t = table.to(torch.float32).contiguous()
    require_cuda(r, "rate", (torch.float32,), 2)
    require_cuda(t, "table", (torch.float32,), 2)
    if t.shape[1] != K:
        raise ValueError(f"matched_scores: rate rows of {K} entries against a table of rows of {t.shape[1]}")
    if K > K_MAX:
        raise ValueError(f"matched_scores takes rows of at most {K_MAX} entries (got {K})")
    out = torch.empty((r.shape[0], G), dtype=torch.float32, device=r.device)
    if r.shape[0]:
        check(lib.hm_matched(r.data_ptr(), t.data_ptr(), out.data_ptr(), r.shape[0], K, G, int(center),
                             stream_handle(r.device)), "matched")
        launch_counts["matched"] += 1
    return out.reshape(*lead, G)


def band_scores_plain(cb: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """(..., F, G) band blocks and a (P, F, G) table → the (..., F, P)
    per-band products (``_auto_blend_scores``'s ``Sb``)."""
    return torch.einsum("...fg,pfg->...fp", cb, pb)


def band_scores(cb: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """:func:`band_scores_plain` by the kernel for a CUDA ``cb``: one
    :func:`matched_scores` launch a band, without the centring."""
    if cb.device.type == "cpu":
        return band_scores_plain(cb, pb)
    return torch.stack([matched_scores(cb[..., f, :], pb[:, f, :], center=False) for f in range(cb.shape[-2])],
                       dim=-2)


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """(..., K) → (...,) the sums of the trailing axis: ``x.sum(-1)`` on the
    CPU, and on the card :func:`matched_scores` of ``x`` against one row of
    ones without the centring, one fixed order of summation a row."""
    if x.device.type == "cpu":
        return x.sum(dim=-1)
    return matched_scores(x, x.new_ones((1, x.shape[-1]), dtype=torch.float32), center=False)[..., 0]
