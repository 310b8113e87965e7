"""Chunked vmap: batched evaluation over a leading axis with bounded memory
(counterpart of ``haghighatshoarmuir2024_tpu/ops/batching.py``).

``torch.func.vmap(fn)`` runs on ``chunk`` leading rows at a time and the
results are concatenated, so a caller's intermediates scale with the chunk,
not with the whole axis.  Nothing is padded: JAX pads the last chunk only so
that ``lax.map`` sees one static shape.  The port's design loops batch their
grid axis inline (``models/beamformer.py``, ``models/snn_beamformer.py``).
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten


def chunked_vmap(fn, xs, chunk: int):
    """Apply ``vmap(fn)`` over the leading axis of ``xs`` in chunks.

    Args:
        fn: function on one element (no leading batch axis); may return a
            pytree (tuples, lists, dicts) of tensors.
        xs: tensor, or pytree of tensors, with a common leading axis G.
        chunk: rows a ``vmap`` call (the last chunk may be shorter).

    Returns:
        ``fn``'s pytree with each tensor's leading axis G.
    """
    leaves, spec = tree_flatten(xs)
    G = leaves[0].shape[0]
    chunk = max(1, min(int(chunk), G))
    vfn = torch.func.vmap(fn)
    outs = [tree_flatten(vfn(tree_unflatten([x[s:s + chunk] for x in leaves], spec)))
            for s in range(0, G, chunk)]
    out_spec = outs[0][1]
    return tree_unflatten([torch.cat(parts) for parts in zip(*(o[0] for o in outs))], out_spec)
