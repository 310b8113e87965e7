"""The envelope follower on the card: the wrapper of ``csrc/envelope.cu``,
the route :meth:`ops.envelope.Envelope.evolve` takes for a tensor off the
CPU.

It runs all T samples of :meth:`ops.envelope.Envelope.evolve_plain` in one
launch, a thread a lane of the (T, ...) signal seen as (T, L), and equals
the plain loop bit for bit, outputs and final state, in float32 and float64.
It replaces no TPU kernel: the JAX package runs the follower as one
``lax.scan`` (``haghighatshoarmuir2024_tpu/ops/envelope.py:45``).

On CPU tensors :func:`envelope` runs the plain loop; on any other device it
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from ._build import check, launch_counts, library, library_constants, stream_handle

# csrc/envelope.cu's THREADS (lanes a block) and AHEAD (samples read ahead), as hm_envelope_constants gives them
ENV_THREADS, ENV_AHEAD = 128, 16
DTYPES = {torch.float32: 0, torch.float64: 1}


@functools.lru_cache(maxsize=1)
def checked_library():
    """The kernel library, once its constants are held equal to this
    module's (``ENV_THREADS``, ``ENV_AHEAD``)."""
    got = library_constants("hm_envelope_constants", 2)
    if got != (ENV_THREADS, ENV_AHEAD):
        raise RuntimeError(f"csrc/envelope.cu's constants {got} differ from envelope_kernel's "
                           f"{(ENV_THREADS, ENV_AHEAD)}")
    return library()


def envelope(env, x: torch.Tensor, state=None, return_state: bool = False):
    """``env.evolve_plain(x, state, return_state)`` by the kernel: ``x``
    (T, ...) float32 or float64 on the card (the raw signal; the kernel takes
    its magnitude), ``state`` the follower state before sample 1 (broadcast
    to ``x.shape[1:]``) or None for ``|x[0]|``.  One launch for all T
    samples.  Raises ``TypeError`` for another dtype and ``ValueError`` for
    an empty signal or a tensor off the card."""
    if x.device.type == "cpu":
        return env.evolve_plain(x, state, return_state)
    if x.dtype not in DTYPES:
        raise TypeError(f"the envelope kernel takes float32 or float64 (got {x.dtype})")
    if x.dim() == 0 or x.shape[0] == 0:
        raise ValueError(f"the envelope needs at least one sample (got shape {tuple(x.shape)})")
    if x.device.type != "cuda":
        raise ValueError(f"the envelope kernel runs on CUDA tensors (got {x.device})")
    lib = checked_library()
    T, lanes = x.shape[0], x.shape[1:]
    xs = x.reshape(T, -1).contiguous()
    L = xs.shape[1]
    s0 = None if state is None else \
        torch.broadcast_to(torch.as_tensor(state, dtype=x.dtype, device=x.device), lanes).reshape(L).contiguous()
    out = torch.empty((T, L), dtype=x.dtype, device=x.device)
    s_fin = torch.empty(L, dtype=x.dtype, device=x.device)
    if L:
        wf, wr = (float(w) for w in env.win_lens)
        rc = lib.hm_envelope(xs.data_ptr(), None if s0 is None else s0.data_ptr(), out.data_ptr(),
                             s_fin.data_ptr(), wf, wr, T, L, DTYPES[x.dtype], stream_handle(x.device))
        check(rc, "envelope")
        launch_counts["envelope"] += 1
    out, s_fin = out.reshape(x.shape), s_fin.reshape(lanes)
    return (out, s_fin) if return_state else out
