"""The envelope follower on the card: the wrapper of ``csrc/envelope.cu``,
the route :meth:`ops.envelope.Envelope.evolve` takes for a tensor off the
CPU.

It runs all T samples of :meth:`ops.envelope.Envelope.evolve_plain` in one
launch, a thread a lane of the (T, ...) signal seen as (T, L), and equals
the plain loop bit for bit, outputs and final state, in float32 and float64.
A block is a consumer warp of ``ENV_LANES`` lanes that carries the
recurrence in shared memory and a producer warp that copies x in and the
envelope out through a ring of ``ENV_STAGES`` tiles of ``ENV_TS`` steps
(:func:`plan` says how a call is cut).
It replaces no TPU kernel: the JAX package runs the follower as one
``lax.scan`` (``haghighatshoarmuir2024_tpu/ops/envelope.py:45``).

On CPU tensors :func:`envelope` runs the plain loop; on any other device it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import check, launch_counts, library, library_constants, stream_handle

# csrc/envelope.cu's LANES (lanes a block: the consumer warp), TS (steps a tile), STAGES (tiles in the ring),
# VEC_BYTES (a row copy's width) and CHAIN_X (the chain probe's samples a lane), as hm_envelope_constants gives them
ENV_LANES, ENV_TS, ENV_STAGES, ENV_VEC_BYTES, ENV_CHAIN_X = 32, 128, 4, 16, 8
DTYPES = {torch.float32: 0, torch.float64: 1}


@functools.lru_cache(maxsize=1)
def checked_library():
    """The kernel library, once its constants are held equal to this
    module's (``ENV_LANES``, ``ENV_TS``, ``ENV_STAGES``, ``ENV_VEC_BYTES``,
    ``ENV_CHAIN_X``): :func:`plan`, :func:`chain_cycles` and the CPU tests'
    model of the kernel read them."""
    want = (ENV_LANES, ENV_TS, ENV_STAGES, ENV_VEC_BYTES, ENV_CHAIN_X)
    got = library_constants("hm_envelope_constants", 5)
    if got != want:
        raise RuntimeError(f"csrc/envelope.cu's constants {got} differ from envelope_kernel's {want}")
    return library()


class EnvelopePlan(NamedTuple):
    """How ``hm_envelope`` cuts a (T, L) call: ``blocks`` of ``ENV_LANES``
    lanes, ``tiles`` of ``ENV_TS`` steps, the last tile's ``last_rows``
    (``ENV_TS`` when it is whole), and whether x and out move by 16-byte row
    copies (``vec_x``, ``vec_out``) or an item a lane a step."""
    blocks: int
    tiles: int
    last_rows: int
    vec_x: bool
    vec_out: bool


def vector_rows(L: int, itemsize: int, ptr: int) -> bool:
    """Whether ``csrc/envelope.cu`` moves a contiguous (T, L) tensor at
    address ``ptr`` by 16-byte row copies: L items make whole 16-byte
    vectors (so every block's rows start on one) and the base is 16-byte
    aligned."""
    return (L * itemsize) % ENV_VEC_BYTES == 0 and ptr % ENV_VEC_BYTES == 0


def plan(T: int, L: int, itemsize: int, x_ptr: int = 0, out_ptr: int = 0) -> EnvelopePlan:
    """The kernel's cut of a call on contiguous (T, L) ``x`` and ``out`` at
    addresses ``x_ptr`` and ``out_ptr``: the mirror, for the CPU's model of
    the kernel, of what ``hm_envelope`` makes (:func:`kernel_plan`)."""
    if T < 1 or L < 1:
        raise ValueError(f"the envelope kernel needs T, L >= 1 (got {T}, {L})")
    tiles = -(-T // ENV_TS)
    return EnvelopePlan(-(-L // ENV_LANES), tiles, T - (tiles - 1) * ENV_TS, vector_rows(L, itemsize, x_ptr),
                        vector_rows(L, itemsize, out_ptr))


def kernel_plan(T: int, L: int, dtype: torch.dtype, x_ptr: int, out_ptr: int) -> EnvelopePlan:
    """The cut ``hm_envelope`` makes of a (T, L) call on ``x`` and ``out``
    at ``x_ptr`` and ``out_ptr``, as the library computes it
    (``hm_envelope_plan``, from the function its launch calls): the card's
    checks hold :func:`plan` to it."""
    if dtype not in DTYPES:
        raise TypeError(f"the envelope kernel takes float32 or float64 (got {dtype})")
    lib = checked_library()
    got = (ctypes.c_longlong * len(EnvelopePlan._fields))()
    check(lib.hm_envelope_plan(T, L, DTYPES[dtype], x_ptr, out_ptr, got), "envelope_plan")
    blocks, tiles, last_rows, vec_x, vec_out = got
    return EnvelopePlan(blocks, tiles, last_rows, bool(vec_x), bool(vec_out))


def envelope(env, x: torch.Tensor, state=None, return_state: bool = False):
    """``env.evolve_plain(x, state, return_state)`` by the kernel: ``x``
    (T, ...) float32 or float64 on the card (the raw signal; the kernel takes
    its magnitude), ``state`` the follower state before sample 1 (broadcast
    to ``x.shape[1:]``) or None for ``|x[0]|``.  One launch for all T
    samples, cut as :func:`plan` says.  Raises ``TypeError`` for another dtype and ``ValueError`` for
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


def chain_samples(dtype: torch.dtype, seed: int = 0) -> torch.Tensor:
    """(ENV_CHAIN_X, ENV_LANES) samples for :func:`chain_cycles` on the CPU:
    magnitudes that alternate between large and small, so that each lane's
    state rises and falls in turn (the select takes both sides)."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor([4.0, 0.01] * (ENV_CHAIN_X // 2), dtype=torch.float64)[:, None]
    return (torch.rand((ENV_CHAIN_X, ENV_LANES), generator=g, dtype=torch.float64) * scale).to(dtype)


def chain_cycles(env, dtype: torch.dtype = torch.float32, n: int = 4096, device=None) -> float:
    """Cycles a step of the follower's chain on the card: one warp, each
    lane ``n`` steps of the kernel's ``step`` on :func:`chain_samples` held
    in registers, between two ``clock64`` reads (``hm_envelope_chain``)."""
    if dtype not in DTYPES:
        raise TypeError(f"the envelope chain takes float32 or float64 (got {dtype})")
    if n <= 0 or n % ENV_CHAIN_X:
        raise ValueError(f"the chain's steps must be a positive multiple of {ENV_CHAIN_X} (got {n})")
    lib = checked_library()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    xs = chain_samples(dtype).to(dev)
    out = torch.empty(ENV_LANES, dtype=dtype, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    wf, wr = (float(w) for w in env.win_lens)
    rc = lib.hm_envelope_chain(xs.data_ptr(), wf, wr, n, DTYPES[dtype], out.data_ptr(), cycles.data_ptr(),
                               stream_handle(dev))
    check(rc, "envelope_chain")
    launch_counts["envelope_chain"] += 1
    return int(cycles.item()) / n
