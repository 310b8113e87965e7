"""Device meshes for data-parallel serving and Monte Carlo (counterpart of
``haghighatshoarmuir2024_tpu/parallel/mesh.py``).

The JAX package shards its two large axes over a ``jax.sharding.Mesh``;
here a :class:`Mesh` is a 2-D array of ``torch.device`` named by axis, and a
sharded tensor is a list of per-device pieces.  The only sharded axis any
path uses is ``data`` (streams, Monte-Carlo trials), which is pure data
parallelism: each shard runs the unsharded program on its own piece, and
nothing moves between shards but what the caller gathers on the host.

A mesh may name one device more than once: eight shards on the one CPU are
the CPU tests' counterpart of JAX's virtual 8-device mesh, and four shards
on ``cuda:0`` split a batch on one card.  One host thread drives every
shard, each under its card's context (:func:`device_scope`).  A host thread
per card was tried: every PyTorch op releases and retakes the interpreter
lock, and four threads launching small ops handed it back and forth so often
that a step over four cards took longer than the four shards in turn on one
card (PERF.md).  The serving step instead launches every shard up to its one
host synchronization (K2's flag read) before it reads any, so every card has
its work queued while the host waits on one
(``StreamingLocalizer.make_sharded_step``).
"""
from __future__ import annotations

import contextlib
import io
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import as_device_tensor


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: a bare ``"cuda"``
    names the current card, so that it compares equal to ``cuda:<i>``."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 2-D array of devices with one name per axis; ``shape`` maps each
    name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device array needs {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis_name: str = "data") -> list:
        """The device of each position along ``axis_name``: where the shard
        of that position runs (the first device along the other axis, over
        which a data shard is replicated)."""
        if axis_name not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis_name!r} (axes {self.axis_names})")
        ax = self.axis_names.index(axis_name)
        return list(np.moveaxis(self.devices, ax, 0).reshape(self.devices.shape[ax], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("data", "model"), devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ``(data, model)`` mesh over the first ``n_devices`` of
    ``devices``: every visible CUDA card by default, or an explicit list in
    which a device may repeat.  The default shape puts all of them on the
    data axis.  Asking for more devices than the list holds raises."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        where = "visible CUDA cards"
    else:
        devs = [canonical_device(d) for d in devices]
        where = "devices given"
    if n_devices is None:
        n_devices = len(devs)
    if n_devices < 1 or n_devices > len(devs):
        raise ValueError(f"make_mesh asked for {n_devices} devices but there are {len(devs)} {where}; "
                         "pass devices= (a device may repeat, e.g. ['cpu'] * 8) for a mesh on fewer")
    devs = devs[:n_devices]
    if shape is None:
        shape = (n_devices, 1)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n_devices} devices")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def split(x, mesh: Mesh, axis: int = 0, axis_name: str = "data") -> list:
    """``x`` (a tensor or array) split along ``axis`` into one equal piece
    per position of ``axis_name``, each piece a tensor on its shard's
    device (the counterpart of ``shard_leading`` / ``data_sharding``)."""
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    t = torch.as_tensor(x)
    if t.shape[axis] % n:
        raise ValueError(f"axis {axis} of size {t.shape[axis]} does not divide the {n} shards of {axis_name!r}")
    return [p.to(d) for p, d in zip(torch.chunk(t, n, dim=axis), devices)]


def gather(pieces: Sequence[torch.Tensor], axis: int = 0, device="cpu") -> torch.Tensor:
    """The pieces of :func:`split` put back together on ``device``."""
    return torch.cat([p.to(device) for p in pieces], dim=axis)


def pad_to_multiple(x, multiple: int, axis: int = 0, device=None):
    """Zero-pad ``axis`` up to a multiple (a split axis must divide
    evenly).  Returns ``(padded, original_size)``.  An ``x`` that is not a
    tensor lands on ``device``, the card unless the caller passes
    ``"cpu"``."""
    x = as_device_tensor(x, device)
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def replicate_demo(demo, device):
    """A copy of ``demo`` on ``device`` made from its own state, the arrays
    that ``Demo.save`` writes and ``Demo.load(device=)`` reads (the design,
    the quantized integers, the profiles), never by designing again: a
    design made on another device is a different float.  ``demo`` itself
    when it already lies on ``device``."""
    device = canonical_device(device)
    if canonical_device(demo.device) == device:
        return demo
    buf = io.BytesIO()
    demo.save(buf)
    buf.seek(0)
    rep = type(demo).load(buf, device=device)
    rep.xylosim_version = demo.xylosim_version
    rep.enforce_hw_limits = demo.enforce_hw_limits
    if hasattr(demo, "spec"):
        rep.spec = demo.spec
    return rep


def device_scope(device):
    """``torch.cuda.device(device)`` for a card, so that its launches go to
    its own current stream; nothing for another device."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
