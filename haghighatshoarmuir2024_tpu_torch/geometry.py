"""Array geometries and the plane-wave delay model (counterpart of
``haghighatshoarmuir2024_tpu/geometry.py``; reference:
micloc/array_geometry.py:17-131).

``r_vec``/``theta_vec`` stay float64 numpy arrays, byte-identical to the JAX
package's: the design cache key hashes their bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import SOUND_SPEED_IN_OPEN_AIR


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``, the card (``"cuda"``) when None: the
    port runs on the GPU unless the caller asks for ``"cpu"``.  Asking for
    CUDA without a usable GPU raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but no CUDA device is available")
    return dev


def as_device_tensor(x, device=None) -> torch.Tensor:
    """``x`` as it is if it is a tensor (it stays on its device), else as a
    tensor on :func:`resolve_device` of ``device``: the card unless the
    caller asks for ``"cpu"``."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=resolve_device(device))


class ArrayGeometry:
    """Maps element polar coordinates to per-DoA propagation delays
    (micloc/array_geometry.py:17-61)."""

    def __init__(self, r_vec, theta_vec, speed: float = SOUND_SPEED_IN_OPEN_AIR):
        r_vec = np.asarray(r_vec, dtype=np.float64)
        theta_vec = np.asarray(theta_vec, dtype=np.float64)
        if np.any(r_vec < 0):
            raise ValueError("distances of the elements in `r_vec` should be all positive!")
        self.r_vec = r_vec
        self.theta_vec = theta_vec
        self.speed = float(speed)

    def delays(self, theta: torch.Tensor) -> torch.Tensor:
        """Non-normalized delays ``-r·cos(θ_vec − θ)/speed`` of shape
        ``theta.shape + (M,)`` (micloc/array_geometry.py:40-57), in
        ``theta``'s dtype and on its device."""
        dtype = theta.dtype if theta.is_floating_point() else torch.float64
        r = torch.as_tensor(self.r_vec, dtype=dtype, device=theta.device)
        tv = torch.as_tensor(self.theta_vec, dtype=dtype, device=theta.device)
        return -r * torch.cos(tv - theta.to(dtype)[..., None]) / self.speed

    def delays_np(self, theta, normalized: bool = True) -> np.ndarray:
        """Host float64 delays of shape ``theta.shape + (M,)``, min-shifted to
        0 per DoA when ``normalized`` (JAX ``geometry.py:59-66``)."""
        theta = np.asarray(theta, dtype=np.float64)
        d = -self.r_vec * np.cos(self.theta_vec - theta[..., None]) / self.speed
        if normalized:
            d = d - np.min(d, axis=-1, keepdims=True)
        return d

    def __len__(self) -> int:
        return len(self.r_vec)


class CenterCircularArray(ArrayGeometry):
    """Ring of ``num_mic - 1`` microphones plus one at the center
    (micloc/array_geometry.py:81-94, same duplicated-first-mic quirk)."""

    def __init__(self, radius, num_mic, speed=SOUND_SPEED_IN_OPEN_AIR, endpoint=True):
        r_vec = np.array([*(radius * np.ones(num_mic - 1)), 0.0])
        theta_vec = np.array([*np.linspace(0, 2 * np.pi, num_mic - 1, endpoint=endpoint), 0.0])
        super().__init__(r_vec=r_vec, theta_vec=theta_vec, speed=speed)


class CircularArray(ArrayGeometry):
    """Uniform circular array (micloc/array_geometry.py:64-78).  The
    reference's ``np.linspace(0, 2π, num_mic)`` includes both endpoints, so
    the first and last microphones coincide; ``endpoint=False`` gives the
    physical layout."""

    def __init__(self, radius, num_mic, speed=SOUND_SPEED_IN_OPEN_AIR, endpoint=True):
        r_vec = radius * np.ones(num_mic)
        theta_vec = np.linspace(0, 2 * np.pi, num_mic, endpoint=endpoint)
        super().__init__(r_vec=r_vec, theta_vec=theta_vec, speed=speed)


class LinearArray(ArrayGeometry):
    """Uniform linear array, signed positions folded into polar form
    (micloc/array_geometry.py:97-119)."""

    def __init__(self, spacing, num_mic, radius=None, speed=SOUND_SPEED_IN_OPEN_AIR):
        r_vec = spacing * (np.arange(-num_mic / 2, num_mic / 2) + 0.5)
        theta_vec = np.zeros(num_mic)
        theta_vec[r_vec < 0] += np.pi
        super().__init__(r_vec=np.abs(r_vec), theta_vec=theta_vec, speed=speed)
        self.radius = radius


class Random2DArray(ArrayGeometry):
    """Microphones uniform on a disk (micloc/array_geometry.py:122-131).
    ``rng`` (a ``np.random.Generator`` or ``RandomState``) or ``seed`` makes
    the draw reproducible; with neither it comes from NumPy's global RNG, as
    in the reference."""

    def __init__(self, radius, num_mic, speed=SOUND_SPEED_IN_OPEN_AIR, seed=None, rng=None):
        if rng is None:
            rng = np.random.default_rng(seed) if seed is not None else np.random
        draw = rng.rand if hasattr(rng, "rand") else rng.random
        r_vec = np.sqrt(draw(num_mic)) * radius
        theta_vec = draw(num_mic) * 2 * np.pi
        super().__init__(r_vec=r_vec, theta_vec=theta_vec, speed=speed)
        self.radius = radius
