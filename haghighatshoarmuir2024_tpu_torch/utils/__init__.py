"""Counterparts of haghighatshoarmuir2024_tpu/utils."""
import numpy as np
import torch

from .profiling import StageTimer, benchmark_fn, device_trace


def to_numpy(x) -> np.ndarray:
    """A tensor (complex too) or array-like → a numpy array on the host
    (JAX ``utils/__init__.py:17``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


__all__ = ["to_numpy", "StageTimer", "benchmark_fn", "device_trace"]
