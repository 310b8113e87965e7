"""Design cache keys and the read-only lookup of the bundled designs
(counterpart of ``haghighatshoarmuir2024_tpu/utils/cache.py:144-179``).

The flagship design and calibration tables are committed as ``.npz`` files
inside the JAX package (``haghighatshoarmuir2024_tpu/data/designs/``).  They
are read here by path: importing that package would import JAX.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

BUNDLED_DIR = (
    Path(__file__).resolve().parent.parent.parent / "haghighatshoarmuir2024_tpu" / "data" / "designs"
)


def design_cache_key(**kwargs) -> str:
    """Stable hash of design inputs: arrays are hashed by bytes, everything
    else through canonical JSON.  Identical to the JAX package's key, so the
    same configuration resolves to the same bundled file."""
    h = hashlib.sha256()
    for name in sorted(kwargs):
        v = kwargs[name]
        h.update(name.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(json.dumps(v, sort_keys=True, default=str).encode())
    return h.hexdigest()[:32]


def bundled_path(key: str) -> Path:
    return BUNDLED_DIR / f"{key}.npz"


def load_bundled(key: str) -> Optional[Dict[str, np.ndarray]]:
    """Arrays of the bundled design ``key``, or None when it is not bundled."""
    p = bundled_path(key)
    if not p.exists():
        return None
    with np.load(p, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
