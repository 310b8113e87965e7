"""Design cache keys, the bundled designs and a writable design cache
(counterpart of ``haghighatshoarmuir2024_tpu/utils/cache.py:144-186``).

The flagship design and calibration tables are committed as ``.npz`` files
in the port's own ``data/designs/``, byte for byte the JAX package's bundled
files (``haghighatshoarmuir2024_tpu/data/designs/``, a test holds their
hashes equal), so the port needs nothing of the JAX package's tree.  They
are read, never written.  What the port designs or calibrates itself goes
to its own user directory (:class:`DesignCache`), never to the JAX
package's ``~/.cache/hm2024_tpu``: a design computed in float32 on the card
differs from the JAX package's by about 1e-5 per column, and neither
package's parity may rest on the other's numbers.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

CACHE_ENV = "HM2024_TORCH_CACHE"  # the user directory's override
BUNDLED_DIR = Path(__file__).resolve().parent.parent / "data" / "designs"


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


class DesignCache:
    """Designs and calibration tables by :func:`design_cache_key`: the user
    directory first, then the bundled files (JAX ``DesignCache``,
    ``cache.py:160-186``).  :meth:`save` writes to the user directory only,
    atomically (a file of its own, then ``os.replace``), so that processes
    saving the same key at once leave one whole file.  The user directory
    is ``cache_dir``, else ``$HM2024_TORCH_CACHE``, else
    ``~/.cache/hm2024_torch``, read when the cache is made."""

    def __init__(self, cache_dir=None):
        self.dir = Path(cache_dir or os.environ.get(CACHE_ENV) or Path.home() / ".cache" / "hm2024_torch")

    def path(self, key: str) -> Path:
        return self.dir / f"{key}.npz"

    def load(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        """The arrays of ``key`` from the user directory, else the bundled
        file, else None."""
        for p in (self.path(key), bundled_path(key)):
            if p.exists():
                with np.load(p, allow_pickle=False) as z:
                    return {k: z[k] for k in z.files}
        return None

    def save(self, key: str, arrays: Dict[str, np.ndarray]) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.dir, prefix=f".{key}.", suffix=".npz")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
            os.replace(tmp, self.path(key))
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
