"""The system under test, built from a configuration: the port's ``Demo``
with the configuration's frozen design inputs handed in through the port's
design cache directory (``HM2024_TORCH_CACHE``), which this module fills
under the checkout.  The port's set-up then quantizes the design and reads
the matched profiles; it designs nothing.  The benchmark's reference is
handed the same arrays (``Config.arrays``)."""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CONFIG_DIR = Path(__file__).resolve().parent / "configs"
CACHE_DIR = ROOT / "build" / "hmbench" / "design_cache"


class Config:
    """A configuration file (``configs/<name>.json``) and its design inputs
    (the ``.npz`` it names)."""

    def __init__(self, name: str):
        self.name = name
        self.spec = json.loads((CONFIG_DIR / f"{name}.json").read_text())
        with np.load(CONFIG_DIR / self.spec["design_inputs"], allow_pickle=False) as z:
            self.arrays = {k: z[k] for k in z.files}
        self.model = self.spec["model"]

    @property
    def fs(self) -> float:
        return float(self.model["fs"])

    @property
    def frame_samples(self) -> int:
        return int(round(self.fs * float(self.model["frame_s"])))

    @property
    def bands(self) -> int:
        return len(self.model["freq_bands"])

    def source(self) -> dict:
        """The source signal of the configuration's frames, with a template's
        samples filled in."""
        src = dict(self.spec["source_signal"])
        if src["kind"] == "template":
            src["sig"] = self.arrays["template"]
        return src

    def calibration_template(self):
        """(t, sig) the profiles were calibrated on, or None for the port's
        default (a tone at the first band's centre)."""
        if self.spec["calibration"] == "default":
            return None
        return np.arange(self.frame_samples) / self.fs, np.asarray(self.arrays["template"], np.float64)


def _demo_kwargs(cfg: Config, device) -> dict:
    from haghighatshoarmuir2024_tpu_torch.geometry import CenterCircularArray

    m = cfg.model
    a = m["array"]
    return dict(geometry=CenterCircularArray(radius=float(a["radius_m"]), num_mic=int(a["num_mic"]),
                                             speed=float(a["speed_m_s"])),
                freq_bands=m["freq_bands"], doa_list=np.linspace(-np.pi, np.pi, int(m["grid_points"])),
                recording_duration=float(m["frame_s"]), kernel_duration=float(m["kernel_duration_s"]),
                bipolar_spikes=bool(m["bipolar_spikes"]), fs=m["fs"],
                enforce_hw_limits=bool(m["enforce_hw_limits"]), device=device)


def _write(path: Path, arrays: dict) -> None:
    """Write ``arrays`` to ``path`` unless the file there holds them."""
    if path.exists():
        with np.load(path, allow_pickle=False) as z:
            if set(z.files) == set(arrays) and all(np.array_equal(z[k], v) for k, v in arrays.items()):
                return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def fill_cache(cfg: Config) -> Path:
    """The configuration's design and profiles as the port's design cache
    files, under the keys the port computes for them; returns the directory."""
    from haghighatshoarmuir2024_tpu_torch.utils.cache import design_cache_key

    kw = _demo_kwargs(cfg, "cpu")
    g = kw["geometry"]
    bands = np.atleast_2d(np.asarray(kw["freq_bands"], dtype=np.float64))
    common = dict(r_vec=g.r_vec, theta_vec=g.theta_vec, freq_bands=bands, doa_list=kw["doa_list"],
                  recording_duration=kw["recording_duration"], kernel_duration=kw["kernel_duration"],
                  bipolar=kw["bipolar_spikes"], fs=kw["fs"], version=1)
    d = CACHE_DIR / cfg.name
    _write(d / f"{design_cache_key(speed=g.speed, **common)}.npz",
           {f"bf_{i}": cfg.arrays[f"bf_{i}"] for i in range(cfg.bands)})
    tmpl = cfg.calibration_template()
    if tmpl is None:
        t = np.arange(0, kw["recording_duration"], 1.0 / kw["fs"])
        sig = np.sin(2 * np.pi * float(np.mean(bands[0])) * t)
    else:
        sig = tmpl[1]
    _write(d / f"{design_cache_key(kind='profiles', sig=np.asarray(sig, np.float32), **common)}.npz",
           {"profiles": cfg.arrays["profiles"]})
    return d


def build_demo(cfg: Config, device):
    """The port's calibrated ``Demo`` on ``device`` from the configuration's
    design inputs.  Raises if the port did not take them from the cache."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo

    os.environ["HM2024_TORCH_CACHE"] = str(fill_cache(cfg))
    demo = Demo(**_demo_kwargs(cfg, device), use_cache=True)
    profiles = demo.calibrate_profiles(template=cfg.calibration_template(), use_cache=True)
    for i in range(cfg.bands):
        if not np.array_equal(np.asarray(demo.bf_mats[i]), cfg.arrays[f"bf_{i}"]):
            raise RuntimeError(f"the port designed band {i} instead of reading the configuration's design")
    if not np.array_equal(np.asarray(profiles), cfg.arrays["profiles"]):
        raise RuntimeError("the port calibrated instead of reading the configuration's profiles")
    return demo
