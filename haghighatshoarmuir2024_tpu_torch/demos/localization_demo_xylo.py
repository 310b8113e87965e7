"""Live quantized-SNN localization demo (counterpart of
``haghighatshoarmuir2024_tpu/demos/localization_demo_xylo.py``; reference:
``Demo.run_demo``, micloc/xylo_snn_localization.py:446-542): frame capture
→ RMS activity gate → spike encoding → integer SNN → rate → DoA →
visualizer.

On the card a frame runs ``models.xylo.Demo.forward``: the encode, K1 and
K2 (RZCC), the raster pack and K5 (LIF counts), the estimator.  The gate
runs in float64 on the host, as JAX's does.

    python -m haghighatshoarmuir2024_tpu_torch.demos.localization_demo_xylo [--frames N] [--device cpu]
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import FS
from ..geometry import CenterCircularArray
from ..io import AudioSource, Visualizer
from ..models.xylo import Demo as XyloDemo
from ..utils.profiling import StageTimer
from .localization_demo import cli, run_frames, tone_source


class Demo:
    """The live loop around a quantized model ``xylo_demo``, on that
    model's device.  ``method`` is the estimator ``xylo_demo.forward``
    runs (``"peak"``, or ``"matched"`` on a calibrated model)."""

    def __init__(
        self,
        xylo_demo: XyloDemo,
        source: Optional[AudioSource] = None,
        visualizer: Optional[Visualizer] = None,
        rel_threshold: float = 1e-4,
        full_scale: float = 1.0,
        method: str = "peak",
    ):
        self.xylo = xylo_demo
        self.source = source
        self.vz = visualizer or Visualizer(headless=True)
        self.timer = StageTimer()
        # activity threshold relative to full scale
        # (micloc/xylo_snn_localization.py:481-507 uses 1e-4 x int max)
        self.threshold = rel_threshold * full_scale
        self.method = method

    def process_frame(self, data) -> float:
        """One frame → DoA (radians), NaN when its RMS is below the
        threshold (no activity: nothing goes to the device)."""
        power_rec = float(np.sqrt(np.mean(np.asarray(data, dtype=np.float64) ** 2)))
        if power_rec < self.threshold:
            return float("nan")  # no activity (the reference pushes NaN)
        doa, _rate = self.xylo.forward(data, method=self.method)
        return float(doa)

    def run(self, num_frames: Optional[int] = None) -> list:
        return run_frames(self.source, self.xylo.recording_duration, self.process_frame, self.vz, self.timer,
                          num_frames)


def reference_demo(num_frames: int = 4, snr_db: float = 10.0, doa: float = 0.7, device=None) -> Demo:
    """The reference live demo's model (micloc/xylo_snn_localization.py:685-741:
    7 mics, 1600-1900 Hz, a 224-point grid, unipolar spikes, 0.25 s frames,
    a 10 ms STHT kernel) on a synthetic source."""
    num_mic = 7
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=num_mic)
    xd = XyloDemo(geometry=geometry, freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 32 * num_mic),
                  recording_duration=0.25, kernel_duration=10e-3, bipolar_spikes=False, fs=FS, device=device)
    return Demo(xd, source=tone_source(geometry, num_frames, snr_db, doa))


def run_demo(num_frames: int = 4, snr_db: float = 10.0, doa: float = 0.7, device=None) -> list:
    return reference_demo(num_frames, snr_db, doa, device).run(num_frames=num_frames)


if __name__ == "__main__":
    cli(run_demo)
