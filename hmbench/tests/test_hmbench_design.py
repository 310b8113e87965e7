"""The configurations' design inputs come from the benchmark's plain design
(``hmbench/reference/design.py``): it agrees with the port's design up to
each column's unit phase, and the frozen ``.npz`` files hold what it makes."""
import json

import numpy as np
import pytest
import torch

from hmbench.reference import design as D

CONFIGS = D.CONFIG_DIR


def _spec(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _phase_gap(a: np.ndarray, b: np.ndarray) -> float:
    """The largest entry of a − b, (2M, G) real stacks of complex columns,
    after b's unit phase is brought to a's column by column."""
    M = a.shape[0] // 2
    ua, ub = a[:M] + 1j * a[M:], b[:M] + 1j * b[M:]
    ph = np.sum(np.conj(ub) * ua, axis=0)
    return float(np.abs(ub * (ph / np.abs(ph)) - ua).max())


@pytest.mark.parametrize("name, band", [("flagship_1band_48k", 0), ("threeband_48k", 2)])
def test_plain_design_is_the_ports_up_to_phase(name, band):
    from haghighatshoarmuir2024_tpu_torch.geometry import CenterCircularArray
    from haghighatshoarmuir2024_tpu_torch.models.snn_beamformer import SNNBeamformer

    m = _spec(name)["model"]
    lo, hi = m["freq_bands"][band]
    grid = np.linspace(-np.pi, np.pi, 449)[::56]
    a = m["array"]
    geo = CenterCircularArray(radius=a["radius_m"], num_mic=a["num_mic"], speed=a["speed_m_s"])
    tau = 1 / (2 * np.pi * (lo + hi) / 2)
    bf = SNNBeamformer(geo, m["kernel_duration_s"], [lo, hi], [tau, tau], bipolar_spikes=True, fs=m["fs"],
                       device="cpu")
    t = np.arange(0, m["frame_s"], 1 / m["fs"])
    port = bf.design_from_template((t, np.sin(2 * np.pi * (lo + hi) / 2 * t)), grid).numpy()
    # the port designs in float32: its covariances, and so its eigenvectors, round at about 1e-4
    assert _phase_gap(D.band_design(_spec(name), [lo, hi], grid), port) < 2e-3


@pytest.mark.parametrize("name", ["flagship_1band_48k", "threeband_48k"])
def test_frozen_inputs_are_the_plain_design(name):
    spec = _spec(name)
    m = spec["model"]
    with np.load(CONFIGS / spec["design_inputs"]) as z:
        frozen = {k: z[k] for k in z.files}
    cols = [0, 150, 448]
    grid = np.linspace(-np.pi, np.pi, int(m["grid_points"]))
    for i, band in enumerate(m["freq_bands"]):
        assert _phase_gap(D.band_design(spec, band, grid[cols]), frozen[f"bf_{i}"][:, cols].astype(np.float64)) < 1e-5
    n = int(round(m["fs"] * m["frame_s"]))
    if spec["calibration"] != "default":
        assert np.array_equal(D.calibration_signal(spec, n), frozen["template"])
    # one row of the profiles, worked out again from the frozen design
    bf = {k: v for k, v in frozen.items() if k.startswith("bf_")}
    row = 300
    p = D.profiles(spec, bf, torch.device("cpu"), rows=[row])
    assert np.abs(p[0] - frozen["profiles"][row]).max() < 1e-6
