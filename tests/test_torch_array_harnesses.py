"""The port's beam-pattern, multi-target, tracking and robustness harnesses
(``haghighatshoarmuir2024_tpu_torch/experiments/``: array_resolution,
array_resolution_snn, array_resolution_music, multiple_targets,
moving_target, multi_target_tracking, mismatch_robustness) against their
JAX twins in ``experiments/`` on the CPU, on the same numpy inputs, at a
small size.

The JAX twins run as they are where their sizes allow it (their ``main`` or
``run``, under ``jax.enable_x64(False)``, the production float32); where a
twin draws from ``jax.random``, its draws are computed here and handed to
the port.  The Xylo models are JAX's: both packages' design caches point at
one temporary directory, so the port reads the design and table that JAX
wrote there (a design's unit phase is LAPACK's choice in either package).
Tolerances:

- Hilbert and SNN designs within 1e-5 per column up to a unit phase
  (``test_torch_design.py``); the beam patterns of the two packages'
  designs within 2·sqrt(2e-5) ≈ 8.9e-3 absolute, the most that unit
  columns within that tolerance allow (measured: 6.3e-5 Hilbert at 1 kHz,
  8.5e-4 SNN on the linear array); the -3 dB widths equal;
- DoAs and detected peaks equal, grid rows 0 and G-1 one direction; the
  float SNN's detections in ``multiple_targets`` within one grid step
  between the packages' own designs (its response ``mean(out²)`` of a real
  2M-vector moves with the design's unit phase) and equal on one design;
- the trackers' and the scores' floats within 1e-4 degrees (float32
  trackers).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import array_resolution as jax_ar  # noqa: E402
import array_resolution_music as jax_arm  # noqa: E402
import array_resolution_snn as jax_ars  # noqa: E402
import common as jax_common  # noqa: E402
import mismatch_robustness as jax_mm  # noqa: E402
import moving_target as jax_mt  # noqa: E402
import multi_target_tracking as jax_mtt  # noqa: E402
import multiple_targets as jax_mtg  # noqa: E402

import haghighatshoarmuir2024_tpu as jpkg  # noqa: E402
from haghighatshoarmuir2024_tpu.models.snn_beamformer import SNNBeamformer as JaxSNN  # noqa: E402
from haghighatshoarmuir2024_tpu.ops.interp import received_signal as jax_received_signal  # noqa: E402
from haghighatshoarmuir2024_tpu.utils import cache as jax_cache  # noqa: E402

from haghighatshoarmuir2024_tpu_torch.experiments import (array_resolution, array_resolution_music,  # noqa: E402
                                                          array_resolution_snn, mismatch_robustness, moving_target,
                                                          multi_target_tracking, multiple_targets)
from haghighatshoarmuir2024_tpu_torch.experiments.common import beam_pattern, widths  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.utils import cache as torch_cache  # noqa: E402

FS = 48_000
DESIGN_TOL, DEG_TOL = 1e-5, 1e-4
PATTERN_TOL = 2 * np.sqrt(2 * DESIGN_TOL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs small tensor ops in long Python loops (the
    per-sample scans): under the lane's parallel workers, intra-op threads
    only contend for the cores, so this module runs them on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    """No committed XLA executables; JAX's and the port's design caches in
    one temporary directory, so the port finds the designs JAX makes."""
    monkeypatch.setenv("HM2024_JAX_CACHE", "0")
    monkeypatch.setattr(jax_cache, "_DEFAULT_DIR", str(tmp_path))
    monkeypatch.setenv(torch_cache.CACHE_ENV, str(tmp_path))


def quiet(fn, *args, **kwargs):
    """A JAX twin's ``main`` without its printed JSON, in float32."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()), jax.enable_x64(False):
        return fn(*args, **kwargs)


def grid_index(doa, grid) -> np.ndarray:
    idx = np.abs(np.asarray(doa, np.float64).reshape(-1)[:, None] - grid[None, :]).argmin(axis=1)
    return idx % (len(grid) - 1)


def columns_match(got, want, tol=DESIGN_TOL):
    """Complex (or 2M-real, re-folded) design columns equal up to a unit phase."""
    got, want = np.asarray(got), np.asarray(want)
    if not np.iscomplexobj(want):
        m = want.shape[0] // 2
        got, want = got[:m] + 1j * got[m:], want[:m] + 1j * want[m:]
    inner = np.abs(np.sum(np.conj(want) * got, axis=0))
    assert inner.min() >= 1 - tol, inner.min()


def harness_keys(res, name):
    import json

    assert res["experiment"] == name
    json.dumps(res)  # plain JSON types


# ------------------------------------------------------------ beam patterns
@pytest.mark.parametrize("kind", ["sin", "noise"])
def test_torch_array_resolution_matches_jax(kind, capsys):
    """The Hilbert designs at the five design frequencies (17-point grid,
    0.25 s) and the harness's widths equal to JAX's ``main``'s."""
    grid = np.linspace(-np.pi, np.pi, 17)
    want = quiet(jax_ar.main, template_kind=kind, num_grid=17)
    got = array_resolution.run(kind, 17, device="cpu")
    assert got == want
    for f in (1_000.0, 8_000.0):
        port = array_resolution.design(f, kind, grid, device="cpu").numpy()
        with jax.enable_x64(False):
            geo = jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7)
            tpl = (jax_common.sinusoid_template(f, 0.25) if kind == "sin"
                   else jax_common.bandlimited_noise_template((0.5 * f, f), 0.25))
            jbf = jpkg.models.beamformer.Beamformer(geo, 10e-3, (0.5 * f, f), fs=FS)
            ref = np.asarray(jbf.design_from_template(tpl, grid)[0])
        columns_match(port, ref)
        np.testing.assert_allclose(beam_pattern(torch.as_tensor(port)), jax_common.beam_pattern(ref), rtol=0,
                                   atol=PATTERN_TOL)
    res = array_resolution.main(["--quick", "--device", "cpu", "--template", kind])
    harness_keys(res, f"array_resolution_{kind}")
    assert sorted(res["results"]) == sorted(want)


@pytest.mark.parametrize("kind", ["circular", "linear", "random"])
def test_torch_array_resolution_snn_matches_jax(kind):
    """The geometries and grids of ``build_geometry``, and the bipolar SNN
    designs on jittered templates (17-point grid, 0.05 s) per column, their
    re-folded patterns and widths, against JAX's."""
    geo, grid = array_resolution_snn.build_geometry(kind, 17)
    jgeo, jgrid = jax_ars.build_geometry(kind)
    np.testing.assert_array_equal(geo.r_vec, jgeo.r_vec)
    np.testing.assert_array_equal(geo.theta_vec, jgeo.theta_vec)
    np.testing.assert_array_equal(array_resolution_snn.build_geometry(kind)[1], jgrid)
    f = 2_000.0
    port = array_resolution_snn.design(geo, grid, f, duration=0.05, device="cpu").numpy()
    tau = 1.0 / (2 * np.pi * 1500.0)
    with jax.enable_x64(False):
        snn = JaxSNN(jgeo, 10e-3, (0.5 * f, f), [tau, tau], bipolar_spikes=True, fs=FS)
        ref = np.asarray(snn.design_from_template(jax_common.jittered_sinusoid_template(1500.0, 0.05), grid))
    columns_match(port, ref)
    pat, want = beam_pattern(torch.as_tensor(port), complex_fold=True), jax_common.beam_pattern(ref, complex_fold=True)
    np.testing.assert_allclose(pat, want, rtol=0, atol=PATTERN_TOL)
    wj = [jax_common.beamwidth_3db(r, grid) for r in want]
    assert widths(pat, grid) == {"beamwidth_3db_deg_mean": float(np.mean(wj)), "beamwidth_3db_deg_max": float(max(wj))}


def test_torch_array_resolution_snn_main_prints_jax_keys():
    res = array_resolution_snn.main(["--quick", "--device", "cpu", "--geometry", "linear"])
    harness_keys(res, "array_resolution_snn_linear")
    assert sorted(res["results"]) == ["1000Hz", "2000Hz", "4000Hz"]
    assert all(sorted(v) == ["beamwidth_3db_deg_max", "beamwidth_3db_deg_mean"] for v in res["results"].values())


@pytest.mark.parametrize("kind", ["circular", "linear"])
def test_torch_array_resolution_music_matches_jax(kind):
    """The spectra without noise (JAX draws its 20 dB noise from
    ``PRNGKey(0)``, the port from a generator): JAX's ``main`` at
    ``snr_db=None`` on its 112-point grid, 0.25 s, equal results."""
    want = quiet(jax_arm.main, kind=kind, snr_db=None)
    got = array_resolution_music.run(kind, snr_db=None, device="cpu")
    assert sorted(got) == sorted(want)
    for f, entry in want.items():
        assert sorted(got[f]) == sorted(entry)
        for name, e in entry.items():
            assert got[f][name]["beamwidth_3db_deg"] == e["beamwidth_3db_deg"]
            assert got[f][name]["peak_err_deg"] == pytest.approx(e["peak_err_deg"], abs=DEG_TOL)
    noisy = array_resolution_music.main(["--quick", "--device", "cpu", "--geometry", kind])
    harness_keys(noisy, f"array_resolution_music_{kind}")
    assert all(sorted(v) == sorted(want["2000Hz"]) for v in noisy["results"].values())


# ------------------------------------------------------------ multiple targets
def jax_multiple_targets(geometry, num_grid: int, duration: float, snr_db: float = 20.0) -> dict:
    """JAX ``multiple_targets.main``'s body (``experiments/multiple_targets.py:
    59-107``) at a given grid and frame (the twin fixes 224 points, 0.25 s)."""
    from haghighatshoarmuir2024_tpu.models.beamformer import Beamformer
    from haghighatshoarmuir2024_tpu.models.music import MUSIC

    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    targets = np.array([-np.pi / 3, np.pi / 3])
    band = (1000.0, 2000.0)
    t, sig1 = jax_common.sinusoid_template(1500.0, duration)
    _, sig2 = jax_common.sinusoid_template(1600.0, duration)
    rng = np.random.default_rng(0)
    sig_in = jax_mtg.signal_multiple_targets(geometry, t, [sig1, sig2], targets)
    sig_in = sig_in + np.sqrt(np.mean(sig_in**2) / 10 ** (snr_db / 10)) * rng.standard_normal(sig_in.shape)
    deg = lambda prof: np.rad2deg(jax_mtg.detect_peaks(np.asarray(prof), doa_list)).tolist()  # noqa: E731
    out = {}
    for ir in (False, True):
        bf = Beamformer(geometry, 10e-3, band, fs=FS)
        bf_mat, _ = bf.design_from_template((t, sig1), doa_list, interference_removal=ir)
        out[f"hilbert{'_ir' if ir else ''}"] = deg(jnp.mean(jnp.abs(bf.apply_to_signal(bf_mat, sig_in)) ** 2, axis=0))
    sig_in_m = jax_mtg.signal_multiple_targets(geometry, t, [sig1, sig2], targets, delay_sign=-1)
    sig_in_m = sig_in_m + np.sqrt(np.mean(sig_in_m**2) / 10 ** (snr_db / 10)) * rng.standard_normal(sig_in_m.shape)
    music = MUSIC(geometry, band, doa_list, frame_duration=duration, fs=FS)
    out["music"] = deg(music.beamforming(jnp.asarray(sig_in_m), 2, 2048))
    out["music_ns2"] = deg(music.beamforming(jnp.asarray(sig_in_m), 2, 2048, num_sources=2))
    tau = 1.0 / (2 * np.pi * 1500.0)
    snn = JaxSNN(geometry, 10e-3, band, [tau, tau], bipolar_spikes=True, fs=FS)
    bf_snn = np.asarray(snn.design_from_template((t, sig1), doa_list))
    prof_snn = np.mean(np.asarray(snn.apply_to_signal(bf_snn, (t, sig_in))) ** 2, axis=0)
    out["snn"] = deg(prof_snn)
    return {"detected": out, "sig_in": sig_in, "t": t, "bf_snn": bf_snn, "prof_snn": prof_snn, "grid": doa_list}


def test_torch_multiple_targets_matches_jax():
    """``signal_multiple_targets`` and the numpy noise within 1e-12; every
    method's two detections (``main --quick``: 33-point grid, 0.05 s) equal
    to JAX's, the SNN's within a grid step and equal on one design."""
    geo, jgeo = multiple_targets.CenterCircularArray(4.5e-2, 7), jpkg.CenterCircularArray(4.5e-2, 7)
    t, s1 = jax_common.sinusoid_template(1500.0, 0.25)
    _, s2 = jax_common.sinusoid_template(1600.0, 0.25)
    for sign in (1, -1):
        np.testing.assert_allclose(
            multiple_targets.signal_multiple_targets(geo, t, [s1, s2], multiple_targets.TARGETS, delay_sign=sign),
            jax_mtg.signal_multiple_targets(jgeo, t, [s1, s2], multiple_targets.TARGETS, delay_sign=sign),
            rtol=0, atol=1e-12)
    with jax.enable_x64(False):
        ref = jax_multiple_targets(jgeo, 33, 0.05)
    main = multiple_targets.main(["--quick", "--device", "cpu"])  # 33 points, 0.05 s
    harness_keys(main, "multiple_targets")
    got = main["results"]
    grid = ref["grid"]
    assert sorted(got) == sorted(ref["detected"]) + ["targets_deg"]
    assert got["targets_deg"] == pytest.approx(np.rad2deg(multiple_targets.TARGETS).tolist(), abs=1e-12)
    for k, v in ref["detected"].items():
        step = grid_index(np.deg2rad(got[k]["detected_deg"]), grid) - grid_index(np.deg2rad(v), grid)
        assert np.abs(step).max() <= (1 if k == "snn" else 0), (k, got[k], v)
    # the SNN row on one design (JAX's): the port's response and peaks = JAX's
    tau = 1.0 / (2 * np.pi * 1500.0)
    ts = multiple_targets.SNNBeamformer(geo, 10e-3, multiple_targets.FREQ_RANGE, [tau, tau], bipolar_spikes=True,
                                        fs=FS, device="cpu")
    prof = (ts.apply_to_signal(ref["bf_snn"], (ref["t"], ref["sig_in"])) ** 2).mean(dim=0).numpy()
    np.testing.assert_allclose(prof, ref["prof_snn"], rtol=0, atol=5e-4 * ref["prof_snn"].max())
    np.testing.assert_array_equal(multiple_targets.detect_peaks(prof, grid), jax_mtg.detect_peaks(ref["prof_snn"], grid))


def test_torch_detect_peaks_matches_jax():
    rng = np.random.default_rng(4)
    grid = np.linspace(-np.pi, np.pi, 224)
    for _ in range(2):
        prof = np.convolve(rng.random(224), np.ones(9) / 9, mode="same")
        np.testing.assert_array_equal(multiple_targets.detect_peaks(prof, grid), jax_mtg.detect_peaks(prof, grid))


# ------------------------------------------------------------ tracking
def test_torch_moving_target_matches_jax():
    """JAX's ``main`` at 0.4 s of 0.05 s frames (224-point grid; its Xylo
    model designed by JAX into the shared cache): the port's ``run`` on
    JAX's array signal (``received_signal`` with ``PRNGKey(0)``) gives the
    same four rows."""
    duration, frame, snr = 0.4, 0.05, 10.0
    want = quiet(jax_mt.main, duration=duration, snr_db=snr, frame=frame)
    t = np.arange(0, duration, 1 / FS)
    traj = -np.pi / 3 + (2 * np.pi / 3) * (t / t[-1])
    with jax.enable_x64(False):
        sig_in = np.asarray(jax_received_signal(jpkg.CenterCircularArray(4.5e-2, 7), jnp.asarray(t),
                                                jnp.asarray(np.sin(2 * np.pi * 1500.0 * t)), jnp.asarray(traj),
                                                snr_db=snr, key=jax.random.PRNGKey(0), fs=FS))
    got = moving_target.run(duration, snr, frame, device="cpu", sig_in=sig_in)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        for m, x in v.items():
            assert got[k][m] == pytest.approx(x, abs=DEG_TOL), (k, m)


def test_torch_moving_target_scene_and_main():
    """The port's own scene: the generator's noise at the SNR, the frame
    centres' DoAs; ``main --quick`` prints JAX's keys."""
    sig, doa_true = moving_target.scene(0.2, 10.0, 0.05, device="cpu")
    clean, _ = moving_target.scene(0.2, None, 0.05, device="cpu")
    assert sig.shape == (9600, 7) and doa_true.shape == (4,)
    snr = float((clean**2).mean() / ((sig - clean) ** 2).mean())
    assert abs(10 * np.log10(snr) - 10.0) < 0.5
    np.testing.assert_allclose(doa_true, -np.pi / 3 + (2 * np.pi / 3) * (np.arange(4) + 0.5) * 0.05 * FS / 9599,
                               rtol=0, atol=1e-12)
    res = moving_target.main(["--quick", "--device", "cpu"])
    harness_keys(res, "moving_target")
    assert sorted(res["results"]) == ["hilbert", "hilbert_tracked", "xylo", "xylo_tracked"]


def test_torch_multi_target_tracking_matches_jax():
    """JAX's ``main`` at 1.2 s of 0.1 s frames (224-point grid; numpy noise,
    so both packages synthesize the same mixture): equal results."""
    want = quiet(jax_mtt.main, duration=1.2, snr_db=10.0, frame=0.1)
    got = multi_target_tracking.run(1.2, 10.0, 0.1, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, list):
            assert got[k] == pytest.approx(v, abs=DEG_TOL), k
        else:
            assert got[k] == v, k
    harness_keys(multi_target_tracking.main(["--quick", "--device", "cpu"]), "multi_target_tracking")


# ------------------------------------------------------------ robustness
def test_torch_mismatch_robustness_matches_jax():
    """JAX's ``run`` (2 trials, 17-point grid, 0.05 s; its Xylo model and
    table in the shared cache) and the port's on JAX's noise
    (``normal(split(PRNGKey(0), 2)[i], (T, M))``): equal rows."""
    n, grid, dur = 2, 17, 0.05
    want = quiet(jax_mm.run, num_trials=n, num_grid=grid, duration=dur)
    T = int(round(dur * FS))
    with jax.enable_x64(False):
        noise = np.stack([np.asarray(jax.random.normal(k, (T, 7))) for k in jax.random.split(jax.random.PRNGKey(0), n)])
    got = mismatch_robustness.run(n, grid, duration=dur, device="cpu", noise=noise)
    assert got == want
    geo = mismatch_robustness.CenterCircularArray(4.5e-2, 7)
    a = mismatch_robustness._perturbed_geometry(geo, np.random.default_rng(1), 2e-3)
    b = jax_mm._perturbed_geometry(jpkg.CenterCircularArray(4.5e-2, 7), np.random.default_rng(1), 2e-3)
    np.testing.assert_array_equal(a.r_vec, b.r_vec)
    np.testing.assert_array_equal(a.theta_vec, b.theta_vec)
    harness_keys(mismatch_robustness.main(["--quick", "--device", "cpu", "--trials", "2"]), "mismatch_robustness")


def _main(argv) -> None:
    """``python tests/test_torch_array_harnesses.py --full NAME``: a JAX twin at
    its full size on the CPU, then the port on JAX's inputs (its array
    signal or noise, JAX's Xylo design through the shared cache) and, for
    moving_target, also on its own design; one JSON line each.  NAME:
    moving_target (4 s of 0.25 s frames, 224-point grid, 10 dB,
    ``PRNGKey(0)``), multi_target_tracking (6 s, 224 points),
    mismatch_robustness (20 trials, 112 points, 0.25 s) or multiple_targets
    (224 points, 0.25 s, 20 dB; numpy noise, the same mixtures in both)."""
    import argparse
    import contextlib
    import io
    import json
    import os
    import tempfile

    ap = argparse.ArgumentParser(description="a harness at full size through both packages")
    ap.add_argument("--full", choices=("moving_target", "multi_target_tracking", "mismatch_robustness",
                                       "multiple_targets"),
                    action="append", default=[])
    names = ap.parse_args(argv).full
    show = lambda **kw: print(json.dumps(kw), flush=True)  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HM2024_JAX_CACHE"] = "0"
        os.environ[torch_cache.CACHE_ENV] = tmp
        jax_cache._DEFAULT_DIR = tmp
        for name in names:
            if name == "multiple_targets":  # JAX's main draws a figure: its body, without the figure
                show(harness=name, package="jax",
                     results=jax_multiple_targets(jpkg.CenterCircularArray(4.5e-2, 7), 32 * 7, 0.25)["detected"])
                show(harness=name, package="port", results=multiple_targets.run(device="cpu"))
                continue
            with contextlib.redirect_stdout(io.StringIO()):
                want = {"moving_target": jax_mt.main, "multi_target_tracking": jax_mtt.main,
                        "mismatch_robustness": jax_mm.run}[name]()
            show(harness=name, package="jax", results=want)
            if name == "multi_target_tracking":  # numpy noise: the same mixture in both
                show(harness=name, package="port", results=multi_target_tracking.run(device="cpu"))
            elif name == "mismatch_robustness":
                T = int(0.25 * FS)
                noise = np.stack([np.asarray(jax.random.normal(k, (T, 7)))
                                  for k in jax.random.split(jax.random.PRNGKey(0), 20)])
                show(harness=name, package="port", noise="JAX's",
                     results=mismatch_robustness.run(device="cpu", noise=noise))
            else:
                t = np.arange(0, 4.0, 1 / FS)
                traj = -np.pi / 3 + (2 * np.pi / 3) * (t / t[-1])
                sig_in = np.asarray(jax_received_signal(
                    jpkg.CenterCircularArray(4.5e-2, 7), jnp.asarray(t), jnp.asarray(np.sin(2 * np.pi * 1500.0 * t)),
                    jnp.asarray(traj), snr_db=10.0, key=jax.random.PRNGKey(0), fs=FS))
                show(harness=name, package="port", design="JAX's", signal="JAX's",
                     results=moving_target.run(device="cpu", sig_in=sig_in))
                own = moving_target.Demo(
                    geometry=moving_target.CenterCircularArray(4.5e-2, 7), freq_bands=[[1000.0, 2000.0]],
                    doa_list=np.linspace(-np.pi, np.pi, 224), recording_duration=0.25, kernel_duration=10e-3,
                    bipolar_spikes=True, fs=FS, device="cpu", use_cache=False)
                show(harness=name, package="port", design="its own", signal="JAX's",
                     results=moving_target.run(device="cpu", sig_in=sig_in, demo=own))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _main(sys.argv[1:])
