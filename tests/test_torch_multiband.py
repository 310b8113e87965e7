"""The multiband model of the PyTorch port against the JAX package: the
band-stacked scoring functions, the band-stacked calibration, the
``matched_stacked`` and ``matched_auto`` estimators, ``extract_rate`` and the
writable design cache.

The model is the small one of ``tests/test_xylo.py:443-500``: two bands,
a 17-point grid, 0.1 s frames, a 5 ms STHT kernel, designed in JAX, saved
and ``Demo.load``-ed into the port, so that both packages hold the same
integers.  The scoring functions are float32 on both sides and are held
to 1e-6: their sums run in another order.  The band-stacked tables of the
two packages come from the same integers through encodes that differ in
float rounding (``test_torch_slice.py``: a few spikes in tens of thousands
move), so they are held to 2e-3 per entry of a unit row."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.models.xylo import pipeline as jax_pipeline
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.models.xylo import pipeline
from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import project_input, sim_hidden
from haghighatshoarmuir2024_tpu_torch.utils import cache

FS, G = 48_000, 17
SMALL = dict(freq_bands=[[1600, 1900], [1900, 2200]], doa_list=np.linspace(-np.pi, np.pi, G),
             recording_duration=0.1, kernel_duration=5e-3, bipolar_spikes=True, fs=FS, design_chunk=16)
DOAS = (-2.0, -0.6, 0.5, 1.3, 2.5)
TABLE_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _caches(tmp_path_factory):
    """JAX Demos built without the committed XLA executables; the port's
    design cache in a directory of the test's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        mp.setenv(cache.CACHE_ENV, str(tmp_path_factory.mktemp("torch_cache")))
        yield


def grid_index(doa) -> np.ndarray:
    """DoA → grid index; the grid's two ends (−π and π) are one direction."""
    idx = np.abs(np.asarray(doa, np.float64).reshape(-1)[:, None] - SMALL["doa_list"][None, :]).argmin(axis=1)
    return idx % (G - 1)


def template():
    t = np.arange(0, 0.1, 1 / FS)
    return t, np.sin(2 * np.pi * 1750 * t) + np.sin(2 * np.pi * 2050 * t)


@pytest.fixture(scope="module")
def models(tmp_path_factory, _caches):
    """The JAX model calibrated (band-stacked and folded) and the port's
    ``Demo.load`` of its checkpoint; seeded frames from the DOAS."""
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), use_cache=False, **SMALL)
    t, sig = template()
    jd.calibrate_profiles(template=(t, sig), use_cache=False, band_stacked=True)
    jd.calibrate_profiles(template=(t, sig), use_cache=False)
    path = tmp_path_factory.mktemp("demo") / "multiband.npz"
    jd.save(str(path))
    td = Demo.load(str(path), device="cpu")
    clean = np.stack([np.asarray(signal_from_template(jd.geometry, t, sig, d, fs=FS)) for d in DOAS])
    frames = (clean + 0.1 * np.random.default_rng(3).standard_normal(clean.shape)).astype(np.float32)
    return {"jd": jd, "td": td, "frames": frames, "path": path}


# ------------------------------------------------------------ scoring
@pytest.mark.parametrize("G_", [17, 18])
def test_torch_blockcos_and_cos1_match_jax(G_):
    x = np.random.default_rng(G_).standard_normal((4, 3 * G_)).astype(np.float32) * 50 + 20
    x[1, :G_] = 7.0  # a flat band: the 1e-12 floor of the norm
    np.testing.assert_allclose(pipeline._blockcos(torch.as_tensor(x), G_).numpy(),
                               np.asarray(jax_pipeline._blockcos(jnp.asarray(x), G_)), atol=1e-6)
    np.testing.assert_allclose(pipeline._cos1(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_pipeline._cos1(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("G_", [17, 18])
@pytest.mark.parametrize("weight", ["peak", "peak2", "contrast"])
def test_torch_auto_blend_scores_match_jax(G_, weight):
    """All three weights at odd and even G (the contrast weight's median of
    an even count of scores is the mean of the two middle ones, as in
    ``jnp.median``)."""
    rng = np.random.default_rng(G_ + len(weight))
    rate = (rng.random((5, 3 * G_)) * 400).astype(np.float32)
    prof = rng.standard_normal((G_, 3 * G_)).astype(np.float32)
    got = pipeline._auto_blend_scores(torch.as_tensor(rate), torch.as_tensor(prof), G_, weight).numpy()
    ref = np.asarray(jax_pipeline._auto_blend_scores(jnp.asarray(rate), jnp.asarray(prof), G_, weight))
    assert got.shape == (5, G_)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # one rate vector, as the single-frame estimator takes it
    one = pipeline._auto_blend_scores(torch.as_tensor(rate[0]), torch.as_tensor(prof), G_, weight).numpy()
    np.testing.assert_allclose(one, ref[0], atol=1e-6)


def test_torch_median_matches_jnp_median():
    x = np.random.default_rng(0).standard_normal((3, 4, 18)).astype(np.float32)
    for n in (17, 18):
        np.testing.assert_array_equal(pipeline._median(torch.as_tensor(x[..., :n])).numpy(),
                                      np.asarray(jnp.median(jnp.asarray(x[..., :n]), axis=-1)))
    with pytest.raises(ValueError, match="weight"):
        pipeline._auto_blend_scores(torch.zeros(1, 2 * G), torch.zeros(G, 2 * G), G, "mean")


# ------------------------------------------------------------ the model
def test_torch_band_stacked_calibration_matches_jax(models):
    """The port calibrates the band-stacked table from the JAX model's
    integers: (G, F·G), unit rows of mean 0, within TABLE_TOL of JAX's."""
    jd, td = models["jd"], models["td"]
    t, sig = template()
    got = td.calibrate_profiles(template=(t, sig), use_cache=False, band_stacked=True)
    ref = np.asarray(jd._profiles_stacked)
    assert got.shape == ref.shape == (G, 2 * G)
    np.testing.assert_allclose(got.mean(axis=1), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=TABLE_TOL)
    td._set_profiles_stacked(ref)  # the other tests score against JAX's table


@pytest.mark.parametrize("method", ["matched_stacked", "matched_auto", "matched", "peak"])
def test_torch_multiband_doas_match_jax(models, method):
    """With JAX's tables in the port, every estimator gives JAX's DoAs on
    the seeded frames; the folded (B, G) rate comes back as before."""
    jd, td, frames = models["jd"], models["td"], models["frames"]
    td._set_profiles_stacked(jd._profiles_stacked)
    jdoa, jrate = jd.forward_batch(jnp.asarray(frames), method=method)
    tdoa, trate = td.forward_batch(frames, method=method)
    assert tdoa.shape == (len(DOAS),) and trate.shape == (len(DOAS), G)
    np.testing.assert_array_equal(grid_index(tdoa.numpy()), grid_index(np.asarray(jdoa)))
    np.testing.assert_allclose(trate.numpy(), np.asarray(jrate), rtol=0, atol=0.02 * float(np.max(jrate)))
    if method != "peak":  # within a grid step of the source
        err = np.rad2deg(np.arcsin(np.abs(np.sin(tdoa.numpy() - np.asarray(DOAS)))))
        assert (err <= 360 / (G - 1) + 1e-6).all(), err


def test_torch_extract_rate_unfolded_equals_forward_batch(models):
    """The eager chain — encode, RZCC, the hidden raster of the plain
    simulator, ``extract_rate(fold=False)``, ``estimate_doa_from_rate`` —
    gives ``forward_batch``'s answer (JAX
    ``test_stacked_estimator_eager_chain_matches_batch``)."""
    jd, td, frames = models["jd"], models["td"], models["frames"]
    td._set_profiles_stacked(jd._profiles_stacked)
    kp, kn = td.rzcc(td.encode(frames))
    spikes = torch.cat([kp & ~kn, kn], dim=-1).to(torch.int8)  # (T, B, 2C)
    cfg = td.xylo_config
    raster, _, _ = sim_hidden(project_input(cfg, spikes), cfg.dash_syn, cfg.dash_mem, cfg.threshold)
    rate = td.extract_rate(raster, fold=False)
    assert rate.shape == (len(DOAS), 2 * G)
    folded = td.extract_rate(raster)
    for method in ("matched_stacked", "matched_auto"):
        doa, rate_doa = td.forward_batch(frames, method=method)
        assert torch.equal(td.estimate_doa_from_rate(rate, method), doa)
        torch.testing.assert_close(folded, rate_doa, rtol=1e-6, atol=1e-3)
    # one frame's unfolded rate, as the JAX chain hands it over
    assert td.estimate_doa_from_rate(rate[2], "matched_stacked") == doa[2]


def test_torch_stacked_estimators_raise_value_errors(models):
    jd, frames = models["jd"], models["frames"]
    bare = Demo.load(str(models["path"]), device="cpu")
    bare._profiles_stacked = bare._stacked_t = bare._stacked_cos_t = None
    for method in ("matched_stacked", "matched_auto"):
        with pytest.raises(ValueError, match="band_stacked"):
            bare.forward_batch(frames, method=method)
    td = models["td"]
    td._set_profiles_stacked(jd._profiles_stacked)
    _, folded = td.forward_batch(frames[:1])
    for method in ("matched_stacked", "matched_auto"):
        with pytest.raises(ValueError, match="fold=False"):
            td.estimate_doa_from_rate(folded, method)
    with pytest.raises(ValueError, match="estimation methods"):
        td.estimate_doa_from_rate(folded, "stacked")


def test_torch_streaming_stacked_estimate_equals_rates(models):
    """``StreamingLocalizer.estimate_doa`` scores the unfolded counts for the
    stacked methods and the folded ones otherwise."""
    from haghighatshoarmuir2024_tpu_torch.runtime import StreamingLocalizer

    jd, td, frames = models["jd"], models["td"], models["frames"]
    td._set_profiles_stacked(jd._profiles_stacked)
    sl = StreamingLocalizer(td)
    state = sl.init_state(batch=len(DOAS))
    for k in range(2):
        state = sl.process_chunk(state, frames[:, k * 2400:(k + 1) * 2400], return_spikes=False)
    unfolded = sl.rate(state, fold=False)
    assert unfolded.shape == (len(DOAS), 2 * G)
    for method in ("matched_stacked", "matched_auto"):
        assert torch.equal(sl.estimate_doa(state, method), td.estimate_doa_from_rate(unfolded, method))
    assert torch.equal(sl.estimate_doa(state, "matched"), td.estimate_doa_from_rate(td.fold(unfolded), "matched"))


def test_torch_three_band_template_matches_experiment():
    """The three-band configuration and wideband template of
    ``experiments/multiband_bench.py:41-85``: the port's numpy copy of
    ``experiments/common.jittered_sinusoid_template`` gives the same
    samples at 48 and 24 kHz."""
    import importlib.util

    from haghighatshoarmuir2024_tpu_torch.models.xylo import multiband

    path = Path(__file__).resolve().parent.parent / "experiments" / "common.py"
    spec = importlib.util.spec_from_file_location("experiments_common_for_torch_test", path)
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    for fs in (48_000, 24_000):
        t = np.arange(0, 0.25, 1 / fs)
        ref = np.zeros_like(t)
        for band in multiband.BANDS:
            ref = ref + common.jittered_sinusoid_template(float(np.mean(band)), 0.25, fs=fs, seed=1)[1]
        got_t, got = multiband.wideband_template(fs)
        np.testing.assert_array_equal(got_t, t)
        np.testing.assert_array_equal(got, ref / np.abs(ref).max())
    cfg = multiband.multiband_config("cpu", 24_000)
    assert cfg["freq_bands"] == [[1600.0, 2000.0], [2000.0, 2300.0], [2300.0, 2600.0]]
    assert len(cfg["doa_list"]) == 449 and cfg["enforce_hw_limits"] is False and cfg["fs"] == 24_000


# ------------------------------------------------------------ design cache
def package_files(root: Path) -> dict:
    return {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_torch_design_cache_round_trip_and_order(tmp_path, monkeypatch):
    """A save/load round trip; the user directory wins over the bundled
    file; the default directory is the port's own, never the JAX
    package's."""
    dc = cache.DesignCache(tmp_path / "user")
    arrays = {"bf_0": np.arange(6, dtype=np.float32).reshape(2, 3), "profiles": np.eye(3)}
    dc.save("abc", arrays)
    back = dc.load("abc")
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    assert sorted(p.name for p in (tmp_path / "user").iterdir()) == ["abc.npz"]  # no temporary left
    # the bundled flagship design, then a user file of the same key in front of it
    key = sorted(cache.BUNDLED_DIR.glob("*.npz"))[0].stem
    original = np.load(cache.bundled_path(key)).files
    assert set(dc.load(key)) == set(original) and dc.load("missing") is None
    dc.save(key, {"mine": np.zeros((2, 2), np.float32)})
    assert set(dc.load(key)) == {"mine"}
    assert np.load(cache.bundled_path(key)).files == original  # the bundled file is as it was
    monkeypatch.delenv(cache.CACHE_ENV)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cache.DesignCache().dir == tmp_path / "home" / ".cache" / "hm2024_torch"
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path / "env"))
    assert cache.DesignCache().dir == tmp_path / "env"


def test_torch_demo_design_cache_saves_and_reuses(tmp_path, monkeypatch):
    """``Demo(use_cache=True)`` saves a design it computed and the next one
    loads it; the band-stacked calibration the same; nothing is written
    under the JAX package."""
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
    jax_pkg = Path(jpkg.__file__).resolve().parent
    before = package_files(jax_pkg)
    small = dict(SMALL, freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 9), recording_duration=0.05)
    geo = tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7)
    first = Demo(geometry=geo, **small, device="cpu")
    assert len(list(tmp_path.glob("*.npz"))) == 1
    second = Demo(geometry=geo, **small, device="cpu")
    np.testing.assert_array_equal(second.bf_mats[0], first.bf_mats[0])
    prof = first.calibrate_profiles(band_stacked=True)
    assert len(list(tmp_path.glob("*.npz"))) == 2 and second._profiles_stacked is None
    np.testing.assert_array_equal(second.calibrate_profiles(band_stacked=True), prof)
    assert second._stacked_t is not None
    assert package_files(jax_pkg) == before
