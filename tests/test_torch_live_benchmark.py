"""The reverberant room and the paper's live-style benchmark of the port
(``ops/interp.room_image_paths`` and ``signal_from_template_multipath``;
``experiments/{snn_localization_benchmark,analyse_array_localization,
reverb_robustness}.py``) against the JAX package and its twins in
``experiments/`` on the CPU, on the same inputs, at a small size (a
17-point grid, 0.05-0.1 s frames, 2-4 trials or frames).

The JAX twins draw with ``jax.random``; the test recreates their keys' splits
and hands the arrays to the port's ``noise=``/``gain_noise=``.  The Xylo
models are JAX's (both packages' design caches in one temporary directory).
The benchmark twin's frame is fixed at 0.4 s; the test shortens its chirp
to the model's frame by patching the twin module's ``chirp_template``.
Tolerances:

- ``room_image_paths``: equal to JAX's (float64 numpy on both sides);
- ``signal_from_template_multipath`` in float64: within 1e-12 of the row
  peak of JAX's (x64); in float32, batched and single: within
  2·T·6e-8·2π·f/fs of the row peak of JAX's float32, 6.6e-5 at T = 2400
  and f = 1750 Hz (a float32 query time rounds to t·6e-8 s, so one
  last-bit difference of a delay moves a sample's interpolation index by up
  to T·6e-8 samples, and a tone of f Hz changes by at most 2π·f/fs of its
  peak a sample; the factor 2 covers the paths' sum; measured 1.1e-5);
- DoAs equal, grid rows 0 and G-1 one direction; analyses and MAEs equal.
"""
import contextlib
import functools
import io
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import analyse_array_localization as jax_analyse  # noqa: E402
import common as jax_common  # noqa: E402
import reverb_robustness as jax_reverb  # noqa: E402
import snn_localization_benchmark as jax_bench  # noqa: E402

import haghighatshoarmuir2024_tpu as jpkg  # noqa: E402
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo  # noqa: E402
from haghighatshoarmuir2024_tpu.ops import interp as jax_interp  # noqa: E402
from haghighatshoarmuir2024_tpu.utils import cache as jax_cache  # noqa: E402

import haghighatshoarmuir2024_tpu_torch as tpkg  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import analyse_array_localization, reverb_robustness  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import snn_localization_benchmark as bench  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments.mismatch_robustness import build  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.ops import interp  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.utils import cache as torch_cache  # noqa: E402

FS, G, FRAME = 48_000, 17, 0.1
GRID = np.linspace(-np.pi, np.pi, G)
GEO = dict(radius=4.5e-2, num_mic=7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _caches(tmp_path_factory):
    """No committed XLA executables; JAX's and the port's design caches in
    one temporary directory, so the port finds the designs JAX makes."""
    d = str(tmp_path_factory.mktemp("designs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        mp.setattr(jax_cache, "_DEFAULT_DIR", d)
        mp.setenv(torch_cache.CACHE_ENV, d)
        yield d


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()), \
            jax.enable_x64(False):
        return fn(*args, **kwargs)


def grid_index(doa_deg) -> np.ndarray:
    idx = np.abs(np.deg2rad(np.asarray(doa_deg, np.float64))[:, None] - GRID[None, :]).argmin(axis=1)
    return idx % (G - 1)


# ------------------------------------------------------------ the room
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("source", [(3.1, 2.9), (0.4, 3.7), (4.6, 0.35)])
def test_torch_room_image_paths_equal_jax(order, source):
    for refl in (0.0, 0.5, 0.9):
        got = interp.room_image_paths(source, (2.2, 1.7), (5.0, 4.0), reflection=refl, order=order)
        want = jax_interp.room_image_paths(source, (2.2, 1.7), (5.0, 4.0), reflection=refl, order=order)
        assert len(got[0]) == (5 if order == 1 else 13)
        for g, w in zip(got, want):
            assert g.dtype == np.float64
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        interp.room_image_paths((5.5, 1.0), (2.2, 1.7), (5.0, 4.0))


def path_batch(n, refl=0.7):
    rng = np.random.default_rng(3)
    pos = reverb_robustness.sample_positions(rng, n)
    return reverb_robustness.path_tables(pos, refl)


def test_torch_multipath_float64_equals_jax():
    """In float64 the multipath sum is JAX's arithmetic: within 1e-12 of the
    row peak, for one source and for each trial of a batch."""
    t = np.arange(0, 0.05, 1 / FS)
    sig = np.sin(2 * np.pi * 1750.0 * t)
    doas, extra, gains = path_batch(3)
    geo, tgeo = jpkg.CenterCircularArray(**GEO), tpkg.CenterCircularArray(**GEO)
    got = interp.signal_from_template_multipath(tgeo, torch.as_tensor(t), torch.as_tensor(sig), doas, extra, gains,
                                                fs=FS).numpy()
    assert got.shape == (3, len(t), 7)
    for b in range(3):
        want = np.asarray(jax_interp.signal_from_template_multipath(geo, t, sig, doas[b], extra[b], gains[b], fs=FS))
        one = interp.signal_from_template_multipath(tgeo, torch.as_tensor(t), torch.as_tensor(sig), doas[b],
                                                    extra[b], gains[b], fs=FS).numpy()
        assert one.shape == want.shape
        for x in (got[b], one):
            assert np.abs(x - want).max() <= 1e-12 * np.abs(want).max()


def test_torch_multipath_float32_matches_jax():
    """In float32, batched and single, within 2·T·6e-8·2π·f/fs of the row
    peak of JAX's float32 (module docstring)."""
    t = np.arange(0, 0.05, 1 / FS)
    sig = np.sin(2 * np.pi * 1750.0 * t)
    tol = 2 * len(t) * 6e-8 * 2 * np.pi * 1750.0 / FS
    doas, extra, gains = path_batch(4)
    geo, tgeo = jpkg.CenterCircularArray(**GEO), tpkg.CenterCircularArray(**GEO)
    f32 = dict(dtype=torch.float32)
    tt, ss = torch.as_tensor(t, **f32), torch.as_tensor(sig, **f32)
    got = interp.signal_from_template_multipath(tgeo, tt, ss, doas, extra, gains, fs=FS).numpy()
    with jax.enable_x64(False):
        for b in range(4):
            want = np.asarray(jax_interp.signal_from_template_multipath(geo, t, sig, doas[b], extra[b], gains[b],
                                                                        fs=FS))
            one = interp.signal_from_template_multipath(tgeo, tt, ss, doas[b], extra[b], gains[b], fs=FS).numpy()
            assert want.dtype == got.dtype == np.float32
            np.testing.assert_array_equal(one, got[b])  # a batch's row = the trial alone
            assert np.abs(got[b] - want).max() <= tol * np.abs(want).max()


# ------------------------------------------------------------ the live benchmark
@pytest.fixture(scope="module")
def bench_models(_caches):
    """The benchmark's model at 0.1 s frames and 17 points, JAX's and the
    port's on JAX's design."""
    cfg = dict(freq_bands=[[1600, 2000]], doa_list=GRID, recording_duration=FRAME, kernel_duration=20e-3,
               bipolar_spikes=True, fs=FS)
    with jax.enable_x64(False):
        jd = JaxDemo(geometry=jpkg.CenterCircularArray(**GEO), **cfg)
    td = bench.make_demo((1600, 2000), G, FRAME, device="cpu")
    np.testing.assert_array_equal(td.bf_mats[0], np.asarray(jd.bf_mats[0]))
    return jd, td


@pytest.fixture
def short_chirp(monkeypatch):
    """The JAX twin's chirp at the model's frame (its own is fixed at 0.4 s)."""
    monkeypatch.setattr(jax_bench, "chirp_template", lambda band, dur, fs=FS: jax_common.chirp_template(band, FRAME))


def jax_draws(n_batches, batch):
    """JAX ``collect``'s keys (``snn_localization_benchmark.py:159-172``):
    each batch's white noise and gain draws."""
    T = int(round(FRAME * FS))
    key, white, gain = jax.random.PRNGKey(0), [], []
    with jax.enable_x64(False):
        for _ in range(n_batches):
            key, sub = jax.random.split(key)
            kn, kg = jax.random.split(sub)
            white.append(np.asarray(jax.random.normal(kn, (batch, T, 7))))
            gain.append(np.asarray(jax.random.normal(kg, (batch, 1, 7))))
    return np.stack(white), np.stack(gain)


@pytest.mark.parametrize("cond", [
    dict(gain_std_db=2.0, snr_db=-5.0),
    dict(sway_deg=4.0, sway_corr=0.96),
    dict(reflection=0.5),
], ids=["gain", "ar1-sway", "reflection"])
def test_torch_collect_on_jax_draws(cond, bench_models, short_chirp):
    """``collect`` on JAX's draws gives JAX's DoAs, sample by sample."""
    jd, td = bench_models
    n, batch = 6, 4  # two batches, the second padded
    want, _ = quiet(jax_bench.collect, num_samples=n, demo=jd, batch=batch, **cond)
    white, gain = jax_draws(2, batch)
    got, _ = bench.collect(num_samples=n, demo=td, batch=batch, noise=white, gain_noise=gain, **cond)
    assert got.shape == want.shape == (n,)
    np.testing.assert_array_equal(grid_index(got), grid_index(want))
    with pytest.raises(ValueError):
        bench.collect(num_samples=n, demo=td, sway_deg=1.0, reflection=0.3)


def test_torch_sweep_on_jax_draws(bench_models, short_chirp, monkeypatch):
    """The six-condition sweep on JAX's draws: JAX's rows."""
    jd, td = bench_models
    n = 4
    monkeypatch.setattr(jax_bench, "_make_demo", lambda band: jd)
    monkeypatch.setattr(jax_bench, "collect", functools.partial(jax_bench.collect, batch=n))  # one batch, unpadded
    want = quiet(jax_bench.sweep, num_samples=n)
    white, _ = jax_draws(1, n)
    got = bench.sweep(n, demo=td, noise=white, batch=n)
    assert got == want


def test_torch_analyse_files_collect_writes(bench_models, short_chirp, tmp_path, monkeypatch):
    """``run`` saves its samples under ``$HM2024_BENCH_DIR``; the port's
    analysis of that directory equals JAX's ``main``'s, and the run's
    statistics equal JAX's analysis of the same samples."""
    _, td = bench_models
    monkeypatch.setenv("HM2024_BENCH_DIR", str(tmp_path))
    report = bench.run(30, demo=td)
    files = list(tmp_path.glob("*.txt"))
    assert [str(f) for f in files] == [report["collected"]["file"]]
    samples = np.loadtxt(files[0])
    assert len(samples) == 30
    from haghighatshoarmuir2024_tpu.utils.stats import analyze_doa_samples as jax_analyze

    want = jax_analyze(samples, window_length=15, reject_jump=20.0)
    assert {k: report["collected"][k] for k in want} == {k: round(v, 4) for k, v in want.items()}
    got = analyse_array_localization.analyse([str(tmp_path)])
    assert got == quiet(jax_analyse.main, extra_dirs=[str(tmp_path)])
    assert list(got) == [tmp_path.name]


# ------------------------------------------------------------ reverb_robustness
def test_torch_reverb_robustness_on_jax_draws():
    """JAX's ``run`` (2 trials, 0.05 s, 17 points) and the port's on JAX's
    noise (``split(PRNGKey(0), 2)``) and JAX's Xylo design: equal rows."""
    n, dur = 2, 0.05
    want = quiet(jax_reverb.run, num_trials=n, num_grid=G, duration=dur)
    T = int(round(dur * FS))
    with jax.enable_x64(False):
        noise = np.stack([np.asarray(jax.random.normal(k, (T, 7))) for k in jax.random.split(jax.random.PRNGKey(0), n)])
    got = reverb_robustness.run(n, G, duration=dur, noise=noise, model=build(G, dur, device="cpu"))
    assert got == want
