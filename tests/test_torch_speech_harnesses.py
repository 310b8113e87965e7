"""The port's speech-target Xylo harness (``experiments/target_xylo_localization.py``
``run_speech`` and ``--speech``) against its JAX twin on the CPU, at the JAX
package's own test size (``tests/test_experiment_speech.py:22``: 2 trials,
a 28-point grid, 0.2 s trials, the model designed with a 1.0 s tone),
bipolar and unipolar, on the synthetic speech fallback (the LibriSpeech
sample is not in the repository).

Both packages' design caches point at one temporary directory, so the port
runs JAX's design and its three calibration tables (a design's unit phase is
each LAPACK's choice); the port's own tables from JAX's design are held
against JAX's within ``TABLE_TOL`` (``test_torch_multiband.py``'s).  The JAX
twin runs in float32 (``jax.enable_x64(False)``), as its CLI does, on its
speech template as its own tests compute it, under x64 (``x64_speech_template``).

- Stage A on the same numpy noise (``default_rng(seed)``): each SNR's three
  DoA errors equal, ``sidelobe_db`` within ``SIDELOBE_TOL`` dB;
- stages B and C on JAX's own draws (``jax.random`` keys of the seed and of
  seed + 1) replayed through ``draws=``/``robust_draws=``: every trial's
  DoA grid index equal for every estimator, but for at most ``APART_MAX``
  near ties, each shown to be one (``near_tie``; the replay of the tone
  sweep in ``test_torch_accuracy_harnesses.py`` put 3-4 of 1100 trials a
  step apart at full size);
- the printed JSON has JAX's keys.

``python tests/test_torch_speech_harnesses.py --jax-gates JOB SEED...`` prints what the JAX
harnesses give at the card's sizes (the gates of ``chip_smoke.py`` phase 24):

    JAX_PLATFORMS=cpu HM2024_JAX_CACHE=0 python tests/test_torch_speech_harnesses.py --jax-gates \\
        speech|speech_uni|multiband|cross_segment 0 1
    JAX_PLATFORMS=cpu HM2024_JAX_CACHE=0 python tests/test_torch_speech_harnesses.py --jax-gates ordering|stht

One JSON line a seed: the results and, for the Monte-Carlo jobs, each
column's per-trial standard deviation of the errors at each SNR; then the
seeds' pooled deviation.  The harnesses draw their own trials
(``jax.random`` keys from ``SEED``); the ordering harness and stage A draw
with numpy.
"""
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "experiments"))
import multiband_speech as jax_mb  # noqa: E402
import short_hilbert_transform as jax_stht  # noqa: E402
import target_xylo_localization as jax_xylo  # noqa: E402

from haghighatshoarmuir2024_tpu import parallel as jax_parallel  # noqa: E402
from haghighatshoarmuir2024_tpu.utils import cache as jax_cache  # noqa: E402

from haghighatshoarmuir2024_tpu_torch.experiments import multiband_speech as port_mb  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import target_xylo_localization as xylo  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments.common import speech_template  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.parallel import montecarlo  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.utils import cache as torch_cache  # noqa: E402

FS = 48_000
SIZE = dict(num_sims=2, num_grid=28, duration=0.2)
JAX_BATCH = 2  # JAX's test's batch_size; the port's SPEECH_BATCH (20) also gives one batch of the 2 trials
TABLE_TOL = 2e-3  # test_torch_multiband.py's: the same model and template, the profiles of two float encodes
# The synthetic speech opens below the float32 rounding floor: over its first ONSET samples the integrated signal
# stays under 2e-5 of its peak, and there the port's blocked encode (JAX's TPU form, its error absolute to the
# block) and JAX's CPU scan (relative to each sample) decide 0.7 % of the calibration frames' spikes otherwise.
# Past the onset the rasters differ in a few suppression near ties (two candidates of nearly one height within the
# distance; measured 12 of 7.5e6 entries bipolar, 10 of 3.7e6 unipolar).  The onset's spikes move the speech table
# by up to 0.0125 (bipolar) and 0.022 (unipolar) of its unit rows, measured
ONSET = 64
RASTER_APART = 1e-5
SPEECH_TABLE_TOL = 0.03
# DoAs of the 138 a run scores (23 SNR rows x 2 trials x 3 estimators) that may differ from JAX's harness's: near
# ties, where float rounding moves a spike or two (5 Hz each at 0.2 s) in one or two of the 28 rates.  Two roundings
# differ: the encode's (JAX's CPU scan against the port's blocked form, JAX's TPU form), and XLA's fusion of the
# harness's synthesis into its program, which rounds the frame otherwise than JAX's own forward of the same frame.
# Measured: bipolar 2, a grid step each, the port's top two matched scores 6e-6 and 3e-4 apart (8, 11 dB);
# unipolar 1, at -7 dB, a peak 120 deg away that JAX's fused program puts 0.1 % above the port's choice, where JAX's
# unfused forward of the same frame gives the port's DoA
APART_MAX = 3
NEAR_TIE = 1e-3  # relative to the best score: a near tie of two matched scores (measured gaps 6e-6 and 3e-4)
# dB: a sidelobe is 10·log10 of the second-highest normalized rate; rates are integer counts, and one
# count of a few hundred in the second peak moves it by a few hundredths of a dB
SIDELOBE_TOL = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs small tensor ops in long Python loops (the plain
    LIF of the CPU path): under the lane's parallel workers, intra-op threads
    only contend for the cores, so this module runs them on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """No committed XLA executables; JAX's and the port's design caches in
    one temporary directory, so the port finds the designs and tables JAX
    makes."""
    tmp = tmp_path_factory.mktemp("designs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        mp.setattr(jax_cache, "_DEFAULT_DIR", str(tmp))
        mp.setenv(torch_cache.CACHE_ENV, str(tmp))
        yield mp


def quiet(fn, *args, **kwargs):
    """``fn`` without what it prints."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def x64_speech_template(*args, **kwargs):
    """JAX's speech template computed as its own tests compute it, under x64:
    its fallback's bandpass scan then runs in float64, as the port's does.
    Under ``enable_x64(False)`` the scan runs in float32, 5e-4 of the peak
    away."""
    import common as jax_common

    with jax.enable_x64(True):
        t, sig = jax_common.speech_template(*args, **kwargs)
    return np.asarray(t), np.asarray(sig)


def jax_draws(num_sims: int, T: int, seed: int):
    """JAX's per-trial draws in its multi-estimator sweeps: ``split(PRNGKey(seed),
    num_sims)``, then per key ``k_doa, k_noise = split(key)``, ``uniform(k_doa,
    (), 0, 2π)`` and ``normal(k_noise, (T, 7))``, float32."""
    def one(key):
        k_doa, k_noise = jax.random.split(key)
        return (jax.random.uniform(k_doa, (), minval=0.0, maxval=2 * jnp.pi),
                jax.random.normal(k_noise, (T, 7), jnp.float32))

    with jax.enable_x64(False):
        doas, noise = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(seed), num_sims))
    return np.array(doas), np.array(noise)


def recorded(monkeypatch, modules):
    """Record every (DoAs, truth) pair the harnesses score: ``folded_angle_error``
    in each of ``modules`` wrapped, the calls in order."""
    calls = []
    for mod in modules:
        real = mod.folded_angle_error

        def record(est, true, real=real):
            calls.append(np.asarray(est))
            return real(est, true)
        monkeypatch.setattr(mod, "folded_angle_error", record)
    return calls


def grid_index(doa, G: int) -> np.ndarray:
    """DoA → grid index; the grid's two ends (−π and π) are one direction."""
    grid = np.linspace(-np.pi, np.pi, G)
    idx = np.abs(np.asarray(doa, np.float64).reshape(-1)[:, None] - grid[None, :]).argmin(axis=1)
    return (idx % (G - 1)).reshape(np.shape(doa))


def same_keys(got, want, path=""):
    """``got`` has ``want``'s nested keys and list lengths."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            same_keys(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path


def speech_run(bipolar: bool) -> dict:
    """Both packages' ``run_speech`` at JAX's test size, the port on JAX's
    design, tables and draws; every DoA either scores, in order.  Needs the
    ``caches`` fixture."""
    with pytest.MonkeyPatch.context() as mp:
        jcalls = recorded(mp, [jax_parallel])
        mp.setattr(jax_xylo, "speech_template", x64_speech_template)
        with jax.enable_x64(False):
            want = jax_xylo.run_speech(bipolar=bipolar, **SIZE, batch_size=JAX_BATCH)
        tcalls = recorded(mp, [montecarlo])
        t_sp, _ = speech_template(duration=SIZE["duration"])
        draws = [jax_draws(SIZE["num_sims"], len(t_sp), seed) for seed in (0, 1)]
        got = xylo.run_speech(bipolar=bipolar, **SIZE, device="cpu", draws=draws[0], robust_draws=draws[1])
    return dict(bipolar=bipolar, want=want, got=got, draws=draws, jax_doa=np.stack(jcalls),
                port_doa=np.stack(tcalls))


@pytest.fixture(scope="module")
def speech_runs(caches):
    return speech_run(bipolar=True)


def test_torch_speech_beam_profiles_match_jax(speech_runs):
    """Stage A: the same numpy noise on the speech at DoA 0, one frame a SNR."""
    got, want = speech_runs["got"]["beam_profiles"], speech_runs["want"]["beam_profiles"]
    assert sorted(got) == sorted(want) == sorted(["-10dB", "+0dB", "+10dB", "+20dB"])
    for snr, w in want.items():
        g = got[snr]
        for k in ("peak_err_deg", "matched_tone_err_deg", "matched_speech_err_deg"):
            assert abs(g[k] - w[k]) < 1e-4, (snr, k)
        assert abs(g["sidelobe_db"] - w["sidelobe_db"]) <= SIDELOBE_TOL, snr
        assert len(g["profile"]) == SIZE["num_grid"] and max(g["profile"]) <= 1.0


def stage_trial(call: int, duration: float):
    """Stage B's or C's template and SNR of the ``call``-th scored batch:
    stage B's 11 SNRs, then tone, chirp and speech at C's 4 each."""
    from haghighatshoarmuir2024_tpu_torch.experiments.common import (chirp_template, sinusoid_template,
                                                                     snr_sweep_config)

    if call < 11:
        return "speech", speech_template(duration), float(snr_sweep_config()[call])
    name = ("tone", "chirp", "speech")[(call - 11) // 4]
    tpl = {"tone": lambda: sinusoid_template(float(np.mean(xylo.FREQ_RANGE)), duration),
           "chirp": lambda: chirp_template(xylo.FREQ_RANGE, duration),
           "speech": lambda: speech_template(duration)}[name]()
    return name, tpl, xylo.ROBUST_SNRS[(call - 11) % 4]


def near_tie(r, call: int, trial: int, est: int) -> str:
    """Why the port's DoA of one scored trial differs from JAX's harness's:
    the same frame through JAX's own ``_forward_jit`` unfused (the harness
    fuses the synthesis into its program, which rounds the frame otherwise)
    gives the port's DoA, or the port's score at JAX's DoA is within
    ``NEAR_TIE`` of its best.  Empty when neither holds."""
    from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
    from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template as jax_signal_from_template

    from haghighatshoarmuir2024_tpu_torch.parallel import make_trial_fn

    G, bipolar = SIZE["num_grid"], r["bipolar"]
    name, (t, sig), snr = stage_trial(call, SIZE["duration"])
    doas, noise = r["draws"][0 if call < 11 else 1]
    demo = xylo.build_demo(bipolar, G, 1.0, "cpu")  # JAX's design and tables, from the shared cache
    tables = [demo.calibrate_profiles(), demo.calibrate_profiles(template=None if name == "tone" else (t, sig))]
    frame = make_trial_fn(demo.geometry, t, sig, lambda f: f, FS, device="cpu")(
        None, snr, 1, doa_true=doas[trial:trial + 1], noise=noise[trial:trial + 1])[1]

    def scores(rate):
        rate = np.asarray(rate, np.float64)
        return rate if est == 0 else tables[est - 1].astype(np.float64) @ (rate - rate.mean())

    port = scores(demo.fold(demo.rates_batch(frame))[0].numpy())
    with jax.enable_x64(False):
        jd = JaxDemo(geometry=jax_xylo.CenterCircularArray(radius=4.5e-2, num_mic=7),
                     freq_bands=[list(xylo.FREQ_RANGE)], doa_list=np.linspace(-np.pi, np.pi, G),
                     recording_duration=1.0, kernel_duration=10e-3, bipolar_spikes=bipolar, fs=FS)
        s = jax_signal_from_template(jd.geometry, jnp.asarray(t, jnp.float32), jnp.asarray(sig, jnp.float32),
                                     jnp.float32(doas[trial]), fs=FS)
        sigma = jnp.sqrt(jnp.mean(s**2) / jnp.float32(10.0 ** (snr / 10.0)))
        unfused = scores(jd._forward_jit(s + sigma * jnp.asarray(noise[trial]))[1])
    want = grid_index(r["jax_doa"][call, trial, est], G)
    if grid_index(demo.doa_list[np.argmax(unfused)], G) == grid_index(demo.doa_list[np.argmax(port)], G):
        return "JAX's unfused forward gives the port's DoA"
    if port.max() - port[want] <= NEAR_TIE * np.abs(port).max():
        return f"the port's score at JAX's DoA {port[want]:.6g} against its best {port.max():.6g}"
    return ""


def test_torch_speech_mc_and_robustness_match_jax_draws(speech_runs):
    """Stages B and C on JAX's draws: every trial's DoA the same grid index,
    every estimator, but for at most ``APART_MAX`` near ties; the MAE rows
    of the SNRs with no such trial agree to float rounding."""
    r, G = speech_runs, SIZE["num_grid"]
    # stage B: 11 SNRs; stage C: 3 templates x 4 SNRs; one call a SNR (the 2 trials are one batch)
    assert r["jax_doa"].shape == r["port_doa"].shape == (11 + 3 * 4, SIZE["num_sims"], 3)
    apart = grid_index(r["jax_doa"], G) != grid_index(r["port_doa"], G)
    assert apart.sum() <= APART_MAX, np.argwhere(apart)
    for call, trial, est in np.argwhere(apart):
        assert near_tie(r, call, trial, est), (call, trial, est)
    got, want = r["got"], r["want"]
    same_keys(got, want)
    rows = [("speech_mc", lab, k, slice(0, 11), e) for e, lab in enumerate(xylo.SPEECH_LABELS)
            for k in ("mae_deg", "median_deg")]
    rows += [("calibration_robustness", name, f"{col}_mae_deg", slice(11 + 4 * i, 15 + 4 * i), e)
             for i, name in enumerate(("tone", "chirp", "speech"))
             for e, col in enumerate(("reference_peak", "matched_tone_cal", "matched_self_cal"))]
    for part, name, key, calls, e in rows:
        clean = ~apart[calls, :, e].any(axis=1)
        np.testing.assert_allclose(np.asarray(got[part][name][key])[clean], np.asarray(want[part][name][key])[clean],
                                   rtol=0, atol=1e-4, err_msg=f"{part} {name} {key}")


def check_calibration_tables(bipolar: bool) -> None:
    """The port's own tone, chirp and speech tables from JAX's design,
    against JAX's tables of ``run_speech`` at the test size: tone and chirp
    within ``TABLE_TOL``; the speech's rasters of its calibration frames
    within ``RASTER_APART`` past the fallback's onset, and its table within
    ``SPEECH_TABLE_TOL``.  Needs the ``caches`` fixture."""
    from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
    from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template as jax_signal_from_template

    from haghighatshoarmuir2024_tpu_torch.experiments.common import chirp_template

    G = SIZE["num_grid"]
    with jax.enable_x64(False):  # JAX's design and tables, written to (or read from) the shared cache
        jdemo = JaxDemo(geometry=jax_xylo.CenterCircularArray(radius=4.5e-2, num_mic=7),
                        freq_bands=[list(xylo.FREQ_RANGE)], doa_list=np.linspace(-np.pi, np.pi, G),
                        recording_duration=1.0, kernel_duration=10e-3, bipolar_spikes=bipolar, fs=FS)
    demo = xylo.build_demo(bipolar, G, 1.0, "cpu")  # JAX's design, from the cache
    np.testing.assert_array_equal(demo.xylo_config.w_in, np.asarray(jdemo.xylo_config.w_in))
    t_sp, sig_sp = speech_template(SIZE["duration"])
    for tpl, tol in ((None, TABLE_TOL), (chirp_template(xylo.FREQ_RANGE, SIZE["duration"]), TABLE_TOL),
                     ((t_sp, sig_sp), SPEECH_TABLE_TOL)):
        with jax.enable_x64(False):
            want = np.asarray(jdemo.calibrate_profiles(template=tpl))
        got = demo.calibrate_profiles(template=tpl, use_cache=False)
        assert got.shape == want.shape == (G, G)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the speech's calibration frames, one a DoA: the rasters differ at the onset, and past it by a few near ties
    with jax.enable_x64(False):
        frames = np.stack([np.asarray(jax_signal_from_template(
            jdemo.geometry, jnp.asarray(t_sp, jnp.float32), jnp.asarray(sig_sp, jnp.float32), jnp.float32(d), fs=FS))
            for d in jdemo.doa_list])
        want = np.asarray(jax.vmap(jdemo.spike_encoding)(jnp.asarray(frames)))
    got = demo.spike_encoding(torch.as_tensor(frames)).numpy()
    assert got.shape == want.shape and np.abs(want).sum() > 0
    assert (got[:, ONSET:] != want[:, ONSET:]).mean() < RASTER_APART


# ------------------------------------------------------------- the JAX gates
ORDERING_ARGS = ["--speech", "--sims", "10", "--snrs", "10", "--json"]


def jax_ordering(argv) -> dict:
    """JAX's ``xylo_ordering_sensitivity.main`` with ``argv`` (``--json``
    among them), its JSON line parsed.  The harness imports
    ``experiments.common`` from the working directory: it runs from the
    repository root."""
    saved, cwd = sys.argv, os.getcwd()
    sys.argv = ["xylo_ordering_sensitivity.py"] + list(argv)
    os.chdir(REPO)
    buf = io.StringIO()
    try:
        import xylo_ordering_sensitivity

        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            xylo_ordering_sensitivity.main()
    finally:
        sys.argv = saved
        os.chdir(cwd)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# the columns of each job's rows of errors, in the order JAX's harness scores them (``chip_smoke.py``'s names)
SD_COLUMNS = {
    "speech": [(11, list(xylo.SPEECH_LABELS))] + [
        (4, [f"{tpl}/{c}" for c in ("reference_peak", "matched_tone_cal", "matched_self_cal")])
        for tpl in ("tone", "chirp", "speech")],
    "multiband": [(6, [f"single/{c}" for c in port_mb.THREE_BAND_COLUMNS[:2]]),
                  (6, [f"three/{c}" for c in port_mb.THREE_BAND_COLUMNS])],
    "cross_segment": [(3, ["cross/self_segment", "cross/cross_segment"])],
}
SD_COLUMNS["speech_uni"] = SD_COLUMNS["speech"]


def trial_sd(job: str, calls, num_sims: int, chunk: int) -> dict:
    """Each column's per-trial standard deviation of the errors (deg, ddof
    1) at each SNR, from the ``folded_angle_error`` results the harness
    made in order: ``ceil(num_sims / chunk)`` calls a SNR row, the padded
    trials dropped, as the harness drops them."""
    per = -(-num_sims // chunk)
    rows = [np.concatenate(calls[i:i + per])[:num_sims] for i in range(0, len(calls), per)]  # (num_sims, K) each
    out, r0 = {}, 0
    for n_rows, names in SD_COLUMNS[job]:
        sd = np.degrees(np.stack(rows[r0:r0 + n_rows]).std(axis=1, ddof=1))  # (n_rows, K)
        out.update({name: sd[:, k].round(4).tolist() for k, name in enumerate(names)})
        r0 += n_rows
    assert r0 == len(rows), (job, r0, len(rows))
    return out


def jax_gates(argv) -> list:
    """One JAX harness at the size phase 24 runs the port's twin, at each
    seed of ``argv[1:]`` (0 when none): one JSON line a seed, its results
    and, for the Monte-Carlo jobs, each column's per-trial standard
    deviation (``sd_deg``); with two or more seeds a last line of the seeds'
    pooled deviation, ``sqrt(mean(sd²))`` (module docstring)."""
    job = argv[0]
    lines = []
    for seed in [int(s) for s in argv[1:]] or [0]:
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            for mod in (jax_parallel, jax_mb):
                def record(est, true, real=mod.folded_angle_error):
                    err = real(est, true)
                    calls.append(np.asarray(err))
                    return err
                mp.setattr(mod, "folded_angle_error", record)
            if job in ("speech", "speech_uni"):
                n, chunk = (100 if job == "speech" else 20), 20
                out = jax_xylo.run_speech(bipolar=job == "speech", num_sims=n, seed=seed)
                for v in out["beam_profiles"].values():
                    v.pop("profile")
            elif job == "multiband":
                n, chunk = 50, 16
                out = jax_mb.run(seed=seed)
            elif job == "cross_segment":
                n, chunk = 50, 16
                out = jax_mb.run_cross_segment(seed=seed)
            elif job == "ordering":
                out = jax_ordering(ORDERING_ARGS)
            elif job == "stht":
                out = quiet(jax_stht.main)
            else:
                raise SystemExit(f"unknown job {job!r}")
        line = {"job": job, "seed": seed, "results": out}
        if job in SD_COLUMNS:
            line["sd_deg"] = trial_sd(job, calls, n, chunk)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if len(lines) > 1 and "sd_deg" in lines[0]:
        pooled = {k: np.sqrt(np.mean([np.square(ln["sd_deg"][k]) for ln in lines], axis=0)).round(4).tolist()
                  for k in lines[0]["sd_deg"]}
        print(json.dumps({"job": job, "seeds": [ln["seed"] for ln in lines], "pooled_sd_deg": pooled}))
    return lines


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-gates", "usage: --jax-gates JOB [SEED...]"
    jax_gates(sys.argv[2:])
