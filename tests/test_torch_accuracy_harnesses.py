"""The port's accuracy harnesses of the classical families and the float SNN
(``haghighatshoarmuir2024_tpu_torch/experiments/``: target_localization,
target_localization_music, srp_phat_baseline, target_snn_localization),
the pieces they need (``config.SNNBeamformerConfig``, ``utils.to_numpy``,
the batched ``SNNBeamformer.apply_to_signal`` and its ``apply_to_template``,
the templates, ``beam_pattern`` and ``beamwidth_3db`` of
``experiments/common.py``) and the Monte-Carlo replay of JAX's own draws,
against the JAX package on the CPU at a small size: a 17-point grid, 0.05 s
frames, 2-4 trials.

Tolerances:

- templates, ``beam_pattern`` on the same float64 input and
  ``beamwidth_3db``: 1e-12; the band-limited noise template 1e-11 (peak
  0.55): the port's float64 scan equals a plain loop of its order of
  operations to the bit, and JAX's XLA scan is 1.7e-12 off that loop (and
  scipy's ``lfilter`` 1.3e-12 off it);
- the SNN membrane, single and batched, on the same design and frames
  (JAX under ``jax.enable_x64(False)``, both in float32): within 5e-4 of
  the output's peak (the order-2 bandpass amplifies float32 rounding, as
  the Hilbert path's in ``test_torch_families.py``), the batch equal to its
  frames one at a time within 1e-5 of the peak;
- each sweep's trial batch on the same numpy DoAs and noise: DoA grid
  indices equal, rows 0 and G-1 (-π and π) one direction; the designs are
  JAX's, handed to the port (a design's unit phase is LAPACK's choice in
  either package, ``test_torch_design.py``);
- JAX's own draws (``jax.random.split`` of ``PRNGKey(0)``, then the
  ``uniform``/``normal`` of ``parallel/montecarlo.py:59-70``) replayed
  through the port's Xylo trial: per-trial DoA indices equal to JAX's
  ``monte_carlo_sweep``'s, reference and matched estimators.

``python tests/test_torch_accuracy_harnesses.py --mc-replay`` runs that
replay at the harness's full size (112-point grid, 100 trials, 11 SNRs, 0.25
s) and prints both packages' MAE rows; ``--three-band`` runs the three-band
model's peak estimator on ``multiband_frames(demo, 96, seed=0)`` through
both packages, frame by frame.
"""
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import common as jax_common  # noqa: E402

import haghighatshoarmuir2024_tpu as jpkg  # noqa: E402
from haghighatshoarmuir2024_tpu import config as jax_config  # noqa: E402
from haghighatshoarmuir2024_tpu.models.beamformer import Beamformer as JaxBeamformer  # noqa: E402
from haghighatshoarmuir2024_tpu.models.music import MUSIC as JaxMUSIC  # noqa: E402
from haghighatshoarmuir2024_tpu.models.snn_beamformer import SNNBeamformer as JaxSNN  # noqa: E402
from haghighatshoarmuir2024_tpu.models.srp_phat import SRPPHAT as JaxSRPPHAT  # noqa: E402
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo  # noqa: E402
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template as jax_signal_from_template  # noqa: E402
from haghighatshoarmuir2024_tpu.parallel import make_trial_fn as jax_make_trial_fn  # noqa: E402
from haghighatshoarmuir2024_tpu.parallel import monte_carlo_sweep as jax_monte_carlo_sweep  # noqa: E402
from haghighatshoarmuir2024_tpu.parallel import snr_with_bandwidth_correction as jax_snr_bw  # noqa: E402
from haghighatshoarmuir2024_tpu.utils import to_numpy as jax_to_numpy  # noqa: E402
from haghighatshoarmuir2024_tpu.utils.peak_location import find_peak_location as jax_find_peak_location  # noqa: E402

import haghighatshoarmuir2024_tpu_torch as tpkg  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.config import SNNBeamformerConfig  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import common  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import srp_phat_baseline as srp_h  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import target_localization as hilbert_h  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import target_localization_music as music_h  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import target_snn_localization as snn_h  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments.target_xylo_localization import peak_window, reference_doa  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.models.snn_beamformer import SNNBeamformer  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.parallel import make_trial_fn, monte_carlo_sweep  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.utils import to_numpy  # noqa: E402

FS, G, DUR = 48_000, 17, 0.05
GRID = np.linspace(-np.pi, np.pi, G)
SNN_TOL, BATCH_TOL = 5e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs small tensor ops in long Python loops (the
    per-sample scans): under the lane's parallel workers, intra-op threads
    only contend for the cores, so this module runs them on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_persistent_cache():
    """Build the JAX models without seeding the committed XLA executables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        yield


def grid_index(doa, grid=GRID) -> np.ndarray:
    """DoA → grid index; the grid's two ends (−π and π) are one direction."""
    idx = np.abs(np.asarray(doa, np.float64).reshape(-1)[:, None] - grid[None, :]).argmin(axis=1)
    return idx % (len(grid) - 1)


def draws(n: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2 * np.pi, n).astype(np.float32), rng.standard_normal((n, T, 7)).astype(np.float32)


def jax_trial_estimates(geometry, t, sig, doas, noise, snr_db, estimate, delay_sign=1):
    """JAX ``make_trial_fn``'s trial body (``montecarlo.py:60-70``) with the
    DoAs and the noise given instead of drawn, float32."""
    t32, s32 = jnp.asarray(t, jnp.float32), jnp.asarray(sig, jnp.float32)
    out = []
    for d, z in zip(doas, noise):
        s = jax_signal_from_template(geometry, t32, s32, jnp.float32(d), fs=FS, delay_sign=delay_sign)
        sigma = jnp.sqrt(jnp.mean(s**2) / jnp.float32(10.0 ** (snr_db / 10.0)))
        out.append(float(estimate(s + sigma * jnp.asarray(z))))
    return np.asarray(out)


def port_trial_estimates(profile, geometry, t, sig, doas, noise, snr_db, delay_sign=1):
    grid_t = torch.as_tensor(GRID)
    trial = make_trial_fn(geometry, t, sig, lambda f: grid_t[profile(f).argmax(dim=-1)], FS, delay_sign=delay_sign,
                          device="cpu")
    true, est = trial(None, snr_db, len(doas), doa_true=doas, noise=noise)
    np.testing.assert_array_equal(true.numpy(), doas)
    return est.numpy()


def printed(capsys) -> dict:
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


# ------------------------------------------------------------ small pieces
def test_torch_snn_beamformer_config_matches_jax():
    for kw in ({}, {"freq_range": (1000.0, 2000.0), "fs": 24_000, "kernel_duration": 5e-3, "bipolar_spikes": True}):
        got, want = SNNBeamformerConfig(**kw), jax_config.SNNBeamformerConfig(**kw)
        fields = [f.name for f in jax_config.SNNBeamformerConfig.__dataclass_fields__.values()]
        assert [f for f in SNNBeamformerConfig.__dataclass_fields__] == fields
        for name in fields + ["kernel_length", "robust_width"]:
            assert getattr(got, name) == getattr(want, name), name
    snn = SNNBeamformer.from_config(SNNBeamformerConfig(bipolar_spikes=True), tpkg.CenterCircularArray(4.5e-2, 7),
                                    device="cpu")
    assert snn.robust_width == SNNBeamformerConfig().robust_width and snn.bipolar_spikes


def test_torch_to_numpy_matches_jax():
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))).astype(np.complex64)
    for x in (z, z.real.copy()):
        got = to_numpy(torch.as_tensor(x))
        assert isinstance(got, np.ndarray) and got.dtype == x.dtype
        np.testing.assert_array_equal(got, jax_to_numpy(jnp.asarray(x)))
    np.testing.assert_array_equal(to_numpy([1.0, 2.0]), np.asarray([1.0, 2.0]))


@pytest.mark.parametrize("name,args", [
    ("sinusoid_template", (1500.0, 0.05)),
    ("jittered_sinusoid_template", (1500.0, 0.05)),
    ("chirp_template", ((1000.0, 2000.0), 0.05)),
    ("bandlimited_noise_template", ((500.0, 1000.0), 0.05)),
    ("speech_template", (0.1,)),
    ("speech_template", (0.25,)),
])
def test_torch_templates_match_jax(name, args):
    t, sig = getattr(common, name)(*args)
    jt, jsig = getattr(jax_common, name)(*args)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sig, np.asarray(jsig), rtol=0, atol=1e-11 if name.startswith("bandlimited") else 1e-12)


def test_torch_bandlimited_noise_is_the_plain_scan():
    """The noise template's bandpass is the transposed-DF2 recurrence in
    float64, ``y = b0 x + s1``, ``s_i = (b_i x − a_i y) + s_{i+1}``, to the bit."""
    from haghighatshoarmuir2024_tpu_torch.ops.iir import butter_bandpass

    _, sig = common.bandlimited_noise_template((500.0, 1000.0), 0.05)
    x = np.random.default_rng(0).standard_normal(len(sig))
    b, a = butter_bandpass(2, (500.0, 1000.0), FS)
    bp, at = b / a[0], a[1:] / a[0]
    s, want = [0.0] * (len(a) - 1), []
    for xt in x:
        y = bp[0] * xt + s[0]
        s = [(bp[i + 1] * xt - at[i] * y) + (s[i + 1] if i + 1 < len(s) else 0.0) for i in range(len(s))]
        want.append(y)
    np.testing.assert_array_equal(sig, want)


@pytest.mark.parametrize("fold", [False, True])
def test_torch_beam_pattern_and_beamwidth_match_jax(fold):
    rng = np.random.default_rng(int(fold))
    bf = rng.standard_normal((14, 33)) if fold else rng.standard_normal((7, 33)) + 1j * rng.standard_normal((7, 33))
    grid = np.linspace(-np.pi, np.pi, 33)
    got = common.beam_pattern(torch.as_tensor(bf), complex_fold=fold)
    want = jax_common.beam_pattern(bf, complex_fold=fold)
    assert got.shape == (33, 33)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for row in want:
        assert common.beamwidth_3db(row, grid) == pytest.approx(jax_common.beamwidth_3db(row, grid), abs=1e-12)
    w = common.widths(want, grid)
    assert w["beamwidth_3db_deg_mean"] == pytest.approx(np.mean([jax_common.beamwidth_3db(r, grid) for r in want]),
                                                        abs=1e-12)


# ------------------------------------------------------------ the float SNN
@pytest.fixture(scope="module")
def snn_pair():
    """The bipolar SNN of the harness at a small size, designed by JAX in
    float32; the port's beamformer of the same configuration."""
    tau = 1.0 / (2 * np.pi * 1500.0)
    t, sig = common.chirp_template(snn_h.FREQ_RANGE, DUR)
    with jax.enable_x64(False):
        js = JaxSNN(jpkg.CenterCircularArray(4.5e-2, 7), 10e-3, snn_h.FREQ_RANGE, [tau, tau], bipolar_spikes=True,
                    fs=FS)
        bf = np.asarray(js.design_from_template((t, sig), GRID))
    ts = SNNBeamformer(tpkg.CenterCircularArray(4.5e-2, 7), 10e-3, snn_h.FREQ_RANGE, [tau, tau], bipolar_spikes=True,
                       fs=FS, device="cpu")
    return js, ts, bf, t, sig


def test_torch_snn_apply_single_and_batched_match_jax(snn_pair):
    js, ts, bf, t, _ = snn_pair
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((3, len(t), 7)).astype(np.float32)
    batch = ts.apply_to_signal(bf, (t, torch.as_tensor(frames))).numpy()
    assert batch.shape == (3, len(t), G)
    for i, x in enumerate(frames):
        one = ts.apply_to_signal(bf, (t, x)).numpy()
        with jax.enable_x64(False):
            want = np.asarray(js.apply_to_signal(bf, (t, x)))
        peak = np.abs(want).max()
        np.testing.assert_allclose(one, want, rtol=0, atol=SNN_TOL * peak)
        np.testing.assert_allclose(batch[i], one, rtol=0, atol=BATCH_TOL * peak)
    with pytest.raises(ValueError, match="number of channels"):
        ts.apply_to_signal(bf, (t, frames[..., :6]))


def test_torch_snn_apply_resamples_a_nonuniform_batch(snn_pair):
    """A time axis not at 1/fs is resampled on the host, each frame as the
    single-frame path does it."""
    _, ts, bf, t, _ = snn_pair
    t2 = t * 1.5
    frames = np.random.default_rng(8).standard_normal((2, len(t), 7))
    batch = ts.apply_to_signal(bf, (t2, frames)).numpy()
    for i in range(2):
        one = ts.apply_to_signal(bf, (t2, frames[i])).numpy()
        np.testing.assert_allclose(batch[i], one, rtol=0, atol=BATCH_TOL * np.abs(one).max())


def test_torch_snn_apply_to_template_matches_jax(snn_pair):
    js, ts, bf, t, sig = snn_pair
    got = ts.apply_to_template(bf, (t, sig, 0.7), snr_db=None).numpy()
    with jax.enable_x64(False):
        want = np.asarray(js.apply_to_template(bf, (t, sig, 0.7), snr_db=None, key=jax.random.PRNGKey(0)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=SNN_TOL * np.abs(want).max())
    a = ts.apply_to_template(bf, (t, sig, 0.7), snr_db=5.0, generator=torch.Generator().manual_seed(1))
    b = ts.apply_to_template(bf, (t, sig, 0.7), snr_db=5.0, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not np.allclose(a.numpy(), got)


# ------------------------------------------------------------ the four sweeps
def hilbert_models():
    t, sig = common.sinusoid_template(hilbert_h.TONE, DUR)
    with jax.enable_x64(False):
        jb = JaxBeamformer(jpkg.CenterCircularArray(4.5e-2, 7), 10e-3, hilbert_h.FREQ_RANGE, fs=FS)
        bf_mat = jax_to_numpy(jb.design_from_template((t, sig), GRID)[0])
    tb = hilbert_h.build(G, DUR, device="cpu")[0]
    jax_est = lambda s: jnp.asarray(GRID)[jnp.argmax(jnp.mean(jnp.abs(jb.apply_to_signal(bf_mat, s)) ** 2, axis=0))]
    return hilbert_h.profile_fn(tb, bf_mat), jax_est, (t, sig), 1


def music_models():
    t, sig = common.sinusoid_template(hilbert_h.TONE, DUR)
    jm = JaxMUSIC(jpkg.CenterCircularArray(4.5e-2, 7), hilbert_h.FREQ_RANGE, GRID, frame_duration=DUR, fs=FS)
    jax_est = lambda s: jnp.asarray(GRID)[jnp.argmax(jm.beamforming(s, music_h.NUM_ACTIVE_FREQ, music_h.NUM_FFT_BIN))]
    return music_h.profile_fn(music_h.build(G, DUR, device="cpu")), jax_est, (t, sig), -1


def srp_models(target="tone"):
    srp, (t, sig) = srp_h.build(target, G, DUR, DUR, device="cpu")
    js = JaxSRPPHAT(jpkg.CenterCircularArray(4.5e-2, 7), freq_range=srp.freq_range, doa_list=GRID, fs=FS,
                    frame_duration=t[-1] + 1.0 / FS)
    jax_est = lambda s: jnp.asarray(GRID)[jnp.argmax(js._power_impl(s, js._steer_re, js._steer_im))]
    return srp.apply_to_signal, jax_est, (t, sig), -1


def snn_models(snn_pair):
    js, ts, bf, t, sig = snn_pair
    jax_est = lambda s: jnp.asarray(GRID)[jnp.argmax(jnp.mean(js.apply_to_signal(bf, (t, s)) ** 2, axis=0))]
    return snn_h.profile_fn(ts, bf, t), jax_est, (t, sig), 1


@pytest.mark.parametrize("snr_db", [-10.0, 5.0])
@pytest.mark.parametrize("family", ["hilbert", "music", "srp", "srp_chirp", "snn"])
def test_torch_sweep_trial_batch_matches_jax(family, snr_db, snn_pair):
    """One trial batch of each sweep on the same numpy DoAs and noise:
    equal DoA grid indices (the SNN at its bandwidth-corrected SNR)."""
    make = {"hilbert": hilbert_models, "music": music_models, "srp": srp_models,
            "srp_chirp": lambda: srp_models("chirp"), "snn": lambda: snn_models(snn_pair)}[family]
    with jax.enable_x64(False):
        profile, jax_est, (t, sig), sign = make()
        snr = jax_snr_bw(snr_db, FS, snn_h.FREQ_RANGE) if family == "snn" else snr_db
        doas, noise = draws(3, len(t), seed=int(snr_db) + 40)
        want = jax_trial_estimates(jpkg.CenterCircularArray(4.5e-2, 7), t, sig, doas, noise, snr, jax_est, sign)
    got = port_trial_estimates(profile, tpkg.CenterCircularArray(4.5e-2, 7), t, sig, doas, noise, snr, sign)
    np.testing.assert_array_equal(grid_index(got), grid_index(want))


def test_torch_sweeps_replay_injected_draws():
    """``run(draws=...)`` replays the given DoAs and noise at every SNR:
    the errors equal those of the trial batch on the same draws."""
    model = hilbert_h.build(G, DUR, device="cpu")
    t, sig = common.sinusoid_template(hilbert_h.TONE, DUR)
    doas, noise = draws(3, len(t), seed=3)
    res = hilbert_h.run("tone", 3, G, duration=DUR, device="cpu", draws=(doas, noise), model=model)
    assert sorted(res) == ["errors", "mae", "median", "snr_db"] and res["errors"].shape == (11, 3)
    est = port_trial_estimates(hilbert_h.profile_fn(*model[:2]), model[0].geometry, t, sig, doas, noise, -10.0)
    np.testing.assert_allclose(res["errors"][0], np.arcsin(np.abs(np.sin(est - doas.astype(np.float64)))),
                               rtol=0, atol=1e-6)


def test_torch_snn_harness_reports_nominal_snrs():
    np.testing.assert_allclose(snn_h.bandwidth_corrected_snrs(),
                               [jax_snr_bw(s, FS, snn_h.FREQ_RANGE) for s in jax_common.snr_sweep_config()],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("module,name,targets", [
    (hilbert_h, "target_localization", ["speech", "tone"]),
    (music_h, "target_localization_music", ["speech", "tone"]),
    (srp_h, "srp_phat_baseline", ["chirp", "speech", "tone"]),
    (snn_h, "target_snn_localization", ["speech", "tone"]),
])
def test_torch_accuracy_harness_main_prints_jax_keys(module, name, targets, capsys):
    res = module.main(["--quick", "--device", "cpu"])
    assert printed(capsys) == res
    assert res["experiment"] == name and sorted(res["results"]) == targets
    fake = {"snr_db": np.zeros(2), "mae": np.zeros(2), "median": np.zeros(2)}
    for sm in res["results"].values():
        assert sorted(sm) == sorted(jax_common.summarize(fake))
        assert sm["snr_db"] == [float(s) for s in jax_common.snr_sweep_config()]
        assert len(sm["mae_deg"]) == 11 and all(np.isfinite(sm["mae_deg"]))


# ------------------------------------------------ JAX's own MC draws, replayed
def jax_draws(num_sims: int, T: int, seed: int = 0):
    """JAX ``monte_carlo_sweep``'s per-trial draws (``montecarlo.py:59-70, 99``):
    ``split(PRNGKey(seed), num_sims)``, then per key ``k_doa, k_noise =
    split(key)``, ``uniform(k_doa, (), 0, 2π)`` and ``normal(k_noise, (T, M))``,
    float32 as JAX runs them."""
    def one(key):
        k_doa, k_noise = jax.random.split(key)
        return (jax.random.uniform(k_doa, (), minval=0.0, maxval=2 * jnp.pi),
                jax.random.normal(k_noise, (T, 7), jnp.float32))

    with jax.enable_x64(False):
        doas, noise = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(seed), num_sims))
    return np.asarray(doas), np.asarray(noise)


def xylo_models(num_grid: int, duration: float, kernel_duration: float, path):
    """The Xylo harness's model (1000-2000 Hz, bipolar) designed and
    calibrated by JAX and loaded by the port; the tone; JAX's two
    estimators, as ``experiments/target_xylo_localization.py:60-90`` builds them."""
    grid = np.linspace(-np.pi, np.pi, num_grid)
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[[1000.0, 2000.0]],
                 doa_list=grid, recording_duration=duration, kernel_duration=kernel_duration, bipolar_spikes=True,
                 fs=FS, use_cache=False)
    t, sig = common.sinusoid_template(1500.0, duration)
    jd.calibrate_profiles(template=(t, sig), use_cache=False)
    jd.save(str(path))
    grid_j, win, fwd, prof = jnp.asarray(grid), peak_window(num_grid), jd._forward_jit, jd._profiles

    def jax_reference(s):
        _, rate = fwd(s)
        return grid_j[jax_find_peak_location(rate, win) if win > 1 else jnp.argmax(rate)]

    def jax_matched(s):
        _, rate = fwd(s)
        return grid_j[jnp.argmax(prof @ (rate - jnp.mean(rate)))]

    td = Demo.load(str(path), device="cpu")
    port = {"reference": lambda f: reference_doa(td, td.fold(td.rates_batch(f))),
            "matched": lambda f: td.forward_batch(f, method="matched")[0]}
    return jd, td, (t, sig), {"reference": jax_reference, "matched": jax_matched}, port


def replay(num_grid, duration, num_sims, snrs, path, kernel_duration=10e-3):
    """JAX's sweep with its own keys and the port's trials on the same
    draws: per estimator, JAX's and the port's per-trial DoAs (num_snr,
    num_sims) and both packages' ``monte_carlo_sweep`` dicts."""
    with jax.enable_x64(False):
        jd, td, (t, sig), jax_est, port_est = xylo_models(num_grid, duration, kernel_duration, path)
    doas, noise = jax_draws(num_sims, len(t))
    out = {}
    for name in ("reference", "matched"):
        with jax.enable_x64(False):
            keys = jax.random.split(jax.random.PRNGKey(0), num_sims)
            trial = jax_make_trial_fn(jd.geometry, t, sig, jax_est[name], FS)
            jres = jax_monte_carlo_sweep(trial, snrs, num_sims, jax.random.PRNGKey(0))
            batched = jax.jit(jax.vmap(trial, in_axes=(0, None)))
            jdoa = []
            for s in snrs:
                dt, de = batched(keys, jnp.float32(s))
                np.testing.assert_array_equal(np.asarray(dt), doas)
                jdoa.append(np.asarray(de))
        ptrial = make_trial_fn(td.geometry, t, sig, port_est[name], FS, device="cpu")
        pdoa = [ptrial(None, float(s), num_sims, doa_true=doas, noise=noise)[1].numpy() for s in snrs]
        pres = monte_carlo_sweep(ptrial, snrs, num_sims, draws=(doas, noise))
        out[name] = dict(jax_doa=np.stack(jdoa), port_doa=np.stack(pdoa), jax=jres, port=pres, grid=td.doa_list)
    return out


def test_torch_mc_replays_jax_draws(tmp_path):
    """JAX's own draws through the port's Xylo trial (17-point grid, 0.05 s,
    4 trials, 2 SNRs): per-trial DoA indices equal to JAX's sweep's, for
    the reference-parity and the matched estimator."""
    out = replay(G, DUR, 4, [-10.0, 10.0], tmp_path / "model.npz", kernel_duration=5e-3)
    for name, r in out.items():
        for s in range(2):
            np.testing.assert_array_equal(grid_index(r["port_doa"][s]), grid_index(r["jax_doa"][s]), err_msg=name)
        np.testing.assert_allclose(r["port"]["errors"], r["jax"]["errors"], rtol=0, atol=1e-5, err_msg=name)


# ------------------------------------------- the three-band peak estimator
def three_band(frame_idx, path, own_design: bool = False):
    """The three-band model of ``multiband_bench.py`` designed by JAX (the
    port loads it, or with ``own_design`` designs its own), the port's
    ``multiband_frames(demo, 96, seed=0)``, and both packages' peak DoAs and
    folded errors on the frames ``frame_idx``."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo.multiband import multiband_config, multiband_frames

    cfg = multiband_config("cpu", 48_000)
    jcfg = {k: v for k, v in cfg.items() if k not in ("device", "geometry")}
    with jax.enable_x64(False):
        jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), use_cache=False, **jcfg)
    jd.save(str(path))
    td = Demo(**cfg, use_cache=False) if own_design else Demo.load(str(path), device="cpu")
    frames, doas, _ = multiband_frames(td, 96, seed=0)
    x = frames[list(frame_idx)]
    port = td.forward_batch(x, method="peak")[0].numpy()
    with jax.enable_x64(False):
        want = np.asarray(jd.forward_batch(jnp.asarray(x.numpy()), method="peak")[0])
    fold = lambda d: common.folded_deg(d, doas[list(frame_idx)])  # noqa: E731
    return port, want, fold(port), fold(want), cfg["doa_list"], (td, jd)


def design_gap(td, jd) -> dict:
    """Where two three-band designs differ: per band the least
    ``|<jax, port>|`` over the complex columns and the columns a phase of
    more than 1e-3 rad apart (π: a sign), then the quantized ``w_in``."""
    out = {}
    for b, (p, j) in enumerate(zip(td.bf_mats, jd.bf_mats)):
        p, j = np.asarray(p, np.float64), np.asarray(j, np.float64)
        ip = np.sum(np.conj(j[:7] + 1j * j[7:]) * (p[:7] + 1j * p[7:]), axis=0)
        out[f"band {b}"] = {"min_abs_inner": float(np.abs(ip).min()),
                            "columns_phase_over_1e-3": int((np.abs(np.angle(ip)) > 1e-3).sum()),
                            "columns_sign_flipped": int((np.abs(np.angle(ip)) > 3.0).sum())}
    wp, wj = np.asarray(td.xylo_config.w_in), np.asarray(jd.xylo_config.w_in)
    out["w_in"] = {"entries": int(wp.size), "differing": int((wp != wj).sum()),
                   "by_one": int((np.abs(wp.astype(np.int64) - wj) == 1).sum())}
    return out


@pytest.mark.slow
def test_torch_three_band_peak_matches_jax_on_the_cards_frames(tmp_path):
    """The frames of ``chip_smoke.py`` phase 19 at 48 kHz: frames 7 and 89,
    the two the peak estimator misses by 26 deg on the card, and two others
    give JAX's peak DoAs; 7 and 89 miss in JAX too (slow: JAX designs the
    449-point three-band model, about half a minute)."""
    port, want, err_p, err_j, grid, _ = three_band([7, 89, 0, 91], tmp_path / "three_band.npz")
    np.testing.assert_array_equal(grid_index(port, grid), grid_index(want, grid))
    assert (err_j[:2] > 25.0).all() and (err_p[:2] > 25.0).all()


def _main(argv) -> None:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description="the two checks of the port against JAX's draws and frames")
    ap.add_argument("--mc-replay", action="store_true", help="JAX's MC draws at full size through both packages")
    ap.add_argument("--three-band", action="store_true", help="the three-band peak DoAs on the card's 96 frames")
    ap.add_argument("--own-design", action="store_true", help="with --three-band: the port designs its own model")
    ap.add_argument("--jax-sweeps", action="store_true", help="the four JAX tone sweeps at their full size")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        stack.enter_context(pytest.MonkeyPatch.context()).setenv("HM2024_JAX_CACHE", "0")
        if args.mc_replay:
            snrs = list(jax_common.snr_sweep_config())
            for name, r in replay(16 * 7, 0.25, 100, snrs, Path(tmp) / "model.npz").items():
                g = r["grid"]
                differ = [int((grid_index(a, g) != grid_index(b, g)).sum()) for a, b in zip(r["port_doa"], r["jax_doa"])]
                print(json.dumps({"estimator": name, "snr_db": snrs,
                                  "jax_mae_deg": np.rad2deg(r["jax"]["mae"]).tolist(),
                                  "port_mae_deg": np.rad2deg(r["port"]["mae"]).tolist(),
                                  "trials_differing": differ}), flush=True)
        if args.jax_sweeps:  # JAX's own harnesses (224 points, 100 x 11, PRNGKey(0)), for their records
            import srp_phat_baseline as jax_srp
            import target_localization as jax_hil
            import target_localization_music as jax_mus
            import target_snn_localization as jax_snn

            for name, fn in (("hilbert", jax_hil.run), ("music", jax_mus.run), ("snn", jax_snn.run),
                             ("srp tone", jax_srp.run), ("srp chirp", lambda: jax_srp.run(target="chirp"))):
                with jax.enable_x64(False):
                    res = fn()
                print(json.dumps({"jax_sweep": name, "mae_deg": np.rad2deg(res["mae"]).tolist()}), flush=True)
        if args.three_band:
            idx = list(range(96))
            port, want, err_p, err_j, grid, (td, jd) = three_band(idx, Path(tmp) / "three_band.npz", args.own_design)
            print(json.dumps({"port_design": "own" if args.own_design else "JAX's", "frames_differing": np.flatnonzero(grid_index(port, grid) != grid_index(want, grid))
                              .tolist(), "port_ok_frac_25deg": float((err_p <= 25).mean()),
                              "jax_ok_frac_25deg": float((err_j <= 25).mean()),
                              "port_misses": np.flatnonzero(err_p > 25).tolist(),
                              "jax_misses": np.flatnonzero(err_j > 25).tolist(),
                              "frames_7_89_deg": {"port": err_p[[7, 89]].tolist(), "jax": err_j[[7, 89]].tolist()},
                              "designs": design_gap(td, jd) if args.own_design else "the same"}))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _main(sys.argv[1:])
