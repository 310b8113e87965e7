"""The flagship slice end to end: the port's ``Demo.forward_batch`` against
the JAX package's on the same frames (bundled flagship design, full 0.25 s
frames at 48 kHz), plus the stage hand-offs on identical inputs.

Parity is judged per stage on identical inputs — masks bit-exact from the
same ``cs``, counts bit-exact from the same masks — and end to end by the
DoAs.  End-to-end counts may differ by a few spikes: on the CPU the JAX
``_encode_cumsum`` runs a float32 sequential scan, 7.2e-4·max|cs| off float64,
where the port runs the TPU form (2.7e-6); measured, that moves 11 of ~48.8k
spikes and counts by at most 2."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops.iir import iir_filter
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template
from haghighatshoarmuir2024_tpu.ops.pallas.lif_kernel import lif_count_rates_bipolar
from haghighatshoarmuir2024_tpu.ops.pallas.suppress_kernel import rzcc_encode_bipolar_tm
from haghighatshoarmuir2024_tpu.ops.stht import stht

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo

REPO = Path(__file__).resolve().parent.parent
FS, G, B = 48_000, 449, 6
FLAGSHIP = dict(
    freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, G),
    recording_duration=0.25, kernel_duration=10e-3, bipolar_spikes=True, fs=FS,
)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_persistent_cache():
    """Build JAX Demos without seeding the committed XLA executables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        yield


def grid_index(doa: np.ndarray) -> np.ndarray:
    """DoA → grid index; the grid's two ends (−π and π) are one direction."""
    idx = np.abs(np.asarray(doa)[:, None] - FLAGSHIP["doa_list"][None, :]).argmin(axis=1)
    return idx % (G - 1)


@pytest.fixture(scope="module")
def slice_run():
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **FLAGSHIP)
    jd.calibrate_profiles()
    td = Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **FLAGSHIP, device="cpu")
    td.calibrate_profiles()
    # bench.py's frames, fewer of them
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    doas = np.linspace(-np.pi, np.pi, B, endpoint=False)
    frames = np.stack([np.asarray(signal_from_template(jd.geometry, t, sig, d, fs=FS)) for d in doas])
    frames = (frames + 0.1 * np.random.default_rng(0).standard_normal(frames.shape)).astype(np.float32)
    out = {"jd": jd, "td": td, "doas": doas, "frames": frames}
    for method in ("matched", "peak"):
        out[f"jax_{method}"] = [np.asarray(v) for v in jd.forward_batch(frames, method=method)]
        out[f"port_{method}"] = [v.numpy() for v in td.forward_batch(frames, method=method)]
    # the JAX TPU-form encode, frame by frame: (T, B, C)
    b, a = jd.filterbank.ba_list[0]
    kernel = np.asarray(jd.beamfs[0].kernel, np.float32)
    css = []
    for f in frames:
        h = stht(jnp.asarray(f), kernel, axis=0, method="blockmm")
        sr = jnp.concatenate([h.real, h.imag], axis=1)
        css.append(np.asarray(iir_filter(b, a, sr, axis=0, method="blocked_cumsum")))
    out["cs"] = np.stack(css, axis=1)
    return out


@pytest.mark.parametrize("method", ["matched", "peak"])
def test_torch_slice_doas_match_jax(slice_run, method):
    jdoa, jrate = slice_run[f"jax_{method}"]
    tdoa, trate = slice_run[f"port_{method}"]
    assert tdoa.shape == (B,) and trate.shape == (B, G) and np.isfinite(trate).all()
    np.testing.assert_array_equal(grid_index(tdoa), grid_index(jdoa))
    if method == "matched":  # the bench gate: within 5° of the source
        err = np.rad2deg(np.abs(np.arcsin(np.abs(np.sin(tdoa - slice_run["doas"])))))
        assert (err < 5.0).all()


def test_torch_slice_masks_bitexact_on_same_cs(slice_run):
    cs = slice_run["cs"]
    T, _, C = cs.shape
    jp, jn = rzcc_encode_bipolar_tm(jnp.asarray(cs.reshape(T, B * C)), 12, 24)
    tp, tn = slice_run["td"].rzcc(torch.as_tensor(cs))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).reshape(T, B, C))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn).reshape(T, B, C))
    slice_run["masks"] = (np.array(jp).reshape(T, B, C), np.array(jn).reshape(T, B, C))
    # about one spike per polarity and channel per period of the 1750 Hz source
    expected = 2 * B * C * T * 1750 / FS
    assert 0.9 * expected < int(tp.sum() + tn.sum()) < 1.1 * expected


def test_torch_slice_counts_bitexact_on_same_masks(slice_run):
    if "masks" not in slice_run:
        cs = slice_run["cs"]
        T, _, C = cs.shape
        jp, jn = rzcc_encode_bipolar_tm(jnp.asarray(cs.reshape(T, B * C)), 12, 24)
        slice_run["masks"] = (np.array(jp).reshape(T, B, C), np.array(jn).reshape(T, B, C))
    kp, kn = slice_run["masks"]
    ref = np.asarray(lif_count_rates_bipolar(slice_run["jd"].xylo_config, jnp.asarray(kp),
                                             jnp.asarray(kn), spike_bound=1))
    got = slice_run["td"].lif_counts(torch.as_tensor(kp), torch.as_tensor(kn))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0


def test_torch_slice_end_to_end_counts_within_2(slice_run):
    T = 12_000
    jrate = slice_run["jax_peak"][1]
    trate = slice_run["port_peak"][1]
    jcounts = np.rint(jrate * T / FS).astype(np.int64)
    tcounts = np.rint(trate * T / FS).astype(np.int64)
    np.testing.assert_allclose(jcounts * FS / T, jrate, rtol=1e-6)
    assert np.abs(jcounts - tcounts).max() <= 2
    assert (jcounts != tcounts).mean() < 0.05


def test_torch_port_runs_without_jax(tmp_path):
    """The port imports nothing of JAX: with ``jax`` unimportable the flagship
    forward still runs (one frame, CPU tensors), and so do the streaming
    runtime (one chunk), the serving module's import, a tiny unipolar
    model's design, calibration, ``Demo.forward`` and streaming chunk, K7's
    suppression op, the imports of the roofline probes and harness, and one
    call of each module of the classical families, the trackers, the audio
    sources and the localizer CLI (one SRP run on a wav)."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np, torch
        from haghighatshoarmuir2024_tpu_torch import CenterCircularArray
        from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
        from haghighatshoarmuir2024_tpu_torch.ops.interp import signal_from_template
        demo = Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7),
                    freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 449),
                    recording_duration=0.25, kernel_duration=10e-3, fs=48_000, device="cpu")
        demo.calibrate_profiles()
        t = torch.arange(0, 0.25, 1 / 48_000, dtype=torch.float64)
        frame = signal_from_template(demo.geometry, t, torch.sin(2 * np.pi * 1750 * t), 1.0, fs=48_000)
        doa, rate = demo.forward_batch(frame[None].float(), method="matched")
        from haghighatshoarmuir2024_tpu_torch.runtime import server, streaming
        sl = streaming.StreamingLocalizer(demo)
        state, spikes = sl.process_chunk(sl.init_state(), frame[:2400].float())
        assert spikes.shape == (2400, 28) and int(state.steps[0]) == 2400 and int(spikes.abs().sum()) > 0
        # a tiny unipolar model: designed and calibrated here, then one frame
        # through Demo.forward and one chunk through the streaming step
        uni = Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7),
                   freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 17),
                   recording_duration=0.05, kernel_duration=5e-3, bipolar_spikes=False, fs=48_000,
                   use_cache=False, device="cpu")
        prof = uni.calibrate_profiles(use_cache=False)
        assert prof.shape == (17, 17) and np.isfinite(prof).all() and np.isfinite(uni.bf_mats[0]).all()
        udoa, urate = uni.forward(frame[:2400].float())
        assert urate.shape == (17,) and bool(torch.isfinite(urate).all()) and float(urate.sum()) > 0
        usl = streaming.StreamingLocalizer(uni)
        ustate, uspikes = usl.process_chunk(usl.init_state(), frame[:2400].float())
        assert uspikes.shape == (2400, 14) and int(uspikes.sum()) > 0 and int(ustate.counts.sum()) > 0
        # the suppression op of K7, the roofline probes and their harness
        from haghighatshoarmuir2024_tpu_torch.experiments import roofline
        from haghighatshoarmuir2024_tpu_torch.ops.cuda import roofline_kernel, suppress_kernel
        h = torch.cumsum(torch.randn(500, 3), dim=0)
        assert int(suppress_kernel.select_by_distance_tm(torch.ones(500, 3, dtype=torch.bool), h, 12).sum()) > 0
        assert roofline_kernel.lif_peak(torch.ones(8, dtype=torch.int32), 16).shape == (8,)
        assert callable(roofline.run)
        # the classical families, the trackers, audio I/O and the CLI
        from haghighatshoarmuir2024_tpu_torch import config, geometry
        from haghighatshoarmuir2024_tpu_torch.io import audio, flac
        from haghighatshoarmuir2024_tpu_torch.models.beamformer import Beamformer
        from haghighatshoarmuir2024_tpu_torch.models.music import MUSIC
        from haghighatshoarmuir2024_tpu_torch.models.srp_phat import SRPPHAT
        from haghighatshoarmuir2024_tpu_torch.ops import filterbank, iir, interp, linalg, peaks
        from haghighatshoarmuir2024_tpu_torch.tools import localize
        from haghighatshoarmuir2024_tpu_torch.utils import tracking
        for g in (geometry.CircularArray(4e-2, 6), geometry.LinearArray(2e-2, 5),
                  geometry.Random2DArray(5e-2, 7, seed=1)):
            assert g.delays(torch.zeros(3, dtype=torch.float64)).shape == (3, len(g))
        geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
        x = interp.received_signal(geo, t[:2400], torch.sin(2 * np.pi * 1750 * t[:2400]), -0.5, snr_db=10.0,
                                   generator=torch.Generator().manual_seed(0), fs=48_000).float()
        b, a = iir.butter_bandpass(2, (1600, 1900), 48_000)
        for m in ("scan", "parallel", "blocked"):
            assert iir.iir_filter(b, a, x, method=m).shape == x.shape
        assert filterbank.Filterbank([(b, a)]).evolve(x).shape == (1,) + tuple(x.shape)
        eye = torch.eye(3, dtype=torch.float64)
        assert linalg.generalized_top_eigvec(eye + 1, eye).shape == (3,)
        bf = Beamformer.from_config(config.BeamformerConfig(design_chunk=4), geo, device="cpu")
        tt = np.arange(0, 0.02, 1 / 48_000)
        bf_mat, _ = bf.design_from_template((tt, np.sin(2 * np.pi * 1750 * tt)), np.linspace(-np.pi, np.pi, 9))
        assert bf.apply_to_signal(bf_mat, x).shape == (2400, 9)
        music = MUSIC.from_config(config.MUSICConfig(), geo, np.linspace(-np.pi, np.pi, 9), device="cpu")
        prof = music.beamforming(x, 2, 512, num_sources=1)
        srp = SRPPHAT(geo, (1400, 2100), np.linspace(-np.pi, np.pi, 9), frame_duration=0.05, device="cpu")
        assert srp.apply_to_signal(x[None]).shape == (1, 9)
        idx, _, ok = peaks.top_k_peaks(prof, 2, distance=2)
        assert tracking.track_angles(torch.zeros(4), device="cpu").shape == (4,)
        assert tracking.track_multi_angles(torch.zeros(4, 2), torch.ones(4, 2, dtype=torch.bool), 3,
                                           device="cpu")[1].shape == (4, 3)
        assert tracking.MultiDoaTracker(3).update(np.zeros(2))[1].shape == (3,)
        assert tracking.DoaTracker().update(0.1) == 0.1
        assert next(audio.SyntheticAudioSource(geo, tt, np.sin(tt), 0.3).frames(0.01)).shape == (480, 7)
        assert callable(flac.read_flac)
        from scipy.io import wavfile
        wavfile.write("tone.wav", 48_000, (0.5 * np.sin(2 * np.pi * 1750 * np.arange(6000) / 48_000)
                                           * 32767).astype(np.int16))
        assert localize.main(["tone.wav", "--model", "srp", "--band", "1400", "2100", "--simulate-doa", "0.7",
                              "--frame", "0.125", "--grid", "33", "--device", "cpu"]) == 0
        srv = server.LocalizationServer(demo, max_streams=2, sources=2, track=True)
        srv.close()
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m] is not None)
        assert not any(m.startswith("haghighatshoarmuir2024_tpu.") or m == "haghighatshoarmuir2024_tpu"
                       for m in sys.modules)
        print(float(doa[0]))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert abs(float(proc.stdout.split()[-1]) - 1.0) < np.deg2rad(5.0)
