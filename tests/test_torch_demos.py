"""The port's live demos (``haghighatshoarmuir2024_tpu_torch/demos/``) against
the JAX package's on the CPU, at ``tests/test_io_demos.py``'s sizes.

Both packages' demos get the same numpy frames: a port ``AudioSource`` over
the JAX source's float32 signal (the two packages synthesize a template in
different precisions, so their own sources would compare syntheses, not
demos).  The JAX demos run under ``jax.enable_x64(False)``, float32 as the
port computes.  The Hilbert and SNN demos run on JAX's designs handed to
the port (a design's unit phase is each LAPACK's choice), the Xylo demo on
JAX's model carried over by ``Demo.save`` → ``Demo.load``.

Tolerances: the DoAs are equal, degree for degree; a demo whose DoA differs
passes only where the port's estimator score has a relative top-two gap
below 1e-5 (a near tie, printed by the assertion).  The Xylo demo's DoAs
and its silent frame's NaN are equal with no exception.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from haghighatshoarmuir2024_tpu import CenterCircularArray as JaxCCA  # noqa: E402
from haghighatshoarmuir2024_tpu.demos import localization_demo as jax_hd  # noqa: E402
from haghighatshoarmuir2024_tpu.demos import localization_demo_music as jax_md  # noqa: E402
from haghighatshoarmuir2024_tpu.demos import localization_demo_snn as jax_nd  # noqa: E402
from haghighatshoarmuir2024_tpu.demos import localization_demo_srp as jax_rd  # noqa: E402
from haghighatshoarmuir2024_tpu.demos import localization_demo_xylo as jax_xd  # noqa: E402
from haghighatshoarmuir2024_tpu.io import FileAudioSource as JaxFileAudioSource  # noqa: E402
from haghighatshoarmuir2024_tpu.io import SyntheticAudioSource as JaxSyntheticAudioSource  # noqa: E402
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxXyloDemo  # noqa: E402

from haghighatshoarmuir2024_tpu_torch import CenterCircularArray  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.demos import localization_demo as hd  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.demos import localization_demo_music as md  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.demos import localization_demo_snn as nd  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.demos import localization_demo_srp as rd  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.demos import localization_demo_xylo as xd  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.io import AudioSource, FileAudioSource  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo as XyloDemo  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.ops.fir import moving_average_full  # noqa: E402

FS = 48_000
TIE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The per-sample scans are long Python loops of small tensor ops: under
    the lane's parallel workers intra-op threads only contend for cores."""
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


def jax_source(doa, n_frames=3, snr_db=20.0, frame=0.25, delay_sign=1):
    """``tests/test_io_demos.py``'s tone source, JAX's synthesis (float32)."""
    t = np.arange(0, frame * (n_frames + 1), 1 / FS)
    return JaxSyntheticAudioSource(JaxCCA(radius=4.5e-2, num_mic=7), t, np.sin(2 * np.pi * 1750.0 * t), doa,
                                   snr_db=snr_db, fs=FS, delay_sign=delay_sign)


def same_frames(src) -> AudioSource:
    """A port source over the JAX source's numpy signal."""
    port = AudioSource()
    port._sig = np.asarray(src._sig)
    return port


def score(demo, frame):
    """The port demo's estimator score (G',) of one frame: the band power,
    or the spectrum as the peak estimator smooths it."""
    if isinstance(demo, (hd.Demo, nd.Demo)):
        return demo.power(frame)
    aps = (demo.music.beamforming(torch.as_tensor(frame), demo.num_active_freq, demo.num_fft_bin)
           if isinstance(demo, md.Demo) else demo.srp.apply_to_signal(torch.as_tensor(frame)))
    win = max(1, 2 * ((len(demo.doa_list) // 32) // 2) + 1)
    return moving_average_full(aps, win) if win > 1 else aps


def assert_same_doas(port_demo, port_est, jax_est, frames):
    """Equal DoAs, or a near tie of the port's score (module docstring)."""
    assert len(port_est) == len(jax_est)
    for k, (p, j) in enumerate(zip(port_est, jax_est)):
        if p != j:
            top2 = score(port_demo, frames[k]).topk(2).values
            gap = float((top2[0] - top2[1]) / top2[0].abs())
            assert gap < TIE_RTOL, (k, p, j, gap)


def folded_deg(est_deg, doa):
    return np.rad2deg(np.arcsin(np.abs(np.sin(np.deg2rad(np.asarray(est_deg)) - doa))))


GEO = CenterCircularArray(radius=4.5e-2, num_mic=7)

# (name, port module, JAX module, doa, frames, the Demo's arguments after the geometry, the JAX test's gate
# (tests/test_io_demos.py), the synthesis convention)
CLASSICAL = [
    ("hilbert", hd, jax_hd, 0.7, 2, dict(freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 113)),
     6.0, 1),
    ("music", md, jax_md, -1.2, 2, dict(freq_range=[1200.0, 2000.0], doa_list=np.linspace(-np.pi, np.pi, 113),
                                        num_active_freq=5, num_fft_bin=2048), 6.0, 1),
    ("snn", nd, jax_nd, 0.7, 1, dict(freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 65)), 8.0, 1),
    ("srp", rd, jax_rd, 0.7, 2, dict(freq_range=[1400, 2100], doa_list=np.linspace(-np.pi, np.pi, 129)), 5.0, 1),
]


@pytest.mark.parametrize("case", CLASSICAL, ids=[c[0] for c in CLASSICAL])
def test_torch_demo_matches_jax(case):
    """The same frames through JAX's demo and the port's: equal DoAs (the
    Hilbert and SNN demos on JAX's design), within the JAX test's folded
    error, pushed to the headless visualizer in degrees."""
    name, mod, jax_mod, doa, n, kw, gate, sign = case
    src = jax_source(doa, delay_sign=sign)
    with jax.enable_x64(False):
        jd = jax_mod.Demo(JaxCCA(radius=4.5e-2, num_mic=7), source=src, **kw)
        jax_est = jd.run(num_frames=n)
    pd = mod.Demo(GEO, source=same_frames(src), device="cpu", **kw)
    if name in ("hilbert", "snn"):
        pd.bf_mats = [torch.as_tensor(np.array(m)) for m in jd.bf_mats]
    port_est = pd.run(num_frames=n)
    assert_same_doas(pd, port_est, jax_est, list(src.frames(0.25)))
    assert [h[1][0] for h in pd.vz.history] == port_est
    assert folded_deg(port_est, doa).max() < gate
    assert set(pd.timer.report()) == {"source", "compute", "visualize"}
    assert pd.timer.counts["compute"] == n


def test_torch_music_demo_periodic_ml_matches_jax():
    """The MUSIC demo's other estimator on one spectrum: the angle of the
    spectrum-weighted mean steering, float64 on both sides (within 1e-12
    rad)."""
    grid = np.linspace(-np.pi, np.pi, 113)
    aps = np.random.default_rng(0).random(113).astype(np.float32)
    jd = jax_md.Demo(JaxCCA(radius=4.5e-2, num_mic=7), [1200.0, 2000.0], grid)
    pd = md.Demo(GEO, [1200.0, 2000.0], grid, device="cpu")
    assert abs(pd.estimate_doa(torch.as_tensor(aps), "periodic_ml") - jd.estimate_doa(aps, "periodic_ml")) < 1e-12
    assert pd.estimate_doa(torch.as_tensor(aps)) == jd.estimate_doa(aps)
    with pytest.raises(ValueError):
        pd.estimate_doa(torch.as_tensor(aps), "median")


@pytest.fixture(scope="module")
def xylo_pair(tmp_path_factory):
    """JAX's small Xylo model (``test_xylo_demo_activity_detection``'s) and
    the port's ``Demo.load`` of its checkpoint."""
    jd = JaxXyloDemo(geometry=JaxCCA(radius=4.5e-2, num_mic=7), freq_bands=[[1600, 1900]],
                     doa_list=np.linspace(-np.pi, np.pi, 65), recording_duration=0.1, kernel_duration=5e-3,
                     bipolar_spikes=True, fs=FS, use_cache=False)
    path = str(tmp_path_factory.mktemp("xylo") / "model.npz")
    jd.save(path)
    return jd, XyloDemo.load(path, device="cpu")


def test_torch_xylo_demo_matches_jax(xylo_pair):
    """The Xylo demo on JAX's model: a silent frame is NaN in both with no
    device work, and the same frames give equal DoAs."""
    jx, px = xylo_pair
    jd, pd = jax_xd.Demo(jx), xd.Demo(px)
    silent = np.zeros((4800, 7), np.float32)
    assert np.isnan(jd.process_frame(silent)) and np.isnan(pd.process_frame(silent))
    src = jax_source(0.7, n_frames=2, frame=0.1)
    jd.source, pd.source = src, same_frames(src)
    jax_est, port_est = jd.run(num_frames=2), pd.run(num_frames=2)
    assert port_est == jax_est and np.all(np.isfinite(port_est))


def test_torch_xylo_demo_gate_and_method(xylo_pair):
    """The activity gate is the RMS of the float64 frame against
    ``rel_threshold · full_scale``; ``method`` reaches ``Demo.forward``."""
    _, px = xylo_pair
    frame = np.full((4800, 7), 1e-3, np.float32)  # RMS 1e-3
    assert np.isnan(xd.Demo(px, rel_threshold=2e-3).process_frame(frame))
    assert np.isnan(xd.Demo(px, rel_threshold=1e-4, full_scale=20.0).process_frame(frame))
    assert np.isfinite(xd.Demo(px, rel_threshold=5e-4).process_frame(frame))
    with pytest.raises(ValueError):
        xd.Demo(px, method="median").process_frame(frame)


def test_torch_demo_wav_roundtrip(tmp_path):
    """A 16-bit 7-channel wav of JAX's frames, read by each package's
    ``FileAudioSource``, through each package's SRP-PHAT demo: equal DoAs,
    and the port's run equal to its own frames processed one by one."""
    src = jax_source(0.7, delay_sign=-1)
    path = tmp_path / "demo.wav"
    sig = np.asarray(src._sig)
    wavfile.write(path, FS, np.round(sig * (0.9 / np.abs(sig).max()) * 32767).astype(np.int16))
    grid = np.linspace(-np.pi, np.pi, 129)
    with jax.enable_x64(False):
        jax_est = jax_rd.Demo(JaxCCA(radius=4.5e-2, num_mic=7), [1400, 2100], grid,
                              source=JaxFileAudioSource(str(path))).run(num_frames=3)
    pd = rd.Demo(GEO, [1400, 2100], grid, source=FileAudioSource(str(path)), device="cpu")
    port_est = pd.run(num_frames=3)
    frames = list(FileAudioSource(str(path)).frames(0.25))
    assert_same_doas(pd, port_est, jax_est, frames)
    assert port_est == [float(np.rad2deg(pd.process_frame(f))) for f in frames[:3]]
    assert folded_deg(port_est, 0.7).max() < 5.0


def test_torch_demo_run_demo_on_cpu():
    """``run_demo`` takes ``device="cpu"`` (the SRP-PHAT demo at its
    reference defaults, 2 frames; within its JAX test's 5 deg), and every
    demo module's ``run_demo`` has JAX's arguments plus ``device``."""
    est = rd.run_demo(num_frames=2, device="cpu")
    assert len(est) == 2 and folded_deg(est, 0.7).max() < 5.0
    for mod, jax_mod in ((hd, jax_hd), (nd, jax_nd), (md, jax_md), (rd, jax_rd), (xd, jax_xd)):
        jax_sig = inspect.signature(jax_mod.run_demo).parameters
        sig = inspect.signature(mod.run_demo).parameters
        assert list(sig) == list(jax_sig) + ["device"]
        assert all(sig[k].default == jax_sig[k].default for k in jax_sig)


def test_torch_music_run_demo_refuses_100_bins_as_jax():
    """The reference's MUSIC demo defaults ask for 100 active bins of a
    2048-bin FFT in a band of 34: ``MUSIC.beamforming`` refuses them in both
    packages with the same error."""
    with pytest.raises(ValueError) as jax_err:
        jax_md.run_demo(num_frames=1)
    with pytest.raises(ValueError) as port_err:
        md.run_demo(num_frames=1, device="cpu")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("mod", [hd, nd, md, rd, xd], ids=["hilbert", "snn", "music", "srp", "xylo"])
def test_torch_demo_refuses_without_cuda(monkeypatch, mod):
    """With no GPU the default device raises; no demo falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.reference_demo(num_frames=1)


def test_torch_demo_needs_a_source():
    pd = md.Demo(GEO, [1200.0, 2000.0], np.linspace(-np.pi, np.pi, 33), device="cpu")
    with pytest.raises(ValueError, match="no audio source"):
        pd.run(num_frames=1)
