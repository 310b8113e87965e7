"""The classical families of the PyTorch port against the JAX package, on CPU
tensors: the array geometries, the synthesis model (``signal_from_template``
with either delay sign and a DoA trajectory, ``received_signal``),
``iir_filter``'s three methods, ``generalized_top_eigvec``, the Hilbert
``Beamformer``, ``MUSIC`` and ``SRPPHAT``, and every ``ValueError`` the JAX
package raises.

Inputs are made by numpy from seeds.  The JAX side runs under
``jax.enable_x64(False)`` where the port computes in float32, so that both
compute in the production dtype; the synthesis and the eigenvector pencils
run in float64 on both sides.  Tolerances:

- geometry: positions equal, delays within 1e-12 s (float64);
- synthesis, noise-free: 1e-12 (float64); the noisy residual's standard
  deviation within 3 % of ``rms / sqrt(snr)`` (33 600 samples: the sample
  standard deviation's own spread is about 0.4 %);
- ``iir_filter``: on a low-Q bandpass (order 2, 3-9 kHz) the port within
  5e-6 of JAX relative to the output's peak, in float32; on the flagship's
  high-Q bandpass (order 2, 1600-1900 Hz: poles near the unit circle,
  rounding amplified about a thousandfold in float32) the port no further
  from scipy's float64 ``lfilter`` than twice JAX is;
- eigenvectors up to a unit phase: ``|v_jaxᴴ v_port| ≥ 1 - 1e-5`` per
  column (float32 designs), 1 - 1e-9 for the float64 pencils;
- covariances within 1e-5 of JAX relative to their peak; the beamformer's
  apply power within 1e-3 relative to its peak (the same high-Q bandpass),
  argmax equal;
- MUSIC's Bartlett and noise-subspace spectra within 1e-4 relative to their
  peak, argmax equal; its dominant bins equal to a float64 numpy selection
  where their power margin is above 1e-3;
- SRP-PHAT's power (bounded by 1) within 5e-4 absolute, argmax equal.
"""
import numpy as np
import pytest
import scipy.linalg
from scipy.signal import lfilter

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.beamformer import Beamformer as JaxBeamformer
from haghighatshoarmuir2024_tpu.models.music import MUSIC as JaxMUSIC
from haghighatshoarmuir2024_tpu.models.srp_phat import SRPPHAT as JaxSRPPHAT
from haghighatshoarmuir2024_tpu.ops import iir as jax_iir
from haghighatshoarmuir2024_tpu.ops import interp as jax_interp
from haghighatshoarmuir2024_tpu.ops.linalg import generalized_top_eigvec as jax_gtev

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.config import BeamformerConfig, MUSICConfig
from haghighatshoarmuir2024_tpu_torch.models.beamformer import Beamformer
from haghighatshoarmuir2024_tpu_torch.models.music import MUSIC
from haghighatshoarmuir2024_tpu_torch.models.srp_phat import SRPPHAT
from haghighatshoarmuir2024_tpu_torch.ops import interp
from haghighatshoarmuir2024_tpu_torch.ops.filterbank import ButterworthFilterbank
from haghighatshoarmuir2024_tpu_torch.ops.iir import butter_bandpass, iir_filter
from haghighatshoarmuir2024_tpu_torch.ops.linalg import generalized_top_eigvec

FS = 48_000
GRID = np.linspace(-np.pi, np.pi, 17)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_persistent_cache():
    """Build the JAX models without seeding the committed XLA executables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        yield


def geometries():
    return [
        ("CenterCircularArray", lambda pkg: pkg.CenterCircularArray(radius=4.5e-2, num_mic=7)),
        ("CircularArray", lambda pkg: pkg.geometry.CircularArray(radius=4e-2, num_mic=6)),
        ("CircularArray/open", lambda pkg: pkg.geometry.CircularArray(radius=4e-2, num_mic=6, endpoint=False)),
        ("LinearArray", lambda pkg: pkg.geometry.LinearArray(spacing=2e-2, num_mic=5)),
        ("Random2DArray/seed", lambda pkg: pkg.geometry.Random2DArray(radius=5e-2, num_mic=7, seed=3)),
        ("Random2DArray/rng", lambda pkg: pkg.geometry.Random2DArray(
            radius=5e-2, num_mic=7, rng=np.random.RandomState(4))),
    ]


@pytest.mark.parametrize("name,make", geometries())
def test_torch_geometry_matches_jax(name, make):
    jg, tg = make(jpkg), make(tpkg)
    np.testing.assert_array_equal(jg.r_vec, tg.r_vec)
    np.testing.assert_array_equal(jg.theta_vec, tg.theta_vec)
    theta = np.random.default_rng(0).uniform(-np.pi, np.pi, 11)
    want = np.asarray(jg.delays(jnp.asarray(theta), normalized=False))
    np.testing.assert_allclose(tg.delays(torch.as_tensor(theta)).numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tg.delays_np(theta), jg.delays_np(theta))


def test_torch_geometry_rejects_negative_radius():
    with pytest.raises(ValueError, match="positive"):
        tpkg.ArrayGeometry(r_vec=[0.1, -0.1], theta_vec=[0.0, 1.0])


def template(T=2400, seed=0):
    t = np.arange(T) / FS
    rng = np.random.default_rng(seed)
    sig = np.sin(2 * np.pi * 1750 * t) + 0.3 * np.sin(2 * np.pi * 900 * t + rng.uniform(0, 6))
    return t, sig


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("trajectory", [False, True])
def test_torch_signal_from_template_matches_jax(sign, trajectory):
    t, sig = template()
    geo_j, geo_t = jpkg.CenterCircularArray(4.5e-2, 7), tpkg.CenterCircularArray(4.5e-2, 7)
    doa = np.linspace(-2.0, 2.5, t.size) if trajectory else 0.7
    want = np.asarray(jax_interp.signal_from_template(geo_j, t, sig, doa, fs=FS, delay_sign=sign))
    got = interp.signal_from_template(geo_t, torch.as_tensor(t), torch.as_tensor(sig), doa, fs=FS,
                                      delay_sign=sign)
    assert got.shape == (t.size, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("trajectory", [False, True])
def test_torch_received_signal_matches_jax(trajectory):
    t, sig = template()
    geo_j, geo_t = jpkg.CenterCircularArray(4.5e-2, 7), tpkg.CenterCircularArray(4.5e-2, 7)
    doa = np.linspace(1.0, -1.0, t.size) if trajectory else -1.3
    want = np.asarray(jax_interp.received_signal(geo_j, t, sig, doa, snr_db=None, fs=FS))
    got = interp.received_signal(geo_t, torch.as_tensor(t), torch.as_tensor(sig), doa, snr_db=None, fs=FS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_torch_received_signal_noise_level():
    """The AWGN's sigma is rms(sig)/sqrt(snr): the residual's standard
    deviation at 6 dB over 4800 x 7 samples, within 3 %."""
    t, sig = template(T=4800)
    geo = tpkg.CenterCircularArray(4.5e-2, 7)
    args = (geo, torch.as_tensor(t), torch.as_tensor(sig), 0.4)
    clean = interp.received_signal(*args, fs=FS)
    noisy = interp.received_signal(*args, snr_db=6.0, generator=torch.Generator().manual_seed(5), fs=FS)
    want = float(torch.sqrt((clean**2).mean())) / np.sqrt(10 ** 0.6)
    assert abs(float((noisy - clean).std()) / want - 1.0) < 0.03
    with pytest.raises(ValueError, match="generator"):
        interp.received_signal(*args, snr_db=6.0, fs=FS)


def filter_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3000, 3)).astype(np.float32)
    xc = (rng.standard_normal((3000, 3)) + 1j * rng.standard_normal((3000, 3))).astype(np.complex64)
    return {"real": x, "complex": xc}


def jax_filter(b, a, x, method, **kw):
    with jax.enable_x64(False):
        return np.asarray(jax_iir.iir_filter(b, a, jnp.asarray(x), axis=0, method=method, **kw))


@pytest.mark.parametrize("method", ["scan", "parallel", "blocked"])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_torch_iir_filter_matches_jax(method, kind):
    x = filter_inputs()[kind]
    # a low-Q bandpass: the methods agree to float32 rounding
    b, a = butter_bandpass(2, (3000, 9000), FS)
    want = jax_filter(b, a, x, method)
    got = iir_filter(b, a, torch.as_tensor(x), axis=0, method=method).numpy()
    assert got.dtype == x.dtype
    assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()
    # the flagship's high-Q bandpass: as close to float64 as JAX comes
    b, a = butter_bandpass(2, (1600, 1900), FS)
    ref = lfilter(b, a, x.astype(np.complex128 if kind == "complex" else np.float64), axis=0)
    jerr = np.abs(jax_filter(b, a, x, method) - ref).max()
    perr = np.abs(iir_filter(b, a, torch.as_tensor(x), axis=0, method=method).numpy() - ref).max()
    assert perr <= 2 * jerr + 1e-6 * np.abs(ref).max(), (perr, jerr)


@pytest.mark.parametrize("method", ["scan", "blocked"])
def test_torch_iir_filter_carries_state_and_axis(method):
    """zi/return_state over two chunks equal one pass (T a multiple of the
    block for "blocked"), and ``axis`` moves the time axis."""
    x = filter_inputs(1)["real"][:2048]
    b, a = butter_bandpass(2, (3000, 9000), FS)
    xt = torch.as_tensor(x)
    whole = iir_filter(b, a, xt, method=method)
    y1, s1 = iir_filter(b, a, xt[:1024], method=method, return_state=True)
    y2, _ = iir_filter(b, a, xt[1024:], method=method, zi=s1, return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), whole.numpy(), rtol=0,
                               atol=5e-6 * float(whole.abs().max()))
    jy, js = jax_iir.iir_filter(b, a, jnp.asarray(x[:1024]), method=method, return_state=True)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), rtol=0, atol=1e-5 * float(np.abs(js).max()))
    moved = iir_filter(b, a, xt.T.contiguous(), axis=1, method=method)
    np.testing.assert_array_equal(moved.T.numpy(), whole.numpy())


def test_torch_iir_filter_blocked_sizes_and_fir():
    x = filter_inputs(2)["real"]
    b, a = butter_bandpass(2, (3000, 9000), FS)
    want = jax_filter(b, a, x, "blocked", sb=16)
    got = iir_filter(b, a, torch.as_tensor(x), method="blocked", sb=16).numpy()
    assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()
    taps = np.random.default_rng(3).standard_normal(9)
    np.testing.assert_allclose(iir_filter(taps, [2.0], torch.as_tensor(x)).numpy(),
                               lfilter(taps, [2.0], x.astype(np.float64), axis=0), rtol=0, atol=1e-5)


def test_torch_iir_filter_errors():
    b, a = butter_bandpass(2, (3000, 9000), FS)
    x = torch.zeros((100, 2))
    with pytest.raises(ValueError, match="sb"):
        iir_filter(b, a, x, method="scan", sb=16)
    with pytest.raises(ValueError, match="sb"):
        iir_filter(b, a, x, method="parallel", sb=16)
    with pytest.raises(ValueError, match="zi/return_state"):
        iir_filter(b, a, x, method="parallel", return_state=True)
    with pytest.raises(ValueError, match="multiple of the block"):
        iir_filter(b, a, x, method="blocked", return_state=True)
    with pytest.raises(ValueError, match="pure-FIR"):
        iir_filter([1.0, 0.5], [1.0], x, return_state=True)
    with pytest.raises(ValueError, match="unknown IIR method"):
        iir_filter(b, a, x, method="fft")


def test_torch_filterbank_evolve():
    x = filter_inputs(4)["real"]
    bank = ButterworthFilterbank([[1000, 3000], [3000, 6000]], order=1, fs=FS)
    out = bank.evolve(torch.as_tensor(x))
    assert out.shape == (2,) + x.shape and len(bank) == 2
    for i, (b, a) in enumerate(bank.ba_list):
        want = lfilter(b, a, x.astype(np.float64), axis=0)
        assert np.abs(out[i].numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert bank(torch.as_tensor(x[:, 0])).shape == (2, x.shape[0], 1)


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_torch_generalized_top_eigvec_matches_jax(kind):
    rng = np.random.default_rng(7)
    n, batch = 7, 6

    def draw():
        z = rng.standard_normal((batch, n, n))
        return z + 1j * rng.standard_normal((batch, n, n)) if kind == "complex" else z

    A, Bz = draw(), draw()
    C = A @ np.swapaxes(A.conj(), -1, -2) / n
    Bm = Bz @ np.swapaxes(Bz.conj(), -1, -2) / n + 0.05 * np.eye(n)
    got = generalized_top_eigvec(torch.as_tensor(C), torch.as_tensor(Bm)).numpy()
    want = np.asarray(jax.vmap(jax_gtev)(jnp.asarray(C), jnp.asarray(Bm)))
    for i in range(batch):
        _, U = scipy.linalg.eigh(C[i], Bm[i])
        ref = U[:, -1] / np.linalg.norm(U[:, -1])
        assert abs(np.vdot(want[i], got[i])) >= 1 - 1e-9
        assert abs(np.vdot(ref, got[i])) >= 1 - 1e-9
    # eps loads the diagonal
    eps = generalized_top_eigvec(torch.as_tensor(C), torch.as_tensor(Bm - 0.04 * np.eye(n)), eps=0.04).numpy()
    assert np.min(np.abs(np.einsum("gm,gm->g", got.conj(), eps))) >= 1 - 1e-9


# ------------------------------------------------------------- Beamformer
def up_to_phase(a, b):
    """min over columns of |a_gᴴ b_g| for unit columns (M, G)."""
    return float(np.min(np.abs(np.einsum("mg,mg->g", a.conj(), b))))


@pytest.fixture(scope="module")
def beamformers():
    t = np.arange(0, 0.05, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    with jax.enable_x64(False):
        jb = JaxBeamformer(jpkg.CenterCircularArray(4.5e-2, 7), 10e-3, (1600, 1900), fs=FS, design_chunk=8)
        jbf, jcov = jb.design_from_template((t, sig), GRID)
        jbfi, _ = jb.design_from_template((t, sig), GRID, interference_removal=True)
        jax_design = tuple(np.asarray(v) for v in (jbf, jcov, jbfi))
    tb = Beamformer.from_config(BeamformerConfig(design_chunk=8), tpkg.CenterCircularArray(4.5e-2, 7),
                                device="cpu")
    tbf, tcov = tb.design_from_template((t, sig), GRID)
    tbfi, _ = tb.design_from_template((t, sig), GRID, interference_removal=True)
    return jb, jax_design, tb, (tbf, tcov, tbfi), (t, sig)


def test_torch_beamformer_design_matches_jax(beamformers):
    _, (jbf, jcov, jbfi), _, (tbf, tcov, tbfi), _ = beamformers
    assert tbf.shape == (7, len(GRID)) and tcov.shape == (len(GRID), 7, 7) and tbf.dtype == torch.complex64
    assert np.abs(tcov.numpy() - jcov).max() <= 1e-5 * np.abs(jcov).max()
    assert up_to_phase(jbf, tbf.numpy()) >= 1 - 1e-5
    assert up_to_phase(jbfi, tbfi.numpy()) >= 1 - 1e-5
    np.testing.assert_allclose(np.linalg.norm(tbfi.numpy(), axis=0), 1.0, rtol=1e-5)


def test_torch_beamformer_apply_matches_jax(beamformers):
    jb, (jbf, _, _), tb, (tbf, _, _), (t, sig) = beamformers
    x = np.random.default_rng(1).standard_normal((2400, 7)).astype(np.float32)
    with jax.enable_x64(False):
        jpow = (np.abs(np.asarray(jb.apply_to_signal(jbf, x))) ** 2).mean(axis=0)
        jtpl = (np.abs(np.asarray(jb.apply_to_template(jbf, (t, sig, 0.7), snr_db=None))) ** 2).mean(axis=0)
    out = tb.apply_to_signal(tbf, x)
    assert out.shape == (2400, len(GRID)) and out.dtype == torch.complex64
    tpow = (out.abs() ** 2).mean(dim=0).numpy()
    assert np.abs(tpow - jpow).max() <= 1e-3 * jpow.max() and tpow.argmax() == jpow.argmax()
    batch = tb.apply_to_signal(tbf, np.stack([x[::-1].copy(), x]))
    np.testing.assert_array_equal(batch[1].numpy(), out.numpy())
    clean = tb.apply_to_template(tbf, (t, sig, 0.7), snr_db=None)
    ttpl = (clean.abs() ** 2).mean(dim=0).numpy()
    assert np.abs(ttpl - jtpl).max() <= 1e-3 * jtpl.max() and ttpl.argmax() == jtpl.argmax()
    # the noisy harness runs from an explicit generator
    noisy = tb.apply_to_template(tbf, (t, sig, 0.7), snr_db=10.0, generator=torch.Generator().manual_seed(0))
    assert noisy.shape == clean.shape and bool(torch.isfinite(noisy).all())


def test_torch_beamformer_errors(beamformers):
    _, _, tb, (tbf, _, _), _ = beamformers
    geo = tpkg.CenterCircularArray(4.5e-2, 7)
    with pytest.raises(ValueError, match="freq_range"):
        Beamformer(geo, 10e-3, (1900, 1600), fs=FS, device="cpu")
    with pytest.raises(ValueError, match="number of channels"):
        tb.apply_to_signal(tbf, np.zeros((100, 6), np.float32))


# ------------------------------------------------------------------ MUSIC
def music_mix(doas, T=6000, seed=2):
    """Tones from ``doas`` [(doa, freq)], minus-convention synthesis, plus
    0.1 white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    geo = jpkg.CenterCircularArray(4.5e-2, 7)
    x = sum(np.asarray(jax_interp.signal_from_template(geo, t, np.sin(2 * np.pi * f * t + rng.uniform(0, 6)), d,
                                                       fs=FS, delay_sign=-1)) for d, f in doas)
    return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def musics():
    geo = dict(freq_range=(1400, 2100), doa_list=np.linspace(-np.pi, np.pi, 33), frame_duration=0.125, fs=FS)
    return (JaxMUSIC(jpkg.CenterCircularArray(4.5e-2, 7), **geo),
            MUSIC(tpkg.CenterCircularArray(4.5e-2, 7), **geo, device="cpu"))


def test_torch_music_bins_match_jax(musics):
    jm, tm = musics
    for nfft in (512, 2048, 1001):
        jb, jf = jm._bins(nfft)
        tb, tf = tm._bins(nfft)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tf, jf)


def dominant_bins_f64(music, x, K, nfft):
    """The dominant bins in float64 numpy: order-1 lfilter, framed FFT, the
    in-band bins, the K of most mean power; also the power margin between
    the K-th and the next bin, relative to the K-th."""
    b, a = music.filterbank.ba_list[0]
    y = lfilter(b, a, x.astype(np.float64), axis=0)
    F = max(1, x.shape[0] // nfft)
    adj = np.zeros((F * nfft, x.shape[1]))
    adj[: min(x.shape[0], F * nfft)] = y[: F * nfft]
    spec = np.fft.fft(adj.T.reshape(x.shape[1], F, nfft), axis=-1)[..., music._bins(nfft)[0]]
    power = (np.abs(spec) ** 2).mean(axis=(0, 1))
    order = np.argsort(power, kind="stable")
    return np.sort(order[-K:]), (power[order[-K]] - power[order[-K - 1]]) / power[order[-K]]


@pytest.mark.parametrize("sources", [[(0.7, 1750)], [(1.0, 1650), (-1.0, 1850)]])
@pytest.mark.parametrize("num_sources", [0, 1, 2])
def test_torch_music_spectra_match_jax(musics, sources, num_sources):
    jm, tm = musics
    x = music_mix(sources)
    bins, margin = dominant_bins_f64(tm, x, 2, 512)
    assert margin > 1e-3, margin  # the selection is decided well above float32 rounding
    sel = tm._dominant(torch.as_tensor(x)[None], 2, 512)[0]
    np.testing.assert_array_equal(np.sort(sel.numpy()), bins)
    with jax.enable_x64(False):
        want = np.asarray(jm.beamforming(x, 2, 512, num_sources=num_sources))
    got = tm.beamforming(x, 2, 512, num_sources=num_sources).numpy()
    assert got.shape == want.shape == (33,)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() and got.argmax() == want.argmax()
    batch = tm.beamforming(np.stack([music_mix([(-2.0, 1700)], seed=9), x]), 2, 512, num_sources=num_sources)
    np.testing.assert_allclose(batch[1].numpy(), got, rtol=1e-6, atol=0)


def test_torch_music_frames_and_tail_match_jax(musics):
    """Two full frames (6000 samples, 1200 of overlap) and the tail rule: a
    last frame of 4300 samples, more than half a frame."""
    jm, tm = musics
    x = np.concatenate([music_mix([(0.7, 1750)], T=9600, seed=4), music_mix([(0.7, 1750)], T=4300, seed=5)])
    with jax.enable_x64(False):
        want = np.asarray(jm.apply_to_signal(x, 2, 0.025, 512))
    got = tm.apply_to_signal(x, 2, 0.025, 512).numpy()
    assert got.shape == want.shape == (3, 33)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))
    # no tail: 1000 samples past the frames are less than half a frame
    assert tm.apply_to_signal(x[:7000], 2, 0.025, 512).shape == (1, 33)
    assert tm.apply_to_signal(x[:2000], 2, 0.025, 512).shape == (0, 33)


def test_torch_music_template_and_config(musics):
    jm, _ = musics
    tm = MUSIC.from_config(MUSICConfig(freq_range=(1400, 2100), frame_duration=0.125),
                           tpkg.CenterCircularArray(4.5e-2, 7), np.linspace(-np.pi, np.pi, 33), device="cpu")
    t = np.arange(0, 0.25, 1 / FS)
    tpl = (t, np.sin(2 * np.pi * 1750 * t), -1.1)
    with jax.enable_x64(False):
        want = np.asarray(jm.apply_to_template(tpl, 2, 0.0, 512, snr_db=None))
    got = tm.apply_to_template(tpl, 2, 0.0, 512, snr_db=None).numpy()
    assert got.shape == want.shape == (2, 33)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))
    resp = tm.array_response([1600.0, 1800.0])
    with jax.enable_x64(False):
        jresp = np.asarray(jm.array_response(jnp.asarray([1600.0, 1800.0], jnp.float32)))
    assert resp.shape == (2, 7, 33) and np.abs(resp.numpy() - jresp).max() < 1e-5


def test_torch_music_errors(musics):
    _, tm = musics
    x = np.zeros((6000, 7), np.float32)
    with pytest.raises(ValueError, match="frequency range"):
        MUSIC(tpkg.CenterCircularArray(4.5e-2, 7), (2100, 1400), GRID, device="cpu")
    with pytest.raises(ValueError, match="quite large"):
        tm.beamforming(x, 8, 512)
    with pytest.raises(ValueError, match="T x num_mic"):
        tm.beamforming(x[:, :6], 2, 512)
    for ns in (-1, 7):
        with pytest.raises(ValueError, match="num_sources"):
            tm.beamforming(x, 2, 512, num_sources=ns)
    with pytest.raises(ValueError, match="number of channels"):
        tm.apply_to_signal(x[:, :6], 2, 0.0, 512)
    with pytest.raises(ValueError, match="overlap"):
        tm.apply_to_signal(x, 2, 0.125, 512)


# --------------------------------------------------------------- SRP-PHAT
@pytest.fixture(scope="module")
def srps():
    kw = dict(freq_range=(1400, 2100), doa_list=np.linspace(-np.pi, np.pi, 33), fs=FS, frame_duration=0.125)
    return (JaxSRPPHAT(jpkg.CenterCircularArray(4.5e-2, 7), **kw),
            SRPPHAT(tpkg.CenterCircularArray(4.5e-2, 7), **kw, device="cpu"))


def test_torch_srp_matches_jax(srps):
    js, ts = srps
    x1, x2 = music_mix([(0.7, 1750)]), music_mix([(-2.2, 1800)], seed=6)
    with jax.enable_x64(False):
        want1 = np.asarray(js.apply_to_signal(x1))
        wantb = np.asarray(js.apply_to_signal(np.stack([x1, x2])))
        west = np.asarray(js.estimate(np.stack([x1, x2])))
    got1 = ts.apply_to_signal(x1).numpy()
    gotb = ts.apply_to_signal(np.stack([x1, x2])).numpy()
    assert got1.shape == (33,) and gotb.shape == (2, 33)
    np.testing.assert_allclose(got1, want1, rtol=0, atol=5e-4)
    np.testing.assert_allclose(gotb, wantb, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(gotb.argmax(axis=1), wantb.argmax(axis=1))
    np.testing.assert_allclose(ts.estimate(np.stack([x1, x2])).numpy(), west, rtol=0, atol=1e-6)
    t = np.arange(0, 0.125, 1 / FS)
    tpl = (t, np.sin(2 * np.pi * 1750 * t), 0.9)
    with jax.enable_x64(False):
        wtpl = np.asarray(js.apply_to_template(tpl, snr_db=10.0, key=None))
    gtpl = ts.apply_to_template(tpl, snr_db=10.0).numpy()
    np.testing.assert_allclose(gtpl, wtpl, rtol=0, atol=5e-4)
    noisy = ts.apply_to_template(tpl, snr_db=10.0, generator=torch.Generator().manual_seed(1))
    assert noisy.shape == (33,) and bool(torch.isfinite(noisy).all())


def test_torch_srp_errors():
    geo = tpkg.CenterCircularArray(4.5e-2, 7)
    with pytest.raises(ValueError, match="increasing"):
        SRPPHAT(geo, (2000, 1000), GRID, device="cpu")
    with pytest.raises(ValueError, match="no FFT bins"):
        SRPPHAT(geo, (1100.0, 1200.0), GRID, frame_duration=0.001, device="cpu")
