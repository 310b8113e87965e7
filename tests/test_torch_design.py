"""The design path of the PyTorch port against the JAX package on the CPU:
the LIF impulse response and filter, the unbounded plateau-midpoint maxima
and ``find_peaks_mask``, the RZCC encoder, the design's linear algebra and
``SNNBeamformer.design_from_template`` itself.

Tolerances and why:

- integer and mask outputs are bit-exact; the RZCC inputs are integers or
  multiples of 1/64, so that both cumsums are exact whatever their order;
- ``lif_filter``: the port's blocked-Toeplitz float32 matmul against JAX's
  FFT convolution, 1e-6 of the largest value;
- eigenvectors: 1e-5, up to the unit phase (complex) or sign that eigh
  leaves free;
- the design: per-column |<ref, got>| >= 1 - 1e-5, the reference built in
  float32 (the tests enable x64, and the JAX ``design_from_template`` would
  then run in float64) by calling ``_design_covariances`` and
  ``_bf_from_covs`` with float32 inputs, as the TPU runs them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.snn_beamformer import (
    SNNBeamformer as JaxSNNBeamformer,
    _bf_from_covs,
    _design_covariances,
)
from haghighatshoarmuir2024_tpu.ops import linalg as jax_linalg
from haghighatshoarmuir2024_tpu.ops.interp import resample_to_fs as jax_resample
from haghighatshoarmuir2024_tpu.ops.lif import lif_filter as jax_lif_filter
from haghighatshoarmuir2024_tpu.ops.lif import lif_impulse_response as jax_lif_ir
from haghighatshoarmuir2024_tpu.ops.peaks import find_peaks_mask as jax_find_peaks
from haghighatshoarmuir2024_tpu.ops.peaks import local_maxima_mask as jax_local_maxima
from haghighatshoarmuir2024_tpu.ops.spikes import rzcc_encode as jax_rzcc

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.snn_beamformer import SNNBeamformer
from haghighatshoarmuir2024_tpu_torch.ops import linalg
from haghighatshoarmuir2024_tpu_torch.ops.interp import resample_to_fs
from haghighatshoarmuir2024_tpu_torch.ops.lif import lif_filter, lif_impulse_response
from haghighatshoarmuir2024_tpu_torch.ops.peaks import find_peaks_mask, local_maxima_mask
from haghighatshoarmuir2024_tpu_torch.ops.spikes import ZeroCrossingSpikeEncoder, rzcc_encode

FS = 48_000


@pytest.fixture(autouse=True, scope="module")
def _no_jax_persistent_cache():
    """Build JAX beamformers without seeding the committed XLA executables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        yield


# ------------------------------------------------------------------ LIF
@pytest.mark.parametrize("taus,max_len", [((1 / (2 * np.pi * 1750),) * 2, 12_000),
                                          ((1 / (2 * np.pi * 500),) * 2, 300),
                                          ((2e-4, 5e-4), 4800)])
def test_torch_lif_impulse_response_equals_jax(taus, max_len):
    got = lif_impulse_response(*taus, FS, max_len)
    ref = jax_lif_ir(*taus, FS, max_len)
    assert got.dtype == np.float64 and got.tobytes() == ref.tobytes()


def test_torch_lif_filter_matches_jax():
    rng = np.random.default_rng(0)
    h = lif_impulse_response(*(1 / (2 * np.pi * 1750),) * 2, FS, 12_000)
    assert 30 < len(h) < 60  # about 40 taps at 1750 Hz
    spikes = np.where(rng.random((700, 3, 6)) < 0.05, rng.choice([-1.0, 1.0], (700, 3, 6)), 0.0)
    spikes = spikes.astype(np.float32)
    got = lif_filter(torch.as_tensor(spikes), h).numpy()
    ref = np.asarray(jax_lif_filter(jnp.asarray(spikes), jnp.asarray(h, jnp.float32)))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ------------------------------------------------------------------ peaks
def peak_inputs():
    rng = np.random.default_rng(1)
    walk = np.round(np.cumsum(rng.standard_normal((3, 4, 300)), axis=-1) * 2) / 2  # plateaus
    ints = rng.integers(-3, 4, size=(2, 257)).astype(np.float64)
    ints[0, :5] = 2.0  # a plateau on the left edge
    ints[1, -6:] = 1.0  # and on the right
    ints[1, 100:130] = 5.0  # a long plateau
    smooth = np.sin(np.linspace(0, 40, 501))[None] + 1e-3 * rng.standard_normal((2, 501))
    return [walk.astype(np.float32), ints.astype(np.float32), smooth.astype(np.float32),
            np.zeros((2, 50), np.float32)]


@pytest.mark.parametrize("k", range(4))
def test_torch_local_maxima_mask_bitexact(k):
    x = peak_inputs()[k]
    got = local_maxima_mask(torch.as_tensor(x)).numpy()
    ref = np.asarray(jax_local_maxima(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    if k < 3:
        assert got.any()


@pytest.mark.parametrize("distance,max_plateau", [(None, None), (1, None), (3, None), (12, None),
                                                  (25, None), (7, 8)])
def test_torch_find_peaks_mask_bitexact(distance, max_plateau):
    for x in peak_inputs()[:2]:
        got = find_peaks_mask(torch.as_tensor(x), distance, max_plateau).numpy()
        ref = np.asarray(jax_find_peaks(jnp.asarray(x), distance, max_plateau))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bipolar", [False, True])
@pytest.mark.parametrize("kind", ["integers", "dyadic"])
def test_torch_rzcc_encode_bitexact(bipolar, kind):
    rng = np.random.default_rng(2)
    if kind == "integers":  # ties and plateaus everywhere
        sig = rng.integers(-4, 5, size=(900, 6))
    else:  # a bandpassed-looking signal on a 1/64 grid
        t = np.arange(900)[:, None]
        sig = np.round(64 * np.sin(2 * np.pi * t / 27.0 + rng.random(6)) + rng.integers(-3, 4, (900, 6))) / 64
    sig = sig.astype(np.float32)
    got = rzcc_encode(torch.as_tensor(sig), 12, bipolar).numpy()
    ref = np.asarray(jax_rzcc(jnp.asarray(sig), 12, bipolar))
    assert got.dtype == np.float32 and got.shape == (900, 6)
    np.testing.assert_array_equal(got, ref)
    assert (got == 1).any() and ((got == -1).any() == bipolar)
    enc = ZeroCrossingSpikeEncoder(FS, robust_width=12, bipolar=bipolar)
    np.testing.assert_array_equal(enc(torch.as_tensor(sig)).numpy(), got)


# ------------------------------------------------------------------ linalg
def test_torch_top_eigvec_psd_up_to_phase():
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((5, 7, 7)) + 1j * rng.standard_normal((5, 7, 7))).astype(np.complex64)
    C = A @ np.conj(np.swapaxes(A, -1, -2))
    got = linalg.top_eigvec_psd(torch.as_tensor(C)).numpy()
    ref = np.asarray(jax_linalg.top_eigvec_psd(jnp.asarray(C)))
    assert np.all(np.abs(np.abs(np.sum(np.conj(ref) * got, axis=-1)) - 1) < 1e-5)
    sv = np.asarray(jax_linalg.svd_singvals_psd(jnp.asarray(C)))
    got_sv = linalg.svd_singvals_psd(torch.as_tensor(C)).numpy()
    assert np.all(np.diff(got_sv, axis=-1) <= 0)
    assert np.abs(got_sv - sv).max() <= 1e-5 * sv.max()


def dc_cases():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((4, 14, 14)).astype(np.float32)
    C = A @ np.swapaxes(A, -1, -2) + 3.0  # a dominant DC component
    tied = np.diag([3.0, 3.0, 1.0, 0.5, 0.25]).astype(np.float32)  # exactly tied top eigenvalue
    perm = tied[[2, 0, 4, 1, 3]][:, [2, 0, 4, 1, 3]]
    return [C.astype(np.float32), tied[None], perm[None]]


@pytest.mark.parametrize("k", range(3))
def test_torch_dc_removed_sing_vec_up_to_sign(k):
    C = dc_cases()[k]
    got = linalg.dc_removed_sing_vec(torch.as_tensor(C)).numpy()
    ref = np.asarray(jax_linalg.dc_removed_sing_vec(jnp.asarray(C)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert np.all(np.abs(np.abs(np.sum(ref * got, axis=-1)) - 1) < 1e-5)


def test_torch_fold_unfold_match_jax():
    rng = np.random.default_rng(5)
    C = rng.standard_normal((3, 14, 14)).astype(np.float32)
    got = linalg.fold_complex_cov(torch.as_tensor(C)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_linalg.fold_complex_cov(jnp.asarray(C))))
    u = (rng.standard_normal((3, 7)) + 1j * rng.standard_normal((3, 7))).astype(np.complex64)
    np.testing.assert_array_equal(linalg.unfold_complex_vec(torch.as_tensor(u)).numpy(),
                                  np.asarray(jax_linalg.unfold_complex_vec(jnp.asarray(u))))


# ------------------------------------------------------------------ design
def small_design_setup(bipolar):
    """33-point grid, 0.1 s, 5 ms STHT kernel, one band."""
    band = (1600.0, 1900.0)
    tau = 1 / (2 * np.pi * np.mean(band))
    kw = dict(kernel_duration=5e-3, freq_range=band, tau_vec=[tau, tau], bipolar_spikes=bipolar, fs=FS,
              design_chunk=8)
    jb = JaxSNNBeamformer(jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **kw)
    tb = SNNBeamformer(tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **kw, device="cpu")
    t = np.arange(0, 0.1, 1 / FS)
    return jb, tb, (t, np.sin(2 * np.pi * 1750 * t)), np.linspace(-np.pi, np.pi, 33)


def jax_design_f32(jb, template, doa_list):
    t, sig = jax_resample(*template, FS)
    delays = jb.geometry.delays_np(doa_list, normalized=True)
    cov = _design_covariances(
        jnp.asarray(sig, jnp.float32), jnp.asarray(t[0], jnp.float32), jnp.asarray(delays, jnp.float32),
        jnp.asarray(jb.kernel, jnp.float32), jnp.asarray(jb._neuron_ir(len(sig)), jnp.float32),
        ba=jb._ba, fs=float(FS), robust_width=jb.robust_width, bipolar=jb.bipolar_spikes, chunk=8,
    )
    assert cov.dtype == jnp.float32
    return np.asarray(_bf_from_covs(cov, jb.bipolar_spikes)).T


@pytest.mark.parametrize("bipolar", [True, False])
def test_torch_design_from_template_matches_jax(bipolar):
    jb, tb, template, doa_list = small_design_setup(bipolar)
    ref = jax_design_f32(jb, template, doa_list)
    got = tb.design_from_template(template, doa_list)
    assert got.dtype == torch.float32 and tuple(got.shape) == (14, 33)
    got = got.numpy().astype(np.float64)
    if bipolar:  # complex M-vectors up to a unit phase
        rc, gc = ref[:7] + 1j * ref[7:], got[:7] + 1j * got[7:]
        cos = np.abs(np.sum(np.conj(rc) * gc, axis=0)) / (np.linalg.norm(rc, axis=0) * np.linalg.norm(gc, axis=0))
    else:  # real and sign-determined: each U_i theta_i is sign-free
        cos = np.sum(ref * got, axis=0) / (np.linalg.norm(ref, axis=0) * np.linalg.norm(got, axis=0))
    assert cos.min() >= 1 - 1e-5, cos.min()


def test_torch_design_parts_match_jax():
    """The design's inputs: resampling, delays, the neuron kernel."""
    jb, tb, template, doa_list = small_design_setup(False)
    for a, b in zip(resample_to_fs(*template, FS), jax_resample(*template, FS)):
        assert a.tobytes() == b.tobytes()
    assert tb.geometry.delays_np(doa_list).tobytes() == jb.geometry.delays_np(doa_list).tobytes()
    assert tb._neuron_ir(4800).tobytes() == jb._neuron_ir(4800).tobytes()
    assert tb.robust_width == jb.robust_width and tb.kernel.tobytes() == np.asarray(jb.kernel).tobytes()
    np.testing.assert_array_equal(tb.bandpass_filter[0], jb.bandpass_filter[0])
    np.testing.assert_array_equal(tb.bandpass_filter[1], jb.bandpass_filter[1])


def test_torch_apply_to_signal_matches_jax():
    """``apply_to_signal`` on a designed matrix: the LIF membrane after
    beamforming, (T, G), within 1e-4 of its largest value (float32 FIR and
    scan orders differ; JAX runs float64 here, the port float32)."""
    jb, tb, template, doa_list = small_design_setup(True)
    bf = tb.design_from_template(template, doa_list).numpy()
    t = np.arange(0, 0.05, 1 / FS)
    rng = np.random.default_rng(6)
    sig = (np.sin(2 * np.pi * 1750 * t)[:, None] * np.ones(7) + 0.01 * rng.standard_normal((len(t), 7)))
    got = tb.apply_to_signal(bf, (t, sig.astype(np.float32))).numpy()
    ref = np.asarray(jb.apply_to_signal(bf, (t, sig)))
    assert got.shape == ref.shape == (len(t), 33)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
