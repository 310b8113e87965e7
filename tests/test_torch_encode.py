"""Encode stage of the PyTorch port (STHT + lifted blocked IIR cumsum) against
the JAX package's TPU form — ``stht(method="blockmm")`` then
``iir_filter(method="blocked_cumsum")``, run here on the CPU — and against
float64 scipy.  Tolerance 1e-5·max|cs|: the TPU form itself is 2.7e-6·max|cs|
off float64 on flagship frames, and both sides sum float32 products in
different orders.  (The JAX CPU path of ``_encode_cumsum`` runs a sequential
scan instead, 7.2e-4·max|cs| off float64, so it is not the reference here.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from scipy.signal import lfilter

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.ops.iir import iir_filter
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template as jax_sft
from haghighatshoarmuir2024_tpu.ops.stht import stht as jax_stht

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.ops.iir import butter_bandpass, iir_cumsum_blocked
from haghighatshoarmuir2024_tpu_torch.ops.interp import signal_from_template
from haghighatshoarmuir2024_tpu_torch.ops.stht import stht, stht_kernel


FS = 48_000
TOL = 1e-5
KERNEL = stht_kernel(480)
BA = butter_bandpass(1, [1600, 1900], FS)


def port_cs(x: np.ndarray, b, a) -> np.ndarray:
    inphase, quad = stht(torch.as_tensor(x), KERNEL)
    return iir_cumsum_blocked(b, a, torch.cat([inphase, quad], dim=-1)).numpy()


def jax_tpu_form_cs(x: np.ndarray, b, a) -> np.ndarray:
    h = jax_stht(jnp.asarray(x), KERNEL.astype(np.float32), axis=0, method="blockmm")
    sig_real = jnp.concatenate([h.real, h.imag], axis=-1)
    return np.asarray(iir_filter(b, a, sig_real, axis=0, method="blocked_cumsum"))


def scipy_cs(x: np.ndarray, b, a) -> np.ndarray:
    x64 = x.astype(np.float64)
    quad = lfilter(KERNEL, [1.0], x64, axis=0)
    sig_real = np.concatenate([np.roll(x64, len(KERNEL) // 2, axis=0), quad], axis=-1)
    return np.cumsum(lfilter(b, a, sig_real, axis=0), axis=0)


def rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("T,L,band", [
    (3001, 5, (1600, 1900)),   # T not a multiple of 32: zero-padded tail, level-2 lifting
    (2400, 3, (500, 1100)),    # another band of the same order
    (69, 4, (1600, 1900)),     # nb = 3: smallest level-2 case
    (64, 4, (1600, 1900)),     # nb = 2 (Q <= 2): level-1 recurrence
    (40, 2, (1600, 1900)),     # nb = 2 with a ragged tail
])
def test_torch_encode_matches_jax_tpu_form_and_scipy(T, L, band):
    b, a = butter_bandpass(1, band, FS)
    x = np.random.default_rng(T).standard_normal((T, L)).astype(np.float32)
    got = port_cs(x, b, a)
    assert got.shape == (T, 2 * L) and got.dtype == np.float32
    assert rel_err(got, jax_tpu_form_cs(x, b, a)) <= TOL
    assert rel_err(got, scipy_cs(x, b, a)) <= TOL


@pytest.fixture(scope="module")
def flagship_frames():
    geo = jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    doas = np.array([-2.0, 0.3, 2.9])
    frames = np.stack([np.asarray(jax_sft(geo, t, sig, d, fs=FS)) for d in doas])
    noise = 0.1 * np.random.default_rng(0).standard_normal(frames.shape)
    return t, sig, doas, (frames + noise).astype(np.float32)


def test_torch_flagship_encode_matches_jax_tpu_form(flagship_frames):
    _, _, _, frames = flagship_frames
    demo = Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 449), fs=FS, device="cpu")
    cs = demo.encode(frames).numpy()  # (T, B, C)
    assert cs.shape == (12_000, 3, 14)
    b, a = BA
    for i, f in enumerate(frames):
        assert rel_err(cs[:, i], jax_tpu_form_cs(f, b, a)) <= TOL
        assert rel_err(cs[:, i], scipy_cs(f, b, a)) <= TOL


def test_torch_signal_from_template_matches_jax(flagship_frames):
    t, sig, doas, _ = flagship_frames
    geo_j = jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7)
    geo_t = tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7)
    for d in list(doas) + [-np.pi, np.pi, 0.0]:
        ref = np.asarray(jax_sft(geo_j, t, sig, d, fs=FS))
        got = signal_from_template(geo_t, torch.as_tensor(t), torch.as_tensor(sig), d, fs=FS)
        assert got.shape == (12_000, 7)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
