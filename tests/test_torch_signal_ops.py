"""The port's remaining signal ops against the JAX package on the CPU, on the
same seeded float64 inputs (JAX runs under x64 here, as its own tests do):

- the spike encoders of ``ops/spikes.py`` (``SpikeEncoder`` and its four
  subclasses): bit-exact rasters (the integrate-and-fire encoders floor a
  running sum, so float32 would round a sample across an integer; float64
  does not on these signals);
- ``ops/fir.fir_filter``: every method on real and complex operands with
  odd T and K, within 1e-10 of JAX's output peak (measured 5e-16: the FFT
  and the direct form round alike in float64); ``"auto"`` takes the FFT for
  a CPU tensor; ``"blockmm"`` refuses complex operands, as JAX's does;
- ``ops/peaks.local_maxima_mask_bounded``: bit-exact, with plateaus up to and
  past ``max_plateau``;
- ``io/flac.verify_md5``: true for a 16-bit file with the MD5 of its PCM,
  false after one byte of that MD5 is flipped, true for a zero MD5, as
  JAX's answers on the same three files;
- ``ops/envelope.Envelope``: within 1e-12 of JAX's output peak, the state
  carried across two calls (XLA may contract the update into a fused
  multiply-add, a last bit apart from the port's two roundings);
- ``ops/hilbert_iir``: ``fit_hilbert_iir``'s ``(b, a, rel_err)`` equal to
  JAX's (the same numpy and scipy); ``hilbert_iir_analytic`` within 1e-10
  of JAX's output peak (the sequential scan in float64, as JAX's);
- the exports of ``ops`` and of the package, and no JAX in the port.
"""
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.io.flac import verify_md5 as jax_verify_md5
from haghighatshoarmuir2024_tpu.ops import envelope as jax_envelope
from haghighatshoarmuir2024_tpu.ops import hilbert_iir as jax_hilbert_iir
from haghighatshoarmuir2024_tpu.ops import spikes as jax_spikes
from haghighatshoarmuir2024_tpu.ops.fir import fir_filter as jax_fir_filter
from haghighatshoarmuir2024_tpu.ops.peaks import local_maxima_mask_bounded as jax_local_maxima_mask_bounded

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch import ops
from haghighatshoarmuir2024_tpu_torch.io.flac import read_flac, verify_md5
from haghighatshoarmuir2024_tpu_torch.ops import envelope, hilbert_iir, spikes
from haghighatshoarmuir2024_tpu_torch.ops.fir import fir_filter
from haghighatshoarmuir2024_tpu_torch.ops.peaks import local_extrema_mask_bounded, local_maxima_mask_bounded

REPO = Path(__file__).resolve().parent.parent

FS = 48_000
FIR_TOL, ENV_TOL = 1e-10, 1e-12


def signal(seed: int, T: int = 2001, C: int = 5) -> np.ndarray:
    """A seeded multichannel test signal: tones in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None] / FS
    return np.sin(2 * np.pi * rng.uniform(300, 3000, C) * t + rng.uniform(0, np.pi, C)) \
        + 0.3 * rng.standard_normal((T, C))


# ------------------------------------------------------------------ spikes
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name,args", [
    ("IAFSpikeEncoder", (2000.0, FS)),
    ("IAFZeroCrossingSpikeEncoder", (500.0, FS)),
    ("PeakSpikeEncoder", (FS,)),
    ("ZeroCrossingSpikeEncoder", (FS, 12, True)),
    ("ZeroCrossingSpikeEncoder", (FS, 12, False)),
])
def test_torch_spike_encoders_match_jax(name, args, seed):
    x = signal(seed)
    enc, jenc = getattr(spikes, name)(*args), getattr(jax_spikes, name)(*args)
    assert isinstance(enc, spikes.SpikeEncoder)
    got = enc(torch.as_tensor(x))
    want = np.asarray(jenc(jnp.asarray(x)))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(enc.evolve(torch.as_tensor(x)).numpy(), got.numpy())


@pytest.mark.parametrize("rw", [1, 3, 8])
def test_torch_peak_encoder_width_matches_jax(rw):
    x = signal(7)
    got = spikes.PeakSpikeEncoder(FS).evolve(torch.as_tensor(x), robust_width=rw)
    want = jax_spikes.PeakSpikeEncoder(FS).evolve(jnp.asarray(x), robust_width=rw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_spike_encoder_base():
    with pytest.raises(NotImplementedError):
        spikes.SpikeEncoder()(np.zeros((4, 1)))
    for name in ("IAFSpikeEncoder", "IAFZeroCrossingSpikeEncoder", "ZeroCrossingSpikeEncoder", "PeakSpikeEncoder"):
        assert issubclass(getattr(spikes, name), spikes.SpikeEncoder)


# ---------------------------------------------------------------------- fir
def fir_operands(T: int, K: int, kind: str):
    rng = np.random.default_rng(T + K)
    x, b = rng.standard_normal((3, T)), rng.standard_normal(K)
    if kind[0] == "c":
        x = x + 1j * rng.standard_normal(x.shape)
    if kind[1] == "c":
        b = b + 1j * rng.standard_normal(K)
    return x, b


@pytest.mark.parametrize("kind", ["rr", "cr", "rc", "cc"])  # signal, taps: real or complex
@pytest.mark.parametrize("method", ["fft", "direct", "blockmm"])
@pytest.mark.parametrize("T,K", [(1001, 63), (257, 481), (99, 7)])
def test_torch_fir_filter_matches_jax(method, kind, T, K):
    x, b = fir_operands(T, K, kind)
    if method == "blockmm" and kind != "rr":
        for fn, xx in ((fir_filter, torch.as_tensor(x)), (jax_fir_filter, jnp.asarray(x))):
            with pytest.raises(ValueError, match="real signals/taps only"):
                fn(b, xx, axis=1, method=method)
        return
    got = fir_filter(b, torch.as_tensor(x), axis=1, method=method).numpy()
    want = np.asarray(jax_fir_filter(b, jnp.asarray(x), axis=1, method=method))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= FIR_TOL * np.abs(want).max()


def test_torch_fir_filter_auto_takes_fft_on_cpu():
    x, b = fir_operands(1001, 33, "cr")
    xt = torch.as_tensor(x.T.copy())
    np.testing.assert_array_equal(fir_filter(b, xt).numpy(), fir_filter(b, xt, method="fft").numpy())
    want = np.asarray(jax_fir_filter(b, jnp.asarray(x.T)))
    assert np.abs(fir_filter(b, xt).numpy() - want).max() <= FIR_TOL * np.abs(want).max()
    with pytest.raises(ValueError, match="unknown FIR method"):
        fir_filter(b, xt, method="overlap-add")


# -------------------------------------------------------------------- peaks
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("W", [2, 5, 16])
def test_torch_local_maxima_mask_bounded_matches_jax(seed, W):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((4, 600)) * 3)  # short plateaus everywhere
    for row, run in zip(x, (W - 1, W, W + 1, 3 * W)):  # and one plateau up to and past W in each row
        row[200:200 + run] = 9.0
        row[400:400 + run] = -9.0
    got = local_maxima_mask_bounded(torch.as_tensor(x), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_local_maxima_mask_bounded(jnp.asarray(x), W)))
    np.testing.assert_array_equal(got.numpy(), local_extrema_mask_bounded(torch.as_tensor(x), W)[0].numpy())
    assert got[:2, 200:200 + W + 1].any()  # a plateau within the bound keeps its midpoint


# --------------------------------------------------------------------- flac
def write_verbatim_flac(path, pcm: np.ndarray, fs: int, md5: bytes = bytes(16)) -> None:
    """A FLAC file of (n, channels) int16 ``pcm`` in VERBATIM subframes,
    4096 samples a frame, STREAMINFO's MD5 field ``md5`` (CRCs zero: the
    decoder parses past them); ``tests/test_torch_localize.py``'s writer
    with an ``md5`` option."""
    bits = []

    def put(v, n):
        bits.extend((int(v) >> (n - 1 - i)) & 1 for i in range(n))

    n, ch = pcm.shape
    put(1, 1), put(0, 7), put(34, 24)  # the last metadata block: STREAMINFO
    put(4096, 16), put(4096, 16), put(0, 24), put(0, 24)
    put(fs, 20), put(ch - 1, 3), put(15, 5), put(n, 36), put(int.from_bytes(md5, "big"), 128)
    for f, s in enumerate(range(0, n, 4096)):
        blk = pcm[s:s + 4096]
        put(0x3FFE, 14), put(0, 2), put(7, 4), put(0, 4), put(ch - 1, 4), put(4, 3), put(0, 1)
        put(f, 8), put(len(blk) - 1, 16), put(0, 8)  # frame number (< 128), block size, CRC-8
        for c in range(ch):
            put(0, 1), put(1, 6), put(0, 1)  # VERBATIM, no wasted bits
            for v in blk[:, c]:
                put(int(v) & 0xFFFF, 16)
        bits.extend([0] * (-len(bits) % 8))
        put(0, 16)  # CRC-16
    with open(path, "wb") as fh:
        fh.write(b"fLaC" + np.packbits(np.asarray(bits, np.uint8)).tobytes())


def test_torch_verify_md5_matches_jax(tmp_path):
    pcm = (np.random.default_rng(3).standard_normal((5000, 2)) * 3000).astype(np.int16)
    md5 = hashlib.md5(pcm.astype("<i2").tobytes()).digest()  # the samples interleaved, little-endian
    want = {"real": True, "flipped": False, "zero": True}
    for name, digest in (("real", md5), ("flipped", bytes([md5[0] ^ 1]) + md5[1:]), ("zero", bytes(16))):
        path = str(tmp_path / f"{name}.flac")
        write_verbatim_flac(path, pcm, FS, digest)
        np.testing.assert_array_equal(read_flac(path, normalize=False)[0], pcm)
        assert verify_md5(path) is want[name] and jax_verify_md5(path) is want[name], name
    bad = tmp_path / "not.flac"
    bad.write_bytes(b"RIFF" + bytes(60))
    with pytest.raises(ValueError, match="not a FLAC file"):
        verify_md5(str(bad))


# ----------------------------------------------------------------- envelope
@pytest.mark.parametrize("rise,fall", [(1e-3, 20e-3), (5e-4, 5e-4)])
def test_torch_envelope_matches_jax(rise, fall):
    x = signal(11, T=3001, C=3) * np.linspace(0.2, 1.5, 3001)[:, None]
    env, jenv = envelope.Envelope(rise, fall, FS), jax_envelope.Envelope(rise, fall, FS)
    want = np.asarray(jenv.evolve(jnp.asarray(x)))
    got = env.evolve(torch.as_tensor(x))
    assert got.shape == want.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= ENV_TOL * np.abs(want).max()
    # carried across two calls: the same as one call, in both packages
    a, s = env.evolve(torch.as_tensor(x[:1200]), return_state=True)
    b = env.evolve(torch.as_tensor(x[1200:]), state=s)
    ja, js = jenv.evolve(jnp.asarray(x[:1200]), return_state=True)
    jb = jenv.evolve(jnp.asarray(x[1200:]), state=js)
    assert np.abs(s.numpy() - np.asarray(js)).max() <= ENV_TOL * np.abs(want).max()
    for g, w in ((a, ja), (b, jb)):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= ENV_TOL * np.abs(want).max()
    with pytest.raises(ValueError, match="larger fall time"):
        envelope.Envelope(2e-3, 1e-3, FS)


# -------------------------------------------------------------- hilbert_iir
@pytest.mark.parametrize("kernel_duration,deg", [(5e-3, 6), (10e-3, 4)])
def test_torch_hilbert_iir_matches_jax(kernel_duration, deg):
    b, a, rel = hilbert_iir.fit_hilbert_iir(FS, kernel_duration, deg, deg)
    jb, ja, jrel = jax_hilbert_iir.fit_hilbert_iir(FS, kernel_duration, deg, deg)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)
    assert rel == jrel and np.isfinite(rel)
    x = signal(5, T=1500, C=3)
    delay = int(FS * kernel_duration) // 4
    got = hilbert_iir.hilbert_iir_analytic(torch.as_tensor(x), b, a, delay).numpy()
    want = np.asarray(jax_hilbert_iir.hilbert_iir_analytic(jnp.asarray(x), b, a, delay))
    assert got.dtype == want.dtype == np.complex128 and got.shape == want.shape
    assert np.abs(got - want).max() <= FIR_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got.real, np.roll(x, delay, axis=0))


# ------------------------------------------------------------------ exports
def test_torch_ops_exports_what_jax_exports():
    names = ["Envelope", "SpikeEncoder", "IAFSpikeEncoder", "IAFZeroCrossingSpikeEncoder", "ZeroCrossingSpikeEncoder",
             "PeakSpikeEncoder", "Filterbank", "ButterworthFilterbank"]
    for name in names:
        assert name in tpkg.__all__ and getattr(tpkg, name) is getattr(ops, name), name
        assert name in jpkg.__all__
    assert sorted(ops.__all__) == sorted(jpkg.ops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name
    assert ops.fir_filter is fir_filter


def test_torch_new_modules_import_without_jax():
    mods = ["haghighatshoarmuir2024_tpu_torch", "haghighatshoarmuir2024_tpu_torch.ops",
            "haghighatshoarmuir2024_tpu_torch.ops.envelope", "haghighatshoarmuir2024_tpu_torch.ops.hilbert_iir",
            "haghighatshoarmuir2024_tpu_torch.ops.spikes", "haghighatshoarmuir2024_tpu_torch.ops.fir",
            "haghighatshoarmuir2024_tpu_torch.io.flac",
            "haghighatshoarmuir2024_tpu_torch.experiments.multiband_speech",
            "haghighatshoarmuir2024_tpu_torch.experiments.short_hilbert_transform",
            "haghighatshoarmuir2024_tpu_torch.experiments.target_xylo_localization",
            "haghighatshoarmuir2024_tpu_torch.experiments.xylo_ordering_sensitivity"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'haghighatshoarmuir2024_tpu'"
            " or m.startswith('haghighatshoarmuir2024_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
    imports_jax = re.compile(r"^\s*(import|from)\s+(jax\b|haghighatshoarmuir2024_tpu\b(?!_torch))")
    for path in (REPO / "haghighatshoarmuir2024_tpu_torch").rglob("*.py"):
        assert not any(imports_jax.match(ln) for ln in path.read_text().splitlines()), path
