"""The 24 kHz mode of the PyTorch port (``Demo(fs=24_000)``, the JAX
package's ``experiments/reduced_rate.py``) against the JAX package: the
bundled 24 kHz design and its integers, the matched DoAs on bench.py's
frames decimated by ``decimate_fir(x, 2)``, and the streaming step at
6000-sample chunks (lifted block size 48).

DoAs are compared by grid index, the grid's two ends (−π and π) counting as
one direction, as ``test_torch_slice.py`` does; the two encodes differ in
float rounding there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops import resample as jax_resample
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template
from haghighatshoarmuir2024_tpu.utils import cache as jax_cache

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.ops import resample
from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel
from haghighatshoarmuir2024_tpu_torch.runtime import StreamingLocalizer
from haghighatshoarmuir2024_tpu_torch.utils import cache

FS, G, B = 24_000, 449, 6
CONFIG = dict(freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, G), recording_duration=0.25,
              kernel_duration=10e-3, bipolar_spikes=True, fs=FS)
CONFIG_FIELDS = ("w_in", "w_rec", "w_out", "dash_syn", "dash_mem", "dash_syn_out", "dash_mem_out",
                 "threshold", "threshold_out")


@pytest.fixture(autouse=True, scope="module")
def _caches(tmp_path_factory):
    """JAX Demos built without the committed XLA executables; the port's
    design cache in a directory of the test's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        mp.setenv(cache.CACHE_ENV, str(tmp_path_factory.mktemp("torch_cache")))
        yield


def grid_index(doa) -> np.ndarray:
    idx = np.abs(np.asarray(doa, np.float64)[:, None] - CONFIG["doa_list"][None, :]).argmin(axis=1)
    return idx % (G - 1)


@pytest.fixture(scope="module")
def models(_caches):
    geo = dict(radius=4.5e-2, num_mic=7)
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(**geo), **CONFIG)
    td = Demo(geometry=tpkg.CenterCircularArray(**geo), **CONFIG, device="cpu")
    return jd, td


@pytest.fixture(scope="module")
def frames(models):
    """bench.py's frames at 48 kHz (a 1750 Hz tone, 0.1 white noise from a
    seed), fewer of them, decimated to 24 kHz by ``decimate_fir(x, 2)``."""
    jd, _ = models
    t = np.arange(0, 0.25, 1 / 48_000)
    sig = np.sin(2 * np.pi * 1750 * t)
    doas = np.linspace(-np.pi, np.pi, B, endpoint=False)
    full = np.stack([np.asarray(signal_from_template(jd.geometry, t, sig, d, fs=48_000)) for d in doas])
    full = (full + 0.1 * np.random.default_rng(0).standard_normal(full.shape)).astype(np.float32)
    dec = np.stack([resample.decimate_fir(f, 2) for f in full])
    np.testing.assert_array_equal(dec, np.stack([np.asarray(jax_resample.decimate_fir(f, 2)) for f in full]))
    assert dec.shape == (B, 6000, 7)
    return doas, dec


def test_torch_24k_bundled_design_matches_jax(models):
    """Both packages resolve the same bundled 24 kHz design key, and their
    quantized integers are identical."""
    jd, td = models
    kw = dict(r_vec=td.geometry.r_vec, theta_vec=td.geometry.theta_vec, speed=td.geometry.speed,
              freq_bands=td.freq_bands, doa_list=td.doa_list, recording_duration=0.25, kernel_duration=10e-3,
              bipolar=True, fs=FS, version=1)
    key = cache.design_cache_key(**kw)
    assert key == jax_cache.design_cache_key(**kw)
    assert cache.bundled_path(key).exists()
    np.testing.assert_array_equal(td.bf_mats[0], np.load(cache.bundled_path(key))["bf_0"])
    for name in CONFIG_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(td.xylo_config, name)),
                                      np.asarray(getattr(jd.xylo_config, name)))
    assert StreamingLocalizer.block_size(6000) == 48


def test_torch_24k_matched_doas_match_jax(models, frames):
    jd, td = models
    doas, x = frames
    jd.calibrate_profiles()
    td.calibrate_profiles()
    np.testing.assert_array_equal(td._profiles, np.asarray(jd._profiles))  # the bundled 24 kHz table
    jdoa, _ = jd.forward_batch(jnp.asarray(x), method="matched")
    tdoa, trate = td.forward_batch(x, method="matched")
    assert trate.shape == (B, G) and bool(torch.isfinite(trate).all())
    np.testing.assert_array_equal(grid_index(tdoa.numpy()), grid_index(np.asarray(jdoa)))
    err = np.rad2deg(np.arcsin(np.abs(np.sin(tdoa.numpy() - doas))))
    assert (err < 5.0).all(), err  # the bench gate


def test_torch_24k_two_carried_chunks_equal_one_pass(models, frames):
    """Two carried 6000-sample chunks at block size 48: the step's decided
    masks through the LIF in one pass from zero give the carried counts and
    state, and the folded estimate localizes."""
    _, td = models
    doas, x = frames
    td.calibrate_profiles()
    sl = StreamingLocalizer(td)
    state, spikes = sl.init_state(batch=B), []
    for _ in range(2):  # the same chunk twice, as the serving benchmark streams it
        state, sp = sl.process_chunk(state, x)
        spikes.append(sp)
    raster = torch.cat(spikes)  # (12 000, B, 2C): [kp & ~kn, kn]
    C = raster.shape[-1] // 2
    kp, kn = raster[..., :C] != 0, raster[..., C:] != 0
    counts, isyn, vmem, spk = lif_kernel.lif_count_stateful_bipolar_plain(td.xylo_config, kp, kn, None, None, None)
    for got, ref in zip((state.counts, state.isyn, state.vmem, state.spk), (counts, isyn, vmem, spk)):
        assert torch.equal(got, ref)
    assert int(state.steps[0]) == 12_000 and int(counts.sum()) > 0
    err = np.rad2deg(np.arcsin(np.abs(np.sin(sl.estimate_doa(state, "matched").numpy() - doas))))
    assert (err < 5.0).all(), err
