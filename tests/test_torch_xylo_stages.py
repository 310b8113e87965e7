"""The per-stage API of the port's ``Demo`` (``spike_encoding`` →
``xylo_process`` → ``extract_rate``, the simulator ``Demo.xylo``) and the
single-frame matched forward against the JAX package on the CPU.

A bipolar model (65-point grid, 0.1 s, 5 ms STHT kernel, one band) is
designed and calibrated by the JAX package and carried to the port by
``Demo.save`` → ``Demo.load``, so both hold the same integers and profiles.

- ``spike_encoding``: the raster, its layout and dtype bit-exact against
  JAX's ``_spikes_from_cumsum`` on the same ``cs`` (bipolar and unipolar);
  end to end from the same audio the two encodes differ in float summation
  order (on the CPU the JAX encode runs an FFT STHT and a sequential scan,
  the port its TPU form), which moves at most 1e-3 of the spikes.
- ``xylo_process``: bit-exact from the same raster, one frame or a batch.
- ``extract_rate``: within rtol 1e-6 (float32 means in another order).
- ``Demo.forward(method="matched")``: the DoA of JAX's
  ``_forward_matched_jit`` on the same frames (grid ends −π ≡ π)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.models.xylo.pipeline import _spikes_from_cumsum
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template

from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo, XyloSim

FS, G = 48_000, 65
SMALL = dict(freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, G), recording_duration=0.1,
             kernel_duration=5e-3, bipolar_spikes=True, fs=FS)
DOAS = np.array([-2.6, -0.9, 0.4, 2.1])
SPIKE_MOVE_TOL = 1e-3  # end-to-end raster entries that may differ, as a fraction of the spikes


@pytest.fixture(autouse=True, scope="module")
def _no_jax_persistent_cache():
    """Build JAX Demos without seeding the committed XLA executables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        yield


def grid_index(doa) -> np.ndarray:
    """DoA → grid index; the grid's two ends (−π and π) are one direction."""
    idx = np.abs(np.atleast_1d(np.asarray(doa))[:, None] - SMALL["doa_list"][None, :]).argmin(axis=1)
    return idx % (G - 1)


@pytest.fixture(scope="module")
def models(tmp_path_factory, _no_jax_persistent_cache):
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **SMALL, use_cache=False)
    jd.calibrate_profiles(use_cache=False)
    path = tmp_path_factory.mktemp("stages") / "model.npz"
    jd.save(str(path))
    td = Demo.load(str(path), device="cpu")
    t = np.arange(0, 0.1, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    frames = np.stack([np.asarray(signal_from_template(jd.geometry, t, sig, d, fs=FS)) for d in DOAS])
    frames = (frames + 0.3 * np.random.default_rng(0).standard_normal(frames.shape)).astype(np.float32)
    rasters = np.stack([np.asarray(jd.spike_encoding(f)) for f in frames])  # JAX's own encode
    return {"jd": jd, "td": td, "frames": frames, "rasters": rasters, "path": path}


@pytest.mark.parametrize("bipolar", [True, False])
def test_torch_spike_encoding_matches_jax_on_the_same_cs(models, bipolar):
    td = Demo.load(str(models["path"]), device="cpu")
    td.bipolar_spikes = bipolar  # the same encode; the raster's layout follows the polarity
    frames = models["frames"]
    cs = td.encode(frames).numpy()  # (T, B, C)
    batch = td.spike_encoding(frames)
    C = cs.shape[-1]
    assert batch.dtype == torch.int32 and batch.shape == (len(frames), cs.shape[0], 2 * C if bipolar else C)
    for b, f in enumerate(frames):
        ref = np.asarray(_spikes_from_cumsum(jnp.asarray(cs[:, b].T), robust_width=td.robust_width,
                                             bipolar=bipolar))
        one = td.spike_encoding(f)
        np.testing.assert_array_equal(one.numpy(), ref)
        np.testing.assert_array_equal(batch[b].numpy(), ref)
        assert ref.sum() > 0


def test_torch_spike_encoding_end_to_end_close_to_jax(models):
    got = models["td"].spike_encoding(models["frames"]).numpy()
    ref = models["rasters"]
    assert got.shape == ref.shape
    moved = int((got != ref).sum())
    assert moved <= SPIKE_MOVE_TOL * ref.sum(), (moved, int(ref.sum()))


def test_torch_xylo_process_matches_jax(models):
    jd, td = models["jd"], models["td"]
    assert isinstance(td.xylo, XyloSim)
    rasters = models["rasters"]
    batch = td.xylo_process(rasters)
    assert batch.shape == (len(rasters), rasters.shape[1], G) and batch.dtype == torch.int32
    for b, r in enumerate(rasters):
        ref = np.asarray(jd.xylo_process(r))
        np.testing.assert_array_equal(td.xylo_process(r).numpy(), ref)
        np.testing.assert_array_equal(batch[b].numpy(), ref)
        assert ref.sum() > 0


@pytest.mark.parametrize("fold", [True, False])
def test_torch_extract_rate_matches_jax(models, fold):
    jd, td = models["jd"], models["td"]
    hidden = [np.array(jd.xylo_process(r)) for r in models["rasters"]]
    batch = td.extract_rate(np.stack(hidden), fold=fold, time_dim=1)
    for b, h in enumerate(hidden):
        ref = np.asarray(jd.extract_rate(h, fold=fold))
        np.testing.assert_allclose(td.extract_rate(h, fold=fold).numpy(), ref, rtol=1e-6, atol=0)
        np.testing.assert_allclose(batch[b].numpy(), ref, rtol=1e-6, atol=0)


def test_torch_stage_chain_doa_matches_forward(models):
    """spike_encoding → xylo_process → extract_rate → peak gives the DoA of
    ``Demo.forward`` on the same frame (the simulator's counts are K5's)."""
    td = models["td"]
    for f in models["frames"]:
        rate = td.extract_rate(td.xylo_process(td.spike_encoding(f)))
        doa, fwd_rate = td.forward(f)
        np.testing.assert_allclose(rate.numpy(), fwd_rate.numpy(), rtol=1e-6)
        assert float(td.estimate_doa_from_rate(rate, "peak")) == float(doa)


def test_torch_forward_matched_matches_jax(models):
    jd, td = models["jd"], models["td"]
    for f in models["frames"]:
        j_doa, _ = jd._forward_matched_jit(jnp.asarray(f))
        t_doa, t_rate = td.forward(f, method="matched")
        assert grid_index(float(t_doa)) == grid_index(float(j_doa))
        b_doa, b_rate = td.forward_batch(f[None], method="matched")
        assert float(b_doa[0]) == float(t_doa)
        np.testing.assert_array_equal(b_rate[0].numpy(), t_rate.numpy())
    with pytest.raises(ValueError):
        td.forward(models["frames"][0], method="periodic_ml")


def test_torch_forward_matched_needs_profiles(models):
    td = models["td"]
    bare = Demo.load(str(models["path"]), device="cpu")
    bare._profiles = bare._profiles_t = None
    with pytest.raises(ValueError):
        bare.forward(models["frames"][0], method="matched")
    assert float(bare.forward(models["frames"][0])[0]) == float(td.forward(models["frames"][0])[0])
