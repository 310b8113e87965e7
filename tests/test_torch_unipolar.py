"""The unipolar model and the single-frame entry of the PyTorch port against
the JAX package on the CPU.

A unipolar model (65-point grid, 0.25 s, 5 ms STHT kernel, one band) is
designed and calibrated by the JAX package, carried to the port by
``Demo.save`` → ``Demo.load``, and driven through both:

- ``forward_batch`` peak and matched DoAs identical (grid ends −π ≡ π);
- the LIF counts bit-exact from the same masks (the port's kernel K5 path);
- ``Demo.forward``'s DoA equal to JAX's, and its rate equal to the port's
  own ``forward_batch`` row exactly, for both polarities;
- the unipolar streaming step's counts identical to the JAX
  ``StreamingLocalizer`` in its TPU form, over 3 chunks;
- and the port's ``Demo.save`` read back by JAX ``Demo.load`` with
  identical integers.

End to end the encodes differ in float summation order (on the CPU the JAX
offline encode runs an FFT STHT and a sequential scan; the port its TPU
form), so DoAs are compared, not rates; stage by stage the inputs are
shared and the integers must agree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template
from haghighatshoarmuir2024_tpu.ops.pallas.lif_kernel import lif_count_rates as jax_lif_count_rates
from haghighatshoarmuir2024_tpu.runtime import StreamingLocalizer as JaxStreamingLocalizer

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
from haghighatshoarmuir2024_tpu_torch.runtime import StreamingLocalizer

FS, G, B, TC = 48_000, 65, 4, 6000
SMALL = dict(freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, G), recording_duration=0.25,
             kernel_duration=5e-3, bipolar_spikes=False, fs=FS)
CONFIG_FIELDS = ("w_in", "w_rec", "w_out", "dash_syn", "dash_mem", "dash_syn_out", "dash_mem_out",
                 "threshold", "threshold_out")


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
    path = tmp_path_factory.mktemp("unipolar") / "model.npz"
    jd.save(str(path))
    td = Demo.load(str(path), device="cpu")
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    doas = np.array([-2.6, -0.9, 0.4, 2.1])
    frames = np.stack([np.asarray(signal_from_template(jd.geometry, t, sig, d, fs=FS)) for d in doas])
    frames = (frames + 0.1 * np.random.default_rng(0).standard_normal(frames.shape)).astype(np.float32)
    return {"jd": jd, "td": td, "frames": frames, "doas": doas, "path": path}


def test_torch_unipolar_load_keeps_the_model(models):
    jd, td = models["jd"], models["td"]
    assert not td.bipolar_spikes and td.xylo_config.w_in.shape == (14, G)
    assert np.all(np.asarray(jd.xylo_config.w_rec) == 0)
    for name in CONFIG_FIELDS:
        np.testing.assert_array_equal(getattr(td.xylo_config, name), getattr(jd.xylo_config, name))
    np.testing.assert_array_equal(td._profiles, np.asarray(jd._profiles))


@pytest.mark.parametrize("method", ["peak", "matched"])
def test_torch_unipolar_forward_batch_doas_match_jax(models, method):
    jdoa, _ = models["jd"].forward_batch(models["frames"], method=method)
    _build.launch_counts.clear()
    tdoa, trate = models["td"].forward_batch(models["frames"], method=method)
    assert not _build.launch_counts  # CPU tensors: the plain versions
    assert tdoa.shape == (B,) and trate.shape == (B, G) and bool(torch.isfinite(trate).all())
    np.testing.assert_array_equal(grid_index(tdoa.numpy()), grid_index(np.asarray(jdoa)))
    if method == "matched":
        err = np.rad2deg(np.abs(np.arcsin(np.abs(np.sin(tdoa.numpy() - models["doas"])))))
        assert (err < 6.0).all()  # within a grid step (5.6°) of the source


def test_torch_unipolar_counts_bitexact_on_same_masks(models):
    td = models["td"]
    kp, _ = td.rzcc(td.encode(models["frames"]))
    assert int(kp.sum()) > 0
    got = td.lif_counts(kp, None)
    ref = np.asarray(jax_lif_count_rates(models["jd"].xylo_config, jnp.asarray(kp.numpy().astype(np.int8)),
                                         time_major=True, spike_bound=1))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0


def test_torch_unipolar_entry_points_pass_bool_masks(models, monkeypatch):
    """``forward_batch``, ``forward`` and the streaming step hand K5/K6 the
    bool masks as they are (no int8 copy); the counts equal those of the
    int8 raster."""
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel
    from haghighatshoarmuir2024_tpu_torch.runtime import streaming

    td, frames = models["td"], torch.as_tensor(models["frames"][:2])
    seen = []

    def spy(real):
        def call(config, spikes, *args, **kw):
            got = real(config, spikes, *args, **kw)
            as_int8 = real(config, spikes.to(torch.int8), *args, **kw)
            for a, b in zip(got if isinstance(got, tuple) else (got,), as_int8 if isinstance(got, tuple) else (as_int8,)):
                assert torch.equal(a, b)
            seen.append(spikes.dtype)
            return got
        return call

    monkeypatch.setattr(lif_kernel, "lif_count_rates", spy(lif_kernel.lif_count_rates))
    monkeypatch.setattr(streaming, "lif_count_stateful", spy(streaming.lif_count_stateful))
    td.forward_batch(frames)
    td.forward(frames[0])
    sl = StreamingLocalizer(td)
    sl.process_chunk(sl.init_state(2), frames[:, :TC], return_spikes=False)
    assert seen == [torch.bool] * 3


def test_torch_unipolar_forward_matches_jax(models):
    jd, td = models["jd"], models["td"]
    for frame in models["frames"]:
        jdoa, _ = jd.forward(frame)
        tdoa, trate = td.forward(frame)
        assert tdoa.dim() == 0 and trate.shape == (G,)
        np.testing.assert_array_equal(grid_index(float(tdoa)), grid_index(float(jdoa)))


@pytest.fixture(scope="module")
def bipolar_small():
    """A small bipolar model designed by the port itself."""
    return Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                **{**SMALL, "bipolar_spikes": True, "doa_list": np.linspace(-np.pi, np.pi, 33),
                   "recording_duration": 0.1}, use_cache=False, device="cpu")


@pytest.mark.parametrize("polarity", ["unipolar", "bipolar"])
def test_torch_forward_rate_equals_forward_batch_row(models, bipolar_small, polarity):
    demo = models["td"] if polarity == "unipolar" else bipolar_small
    frames = models["frames"][:, :4800]
    for frame in frames:
        doa, rate = demo.forward(frame)
        bdoa, brate = demo.forward_batch(frame[None])
        assert torch.equal(rate, brate[0]) and torch.equal(doa, bdoa[0])
    with pytest.raises(ValueError, match="sig_in must be"):
        demo.forward(frames)


def test_torch_unipolar_streaming_matches_jax_tpu_form(models):
    jd, td = models["jd"], models["td"]
    streams = np.concatenate([models["frames"], models["frames"][:, :6000]], axis=1)  # 3 chunks of 6000
    jsl = JaxStreamingLocalizer(jd)
    jsl._on_tpu = True
    jsl.N_state = len(jsl._bp[0][1]) - 1
    tsl = StreamingLocalizer(td)
    js, ts = jsl.init_state(batch=B), tsl.init_state(batch=B)
    for k in range(3):
        chunk = streams[:, k * TC:(k + 1) * TC]
        js, jsp = jsl.process_chunk(js, jnp.asarray(chunk))
        ts, tsp = tsl.process_chunk(ts, chunk)
        assert tsp.shape == (TC, B, 14) and tsp.dtype == torch.int8
        np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    for k in ("isyn", "vmem", "spk"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))
    np.testing.assert_array_equal(tsl.estimate_doa(ts, "matched").numpy(),
                                  np.asarray(jsl.estimate_doa(js, "matched")))


def test_torch_save_is_read_by_jax_load(models, bipolar_small, tmp_path):
    for demo in (models["td"], bipolar_small):
        if demo._profiles is None:
            demo.calibrate_profiles(use_cache=False)
        path = str(tmp_path / f"port_{demo.bipolar_spikes}.npz")
        demo.save(path)
        jl = JaxDemo.load(path)
        for name in CONFIG_FIELDS:
            np.testing.assert_array_equal(getattr(jl.xylo_config, name), getattr(demo.xylo_config, name))
        assert jl.bipolar_spikes == demo.bipolar_spikes and jl.fs == demo.fs
        np.testing.assert_array_equal(jl.bf_mats[0], demo.bf_mats[0])
        np.testing.assert_array_equal(np.asarray(jl._profiles), demo._profiles)
        back = Demo.load(path, device="cpu")
        for name in CONFIG_FIELDS:
            np.testing.assert_array_equal(getattr(back.xylo_config, name), getattr(demo.xylo_config, name))
