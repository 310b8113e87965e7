"""Host side of the PyTorch port against the JAX package: geometry arrays,
design cache keys and the bundled designs, the quantized config, the static
no-saturation proof, JAX ``Demo.save`` → port ``Demo.load``, and a JAX
checkpoint through the port's ``load`` → ``save`` back into the JAX
``Demo.load`` with every array byte-equal (``profiles_stacked`` included)."""
import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops.pallas import lif_kernel as jax_lif
from haghighatshoarmuir2024_tpu.utils import cache as jax_cache

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo, XyloConfig
from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel as torch_lif
from haghighatshoarmuir2024_tpu_torch.utils import cache as torch_cache

FS = 48_000
G = 449
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


CONFIG_FIELDS = ("w_in", "w_rec", "w_out", "dash_syn", "dash_mem", "dash_syn_out",
                 "dash_mem_out", "threshold", "threshold_out")


@pytest.fixture(scope="module")
def demos():
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **FLAGSHIP)
    jd.calibrate_profiles()
    td = Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **FLAGSHIP, device="cpu")
    td.calibrate_profiles()
    return jd, td


@pytest.mark.parametrize("cls,args", [
    ("CenterCircularArray", (4.5e-2, 7)),
    ("CenterCircularArray", (4.5e-2, 4, 340.0, False)),
    ("CenterCircularArray", (0.1, 5)),
])
def test_torch_geometry_arrays_byte_equal(cls, args):
    jg, tg = getattr(jpkg, cls)(*args), getattr(tpkg, cls)(*args)
    for name in ("r_vec", "theta_vec"):
        a, b = getattr(jg, name), getattr(tg, name)
        assert a.dtype == b.dtype == np.float64
        assert a.tobytes() == b.tobytes()
    assert jg.speed == tg.speed
    theta = np.linspace(-np.pi, np.pi, 17)
    np.testing.assert_allclose(
        tg.delays(torch.as_tensor(theta)).numpy(), np.asarray(jg.delays(theta, normalized=False)),
        rtol=0, atol=1e-15,
    )


@pytest.mark.parametrize("kwargs", [
    dict(r_vec=np.arange(3.0), fs=48_000, version=1, bipolar=True),
    dict(kind="profiles", sig=np.ones(5, np.float32), fs=48_000.0, doa_list=np.zeros((2, 2))),
])
def test_torch_design_cache_key_equal(kwargs):
    assert torch_cache.design_cache_key(**kwargs) == jax_cache.design_cache_key(**kwargs)


def test_torch_flagship_keys_resolve_to_bundled(demos):
    jd, td = demos
    geo = td.geometry
    key = torch_cache.design_cache_key(
        r_vec=geo.r_vec, theta_vec=geo.theta_vec, speed=geo.speed,
        freq_bands=td.freq_bands, doa_list=td.doa_list, recording_duration=0.25,
        kernel_duration=10e-3, bipolar=True, fs=FS, version=1,
    )
    assert torch_cache.bundled_path(key).exists()
    # the port's own copy, byte for byte the JAX package's file
    assert torch_cache.BUNDLED_DIR != jax_cache._BUNDLED_DIR
    assert torch_cache.bundled_path(key).read_bytes() == (jax_cache._BUNDLED_DIR / f"{key}.npz").read_bytes()
    bundled = jax_cache.DesignCache(cache_dir=os.devnull).load(key)
    np.testing.assert_array_equal(td.bf_mats[0], bundled["bf_0"])
    np.testing.assert_array_equal(td.bf_mats[0], jd.bf_mats[0])
    assert td.bf_mats[0].shape == (14, G)
    np.testing.assert_array_equal(td._profiles, np.asarray(jd._profiles))
    assert td._profiles.shape == (G, G)


def test_torch_bundled_designs_are_the_jax_files():
    """Every bundled design of the port is a copy of the JAX package's file
    of the same name (sha256), and none is missing."""
    ours = sorted(torch_cache.BUNDLED_DIR.glob("*.npz"))
    theirs = sorted(jax_cache._BUNDLED_DIR.glob("*.npz"))
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) == 4
    for a, b in zip(ours, theirs):
        assert hashlib.sha256(a.read_bytes()).hexdigest() == hashlib.sha256(b.read_bytes()).hexdigest(), a.name


def test_torch_xylo_config_integers_identical(demos):
    jd, td = demos
    for name in CONFIG_FIELDS:
        a, b = getattr(jd.xylo_config, name), getattr(td.xylo_config, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jd.xylo_config.weight_scale == td.xylo_config.weight_scale
    assert td.xylo_config.w_in.shape == (28, G)
    assert not td.xylo_config.w_rec.any()
    assert td.robust_width == jd.beamfs[0].robust_width == 12
    np.testing.assert_array_equal(td.kernel, jd.beamfs[0].kernel)
    for (b1, a1), (b2, a2) in zip(jd.filterbank.ba_list, td.filterbank.ba_list):
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(a1, a2)


def _random_config(seed, C=12, N=20, w_scale=20, dash_hi=7, rec=0):
    rng = np.random.default_rng(seed)
    return XyloConfig(
        w_in=rng.integers(-w_scale, w_scale + 1, size=(C, N)).astype(np.int32),
        w_rec=np.full((N, N), rec, np.int32), w_out=np.ones((N, 1), np.int32),
        dash_syn=rng.integers(1, dash_hi, size=N).astype(np.int32),
        dash_mem=rng.integers(1, dash_hi, size=N).astype(np.int32),
        dash_syn_out=np.ones(1, np.int32), dash_mem_out=np.ones(1, np.int32),
        threshold=rng.integers(30, 200, size=N).astype(np.int32),
        threshold_out=np.ones(1, np.int32), dt=1e-3, weight_scale=1.0,
    )


@pytest.mark.parametrize("seed,w_scale,dash_hi,rec,bound", [
    (0, 20, 3, 0, 1), (1, 127, 7, 0, 1), (2, 5000, 7, 0, 1), (3, 3, 2, -1, 1), (4, 20, 4, 0, 3),
])
def test_torch_no_saturation_proof_agrees(seed, w_scale, dash_hi, rec, bound):
    cfg = _random_config(seed, w_scale=w_scale, dash_hi=dash_hi, rec=rec)
    assert torch_lif._no_saturation_possible(cfg, bound, rec) == \
        jax_lif._no_saturation_possible(cfg, bound, rec)


def test_torch_no_saturation_proof_flagship(demos):
    jd, td = demos
    got = torch_lif._no_saturation_possible(td.xylo_config, 1, 0)
    assert got == jax_lif._no_saturation_possible(jd.xylo_config, 1, 0)
    assert got  # the flagship kernel runs without the clips


def test_torch_demo_load_reads_jax_save(demos, tmp_path):
    jd, td = demos
    path = str(tmp_path / "model.npz")
    jd.save(path)
    ld = Demo.load(path, device="cpu")
    for name in CONFIG_FIELDS:
        np.testing.assert_array_equal(getattr(ld.xylo_config, name), getattr(jd.xylo_config, name))
    np.testing.assert_array_equal(ld._profiles, np.asarray(jd._profiles))
    np.testing.assert_array_equal(ld.bf_mats[0], jd.bf_mats[0])
    assert ld.geometry.r_vec.tobytes() == jd.geometry.r_vec.tobytes()
    assert ld.robust_width == td.robust_width and ld.fs == 48_000.0
    np.testing.assert_array_equal(ld.doa_list, td.doa_list)


@pytest.mark.parametrize("stacked", [True, False], ids=["profiles_stacked", "no_profiles_stacked"])
def test_torch_demo_load_save_keeps_jax_checkpoint(demos, tmp_path, stacked):
    """A JAX checkpoint loaded and saved again by the port holds the same
    arrays byte for byte, the band-stacked profile table too where the JAX
    Demo had one, and the JAX ``Demo.load`` reads it back."""
    jd, _ = demos
    jd.save(str(tmp_path / "calibrated.npz"))
    src = JaxDemo.load(str(tmp_path / "calibrated.npz"))  # a copy: the fixture stays as it is
    table = None
    if stacked:
        table = np.random.default_rng(3).standard_normal((2, 5, G)).astype(np.float32)
        src._profiles_stacked = table
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    src.save(jax_path)
    ld = Demo.load(jax_path, device="cpu")
    ld.save(port_path)
    za, zb = np.load(jax_path), np.load(port_path)
    assert sorted(za.files) == sorted(zb.files)
    assert ("profiles_stacked" in zb.files) == stacked
    for name in za.files:
        assert za[name].dtype == zb[name].dtype and za[name].shape == zb[name].shape, name
        assert za[name].tobytes() == zb[name].tobytes(), name
    back = JaxDemo.load(port_path)
    if stacked:
        assert ld._profiles_stacked.tobytes() == table.tobytes()
        assert back._profiles_stacked.dtype == table.dtype
        assert back._profiles_stacked.tobytes() == table.tobytes()
    else:
        assert ld._profiles_stacked is None and getattr(back, "_profiles_stacked", None) is None
    np.testing.assert_array_equal(np.asarray(back._profiles), np.asarray(jd._profiles))


def test_torch_demo_without_bundled_design_raises():
    """A configuration with no bundled design no longer raises: the port
    designs it (here on the CPU) and gets a finite (14, G) ``bf_0``."""
    geo = tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(geometry=geo, **{**FLAGSHIP, "freq_bands": [[1000, 1300]]}, use_cache=False, device="cpu")
    bf = demo.bf_mats[0]
    assert bf.shape == (14, G) and bf.dtype == np.float32 and np.isfinite(bf).all()
    np.testing.assert_allclose(np.linalg.norm(bf, axis=0), 1.0, atol=1e-5)
    assert demo.xylo_config.w_in.shape == (28, G) and np.abs(demo.xylo_config.w_in).max() > 0


def test_torch_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpkg.resolve_device("cuda")
