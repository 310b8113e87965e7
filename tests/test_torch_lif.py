"""LIF stage of the PyTorch port: the plain integer simulator
(``models/xylo/sim.py``) and the ``lif_count_rates_bipolar`` wrapper on CPU
tensors, bit-exact against the JAX package's ``sim_hidden_batch`` /
``lif_count_rates_bipolar`` (whose CPU path is the ``_sim_hidden`` scan).
The CUDA kernel K3 is compared with the plain simulator on the card by
``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu.models.xylo.sim import sim_hidden_batch as jax_sim_batch
from haghighatshoarmuir2024_tpu.ops.pallas.lif_kernel import (
    lif_count_rates_bipolar as jax_lif_bipolar,
)

from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo, XyloConfig
from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import sim_hidden_batch
from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel


def make_config(seed, C=12, N=20, rec_coef=0, w_scale=20):
    """Random configs in the style of tests/test_pallas_lif.py."""
    rng = np.random.default_rng(seed)
    return XyloConfig(
        w_in=rng.integers(-w_scale, w_scale + 1, size=(C, N)).astype(np.int32),
        w_rec=np.full((N, N), rec_coef, np.int32),
        w_out=np.ones((N, 1), np.int32),
        dash_syn=rng.integers(1, 7, size=N).astype(np.int32),
        dash_mem=rng.integers(1, 7, size=N).astype(np.int32),
        dash_syn_out=np.ones(1, np.int32),
        dash_mem_out=np.ones(1, np.int32),
        threshold=rng.integers(30, 200, size=N).astype(np.int32),
        threshold_out=np.ones(1, np.int32),
        dt=1e-3,
        weight_scale=1.0,
    )


def make_spikes(seed, B=3, T=50, C=12, p=0.15, max_count=2):
    rng = np.random.default_rng(seed + 1000)
    return (rng.random((B, T, C)) < p).astype(np.int32) * rng.integers(
        1, max_count + 1, size=(B, T, C)
    ).astype(np.int32)


def saturating_config(seed=11):
    cfg = make_config(seed, w_scale=5000)
    cfg.threshold[:] = 25_000
    return cfg


@pytest.mark.parametrize("seed,rec_coef,T,p,max_count", [
    (0, 0, 50, 0.15, 2), (1, -3, 50, 0.15, 2), (2, -1, 50, 0.15, 2), (7, -2, 53, 0.15, 2),
])
def test_torch_sim_hidden_matches_jax(seed, rec_coef, T, p, max_count):
    cfg = make_config(seed, rec_coef=rec_coef)
    spikes = make_spikes(seed, T=T, p=p, max_count=max_count)
    ref = np.asarray(jax_sim_batch(cfg, jnp.asarray(spikes)))
    got = sim_hidden_batch(cfg, torch.as_tensor(spikes)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def test_torch_sim_hidden_saturation_matches_jax():
    # huge weights + dense spikes drive isyn/vmem into the 16-bit clip
    cfg = saturating_config()
    spikes = make_spikes(11, p=0.9, max_count=3)
    ref = np.asarray(jax_sim_batch(cfg, jnp.asarray(spikes)))
    got = sim_hidden_batch(cfg, torch.as_tensor(spikes)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def bipolar_masks(seed, T, B, C, p):
    rng = np.random.default_rng(seed)
    return rng.random((T, B, C)) < p, rng.random((T, B, C)) < p


BIPOLAR_CASES = ["random", "recurrent", "saturating", "collisions", "ragged"]


@pytest.mark.parametrize("case", BIPOLAR_CASES)
def test_torch_lif_count_bipolar_matches_jax(case):
    T, B, p = 64, 3, 0.15
    if case == "random":
        cfg = make_config(3)
    elif case == "recurrent":
        cfg = make_config(4, rec_coef=-2)
    elif case == "saturating":
        cfg, p = saturating_config(), 0.9
    elif case == "collisions":  # kp & kn both set: the negative spike wins
        cfg, p = make_config(5), 0.6
    else:
        cfg, T, B = make_config(6), 53, 5
    kp, kn = bipolar_masks(BIPOLAR_CASES.index(case), T, B, 6, p)
    if case == "collisions":
        assert (kp & kn).any()
    before = dict(_build.launch_counts)
    got = lif_kernel.lif_count_rates_bipolar(cfg, torch.as_tensor(kp), torch.as_tensor(kn))
    ref = np.asarray(jax_lif_bipolar(cfg, jnp.asarray(kp), jnp.asarray(kn), spike_bound=1))
    assert got.dtype == torch.int32 and got.shape == (B, 20)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0
    assert dict(_build.launch_counts) == before  # CPU tensors: plain path, no launch


def test_torch_lif_collision_rule():
    """pos = kp & ~kn: a collision feeds only the negative channel."""
    cfg = make_config(8, C=2, N=3)
    kp = np.zeros((10, 1, 1), bool)
    kn = np.zeros((10, 1, 1), bool)
    kp[:, 0, 0] = kn[:, 0, 0] = True
    got = lif_kernel.lif_count_rates_bipolar(cfg, torch.as_tensor(kp), torch.as_tensor(kn))
    only_neg = lif_kernel.lif_count_rates_bipolar(
        cfg, torch.as_tensor(np.zeros_like(kp)), torch.as_tensor(kn))
    torch.testing.assert_close(got, only_neg, rtol=0, atol=0)
    ref = np.asarray(jax_lif_bipolar(cfg, jnp.asarray(kp), jnp.asarray(kn)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_torch_lif_flagship_config_matches_jax():
    demo = Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 449), fs=48_000, device="cpu")
    cfg = demo.xylo_config
    # RZCC-like density: about one spike per 27 samples per channel
    kp, kn = bipolar_masks(9, 600, 3, 14, 1 / 27)
    got = lif_kernel.lif_count_rates_bipolar(cfg, torch.as_tensor(kp), torch.as_tensor(kn))
    ref = np.asarray(jax_lif_bipolar(cfg, jnp.asarray(kp), jnp.asarray(kn), spike_bound=1))
    assert got.shape == (3, 449)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0


def test_torch_lif_rejects_dense_recurrence():
    cfg = make_config(10)
    cfg.w_rec[0, 1] = 5
    kp, kn = bipolar_masks(10, 8, 1, 6, 0.2)
    with pytest.raises(ValueError, match="uniform w_rec"):
        lif_kernel.lif_count_rates_bipolar(cfg, torch.as_tensor(kp), torch.as_tensor(kn))
