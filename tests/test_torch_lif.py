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
    _lif_count_bipolar_impl,
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
    got = sim_hidden_batch(cfg, torch.as_tensor(spikes), device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def test_torch_sim_hidden_saturation_matches_jax():
    # huge weights + dense spikes drive isyn/vmem into the 16-bit clip
    cfg = saturating_config()
    spikes = make_spikes(11, p=0.9, max_count=3)
    ref = np.asarray(jax_sim_batch(cfg, jnp.asarray(spikes)))
    got = sim_hidden_batch(cfg, torch.as_tensor(spikes), device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def bipolar_masks(seed, T, B, C, p):
    rng = np.random.default_rng(seed)
    return rng.random((T, B, C)) < p, rng.random((T, B, C)) < p


# the families K3's words and groups of steps meet: dense masks (most of the
# 2C bits set on every step), C = 32 (64-bit words), C = 33, 42 (the
# three-band model's) and 64 (128-bit words) and C = 1, one batch row, T
# around the chain's group of 8 steps
BIPOLAR_CASES = ["random", "recurrent", "saturating", "collisions", "ragged", "dense", "C=32", "C=1",
                 "B=1", "T=1", "T=7", "T=9", "T=33", "C=33", "C=42", "C=64"]


def pallas_k3(cfg, kp, kn):
    """The Pallas K3 itself, in interpret mode (clips kept)."""
    return np.asarray(_lif_count_bipolar_impl(
        jnp.asarray(kp, jnp.int8), jnp.asarray(kn, jnp.int8), jnp.asarray(cfg.w_in, jnp.int32),
        jnp.asarray(cfg.dash_syn, jnp.int32), jnp.asarray(cfg.dash_mem, jnp.int32),
        jnp.asarray(cfg.threshold, jnp.int32), rec_coef=int(np.asarray(cfg.w_rec).flat[0]), time_chunk=8,
        interpret=True, int8_mm=bool(np.all(np.abs(cfg.w_in) <= 127))))


@pytest.mark.parametrize("case", BIPOLAR_CASES)
def test_torch_lif_count_bipolar_matches_jax(case):
    T, B, C, p = 64, 3, 6, 0.15
    if case == "random":
        cfg = make_config(3)
    elif case == "recurrent":
        cfg = make_config(4, rec_coef=-2)
    elif case == "saturating":
        cfg, p = saturating_config(), 0.9
    elif case == "collisions":  # kp & kn both set: the negative spike wins
        cfg, p = make_config(5), 0.6
    elif case == "ragged":
        cfg, T, B = make_config(6), 53, 5
    elif case == "dense":
        cfg, C, p = make_config(14, C=28, N=30, w_scale=3), 14, 0.9
    elif case.startswith("C="):
        C = int(case[2:])
        cfg, p = make_config(15 + C, C=2 * C, N=24, w_scale=8), 0.1 if C >= 32 else 0.5
    elif case == "B=1":
        cfg, B = make_config(16), 1
    else:
        T = int(case[2:])
        cfg = make_config(17, w_scale=200 if T == 1 else 20)  # one step can fire
    kp, kn = bipolar_masks(BIPOLAR_CASES.index(case), T, B, C, p)
    if case == "collisions":
        assert (kp & kn).any()
    before = dict(_build.launch_counts)
    got = lif_kernel.lif_count_rates_bipolar(cfg, torch.as_tensor(kp), torch.as_tensor(kn))
    ref = np.asarray(jax_lif_bipolar(cfg, jnp.asarray(kp), jnp.asarray(kn), spike_bound=1))
    N = cfg.w_in.shape[1]
    assert got.dtype == torch.int32 and got.shape == (B, N)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(pallas_k3(cfg, kp, kn), ref)
    assert ref.sum() > 0
    assert dict(_build.launch_counts) == before  # CPU tensors: plain path, no launch


def numpy_pack(kp, kn, steps):
    """(T, B, C) masks → (B, steps, 2) uint64 mask words, bits 0-63 then
    64-127 (bit c = kp & ~kn, bit C + c = kn), (B, steps) slots (the six
    lowest set bits c as bytes c + 1) and (B, steps // 32) the most set bits
    a step of each 32 has; zeros past T."""
    T, B, C = kp.shape
    kp, kn = kp != 0, kn != 0
    bits = np.concatenate([kp & ~kn, kn], axis=-1)  # (T, B, 2C)
    words = np.zeros((B, steps, 2), np.uint64)
    slots = np.zeros((B, steps), np.uint64)
    count = np.zeros((B, steps), np.int64)
    for t in range(T):
        for b in range(B):
            set_bits = np.flatnonzero(bits[t, b])
            word = sum(1 << int(c) for c in set_bits)
            words[b, t] = word & (2**64 - 1), word >> 64
            slots[b, t] = sum(int(c + 1) << (8 * k) for k, c in enumerate(set_bits[:6]))
            count[b, t] = len(set_bits)
    return words, slots, count.reshape(B, steps // 32, 32).max(axis=-1)


@pytest.mark.parametrize("C,T,B,p,dtype", [(1, 40, 3, 0.5, np.bool_), (14, 100, 5, 0.1, np.uint8),
                                           (14, 70, 2, 0.5, np.bool_), (32, 33, 2, 0.5, np.int8),
                                           (16, 64, 9, 0.5, np.bool_), (33, 40, 3, 0.5, np.bool_),
                                           (42, 70, 2, 0.1, np.uint8), (64, 33, 2, 0.5, np.int8)])
def test_torch_pack_bipolar_masks_plain_matches_numpy(C, T, B, p, dtype):
    """The pack pass's plain version against a numpy bit-pack with the
    collision rule: 32-bit mask words where 2C <= 32 (bit 31 set at C = 16),
    64-bit where 2C <= 64 (bit 63 set at C = 32), else two 64-bit words
    (bit 127 set at C = 64); the slots of the six lowest set bits (bytes up
    to 128); the most set bits of each 32 steps; rows T rounded up to
    PACK_STEPS."""
    rng = np.random.default_rng(C)
    kp = (rng.random((T, B, C)) < p) * rng.integers(1, 100, size=(T, B, C))
    kn = (rng.random((T, B, C)) < p) * rng.integers(1, 100, size=(T, B, C))
    kp, kn = kp.astype(dtype), kn.astype(dtype)
    got = lif_kernel.pack_bipolar_masks(torch.as_tensor(kp), torch.as_tensor(kn))
    steps = -(-T // lif_kernel.PACK_STEPS) * lif_kernel.PACK_STEPS
    words, slots, most = numpy_pack(kp, kn, steps)
    assert got.slots.shape == (B, steps) and got.most.shape == (B, steps // 32)
    assert got.slots.dtype == torch.int64 and got.most.dtype == torch.int32
    as_u32 = lambda x: x.numpy().astype(np.int64) & 0xFFFFFFFF  # noqa: E731
    if 2 * C <= 32:
        assert got.words.dtype == torch.int32 and got.words.shape == (B, steps)
        np.testing.assert_array_equal(as_u32(got.words), words[..., 0].astype(np.int64))
    elif 2 * C <= 64:
        assert got.words.dtype == torch.int64 and got.words.shape == (B, steps)
        np.testing.assert_array_equal(got.words.numpy().view(np.uint64), words[..., 0])
    else:
        assert got.words.dtype == torch.int64 and got.words.shape == (B, steps, 2)
        np.testing.assert_array_equal(got.words.numpy().view(np.uint64), words)
    np.testing.assert_array_equal(got.slots.numpy().view(np.uint64), slots)
    np.testing.assert_array_equal(got.most.numpy(), most)
    top = 2 * C - 1  # the top bit is exercised
    assert (words[..., top // 64] >> np.uint64(top % 64)).any()
    if C > 32 and p < 0.5:  # sparse: some step's sixth slot names a bit of the high word
        assert (slots >> np.uint64(40)).max() > 64
    assert (kp.astype(bool) & kn.astype(bool)).any()
    if 2 * C > 6 and p >= 0.5:
        assert most.max() > 6  # dense masks overflow the six slots


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
