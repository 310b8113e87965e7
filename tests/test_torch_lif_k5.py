"""Kernels K5 and K6 of the PyTorch port on the CPU: the plain versions
behind ``lif_count_rates`` / ``lif_count_stateful`` (``ops/cuda/lif_kernel``)
against the JAX package's Pallas kernels ``_lif_count_impl`` /
``_lif_count_stateful_impl`` in interpret mode, on the cases that
``chip_smoke.py`` holds the CUDA kernels to, at small sizes: binary and
multi-count rasters, negative values, the clip path, C = 33, 65, 84 and 128
(across the CUDA kernels' k-tiles of 16 channels), weights outside int8 (the
Pallas float32 product, the CUDA kernels' byte planes), ragged T (the Pallas
``has_tail`` path), rec_coef = -1, carried state.  All integers: bit-exact.
``tests/test_torch_lif_mma.py`` holds a model of the CUDA body itself."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from haghighatshoarmuir2024_tpu.ops.pallas.lif_kernel import (
    _lif_count_impl,
    _lif_count_stateful_impl,
    lif_count_rates as jax_lif_count_rates,
)

from haghighatshoarmuir2024_tpu_torch.models.xylo import XyloConfig
from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel


def make_config(seed, C, N=24, rec_coef=0, w_scale=20):
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


def make_raster(seed, T, B, C, p, lo=1, hi=2):
    """(T, B, C) int8: nonzero with probability p, values in [lo, hi)."""
    rng = np.random.default_rng(seed + 1000)
    v = np.where(rng.random((T, B, C)) < p, rng.integers(lo, hi, size=(T, B, C)), 0)
    return v.astype(np.int8)


def rec_of(cfg):
    return int(np.asarray(cfg.w_rec).flat[0])


def jax_args(cfg):
    return (jnp.asarray(cfg.w_in, jnp.int32), jnp.asarray(cfg.dash_syn, jnp.int32),
            jnp.asarray(cfg.dash_mem, jnp.int32), jnp.asarray(cfg.threshold, jnp.int32))


def pallas_k5(cfg, spikes_tbc, no_sat=False):
    return np.asarray(_lif_count_impl(
        jnp.asarray(spikes_tbc), *jax_args(cfg), rec_coef=rec_of(cfg), time_chunk=8,
        interpret=True, int8_mm=bool(np.all(np.abs(cfg.w_in) <= 127)), no_sat=no_sat))


def pallas_k6(cfg, spikes_tbc, state, no_sat=False):
    return [np.array(a) for a in _lif_count_stateful_impl(
        jnp.asarray(spikes_tbc), *jax_args(cfg), *(jnp.asarray(s, jnp.int32) for s in state),
        rec_coef=rec_of(cfg), time_chunk=8, interpret=True,
        int8_mm=bool(np.all(np.abs(cfg.w_in) <= 127)), no_sat=no_sat)]


def wide(seed, C, w_max, **kw):
    """A config whose weights reach ±``w_max``, outside int8."""
    cfg = make_config(seed, C, w_scale=w_max, **kw)
    cfg.w_in[0, 0], cfg.w_in[1, 1] = w_max, -w_max
    assert lif_kernel.weight_planes(cfg.w_in) > 1
    return cfg


def saturating(seed, C):
    cfg = make_config(seed, C, w_scale=5000)
    cfg.threshold[:] = 25_000
    return cfg


# (label, config, raster, spike_bound): the [K5] cases of chip_smoke.py, small
K5_CASES = [
    ("binary, C=14", lambda: make_config(0, 14), lambda: make_raster(0, 48, 3, 14, 0.1), 1),
    ("bipolar combined raster, C=28, B=1", lambda: make_config(1, 28), lambda: make_raster(1, 40, 1, 28, 0.1), 1),
    ("values 0..15, clip path", lambda: make_config(2, 14, w_scale=400), lambda: make_raster(2, 40, 2, 14, 0.5, 0, 16), None),
    ("negative values", lambda: make_config(3, 20), lambda: make_raster(3, 40, 2, 20, 0.3, -20, 20), 20),
    ("C=84", lambda: make_config(4, 84), lambda: make_raster(4, 32, 2, 84, 0.05, -3, 4), 3),
    ("C=128", lambda: make_config(5, 128), lambda: make_raster(5, 32, 2, 128, 0.05, -3, 4), 3),
    ("ragged T=37 (has_tail)", lambda: make_config(6, 14), lambda: make_raster(6, 37, 2, 14, 0.2), 1),
    ("rec_coef=-1", lambda: make_config(7, 14, rec_coef=-1), lambda: make_raster(7, 45, 4, 14, 0.2), 1),
    ("B=3, rec_coef=-2, ragged T=29", lambda: make_config(8, 14, rec_coef=-2), lambda: make_raster(8, 29, 3, 14, 0.2), 1),
    ("C=33", lambda: make_config(18, 33), lambda: make_raster(18, 40, 2, 33, 0.2, -5, 6), None),
    ("C=65", lambda: make_config(19, 65, w_scale=8), lambda: make_raster(19, 33, 2, 65, 0.1, -3, 4), 3),
    ("|w| up to 128: two byte planes", lambda: wide(20, 14, 128), lambda: make_raster(20, 40, 2, 14, 0.3, 0, 4), None),
    ("|w| up to 20000, rec_coef=-1", lambda: wide(21, 14, 20_000, rec_coef=-1), lambda: make_raster(21, 35, 3, 14, 0.3), None),
]


@pytest.mark.parametrize("label,cfg,spikes,bound", K5_CASES, ids=[c[0] for c in K5_CASES])
def test_torch_k5_plain_matches_pallas(label, cfg, spikes, bound):
    cfg, spikes = cfg(), spikes()
    no_sat = bound is not None and lif_kernel._no_saturation_possible(cfg, bound, rec_of(cfg))
    ref = pallas_k5(cfg, spikes, no_sat=no_sat)
    _build.launch_counts.clear()
    got = lif_kernel.lif_count_rates(cfg, torch.as_tensor(spikes), time_major=True, spike_bound=bound)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0
    assert not _build.launch_counts  # CPU tensors run the plain version and launch nothing


def test_torch_k5_clip_path_is_exercised():
    cfg = make_config(2, 14, w_scale=400)
    assert not lif_kernel._no_saturation_possible(cfg, 15, 0)
    spikes = make_raster(2, 40, 2, 14, 0.5, 0, 16)
    counts = lif_kernel.lif_count_rates(cfg, torch.as_tensor(spikes), time_major=True, spike_bound=None)
    # the clips bind: without them the dynamics differ
    free = pallas_k5(cfg, spikes, no_sat=True)
    assert not np.array_equal(free, counts.numpy())


def test_torch_k5_batch_major_and_dtypes_match_jax_wrapper():
    """``time_major=False`` takes (B, T, C); bool and wider integer rasters
    are accepted (the latter cast with ``.to(torch.int8)``), as the JAX
    wrapper's ``jnp.asarray(spikes, jnp.int8)``."""
    cfg = make_config(9, 12)
    spikes_btc = np.transpose(make_raster(9, 50, 3, 12, 0.3, 0, 3), (1, 0, 2))
    ref = np.asarray(jax_lif_count_rates(cfg, jnp.asarray(spikes_btc, jnp.int32)))
    for arr in (spikes_btc.astype(np.int32), spikes_btc.astype(np.int64), spikes_btc.astype(np.int8)):
        got = lif_kernel.lif_count_rates(cfg, torch.as_tensor(arr))
        np.testing.assert_array_equal(got.numpy(), ref)
    binary = spikes_btc > 0
    ref = np.asarray(jax_lif_count_rates(cfg, jnp.asarray(binary, jnp.int32)))
    np.testing.assert_array_equal(lif_kernel.lif_count_rates(cfg, torch.as_tensor(binary)).numpy(), ref)


# (label, config, raster, state0 raster or None, spike_bound): the [K6] cases
K6_CASES = [
    ("from zero", lambda: make_config(10, 14), 48, 0.15, None, 1),
    ("carried state", lambda: make_config(11, 14), 48, 0.15, 40, 1),
    ("ragged T=37, mid-stream (has_tail)", lambda: make_config(12, 14, N=40), 37, 0.2, 30, 1),
    ("clip path from a saturated state", lambda: saturating(13, 14), 33, 0.9, 30, None),
    ("rec_coef=-1, carried", lambda: make_config(14, 14, rec_coef=-1), 45, 0.2, 24, 1),
    ("multi-count, negative, C=84", lambda: make_config(15, 84), 32, 0.05, 24, None),
    ("C=33, mid-stream", lambda: make_config(22, 33), 40, 0.2, 24, 1),
    ("C=65, rec_coef=-1", lambda: make_config(23, 65, rec_coef=-1, w_scale=8), 33, 0.1, 24, 1),
    ("|w| up to 300, carried", lambda: wide(24, 14, 300), 47, 0.3, 30, None),
]


@pytest.mark.parametrize("label,cfg,T,p,T0,bound", K6_CASES, ids=[c[0] for c in K6_CASES])
def test_torch_k6_plain_matches_pallas(label, cfg, T, p, T0, bound):
    cfg = cfg()
    C, N = cfg.w_in.shape
    lo, hi = (-3, 4) if C == 84 else (1, 2)
    B = 3
    zeros = [np.zeros((B, N), np.int32)] * 3
    if T0 is None:
        state = zeros
    else:  # a mid-stream state from the same dynamics on earlier spikes
        state = pallas_k6(cfg, make_raster(100 + T0, T0, B, C, p, lo, hi), zeros)[1:]
    spikes = make_raster(T, T, B, C, p, lo, hi)
    no_sat = bound is not None and lif_kernel._no_saturation_possible(cfg, bound, rec_of(cfg))
    ref = pallas_k6(cfg, spikes, state, no_sat=no_sat)
    got = lif_kernel.lif_count_stateful(cfg, torch.as_tensor(spikes), *(torch.as_tensor(s) for s in state),
                                        spike_bound=bound, time_major=True)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r)
    assert ref[0].sum() > 0


def test_torch_k6_two_chunks_equal_one_pass():
    cfg = make_config(16, 14, rec_coef=-1)
    spikes = torch.as_tensor(make_raster(16, 90, 3, 14, 0.2))
    z = [torch.zeros((3, 24), dtype=torch.int32)] * 3
    first = lif_kernel.lif_count_stateful(cfg, spikes[:41], *z, spike_bound=1, time_major=True)
    second = lif_kernel.lif_count_stateful(cfg, spikes[41:], *first[1:], spike_bound=1, time_major=True)
    whole = lif_kernel.lif_count_stateful(cfg, spikes, *z, spike_bound=1, time_major=True)
    np.testing.assert_array_equal(whole[0].numpy(), (first[0] + second[0]).numpy())
    for a, b in zip(whole[1:], second[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        whole[0].numpy(), lif_kernel.lif_count_rates(cfg, spikes, time_major=True).numpy())


def test_torch_k5_wrappers_reject_bad_inputs_before_launch():
    cfg = make_config(17, 14)
    with pytest.raises(ValueError, match="uniform w_rec"):
        dense = make_config(17, 14)
        dense.w_rec[0, 1] = 3
        lif_kernel.lif_count_rates(dense, torch.zeros((5, 1, 14), dtype=torch.int8), time_major=True)
    with pytest.raises(ValueError):  # a CUDA kernel takes CUDA tensors only
        lif_kernel._check_raster(lif_kernel.lif_params(cfg, "cpu"), torch.zeros((5, 1, 14), dtype=torch.int8))
    # the fragments K5/K6 read are laid out at first use and kept, whatever made the params
    p = lif_kernel.lif_params(cfg, "cpu")
    assert "w_frag" not in vars(p) and lif_kernel.lif_params(p, "cpu") is p
    assert tuple(p.w_frag.shape) == (1, 1, 1, 4, 32) and p.w_frag is p.w_frag
    np.testing.assert_array_equal(p.w_frag.numpy(), lif_kernel.weight_fragments(np.asarray(cfg.w_in)))
