"""Stateful LIF of the PyTorch port (the plain twin of kernel K4 and the
``lif_count_stateful_bipolar`` wrapper on CPU tensors) against the JAX
package's Pallas K4, ``_lif_count_bipolar_stateful_impl(interpret=True)``,
and its public ``lif_count_stateful_bipolar`` (whose CPU path is the
``_sim_hidden`` scan).  All integers: bit-exact on counts and on the final
isyn/vmem/spk.  The CUDA kernel K4 is compared with the plain twin on the
card by ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from haghighatshoarmuir2024_tpu.ops.pallas.lif_kernel import (
    _lif_count_bipolar_stateful_impl,
    lif_count_stateful_bipolar as jax_stateful_bipolar,
)

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo, XyloConfig
from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import sim_hidden
from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel


def make_config(seed, C=6, N=20, rec_coef=0, w_scale=20):
    """Random configs in the style of tests/test_pallas_lif.py; w_in has 2C
    rows (C channels per polarity)."""
    rng = np.random.default_rng(seed)
    return XyloConfig(
        w_in=rng.integers(-w_scale, w_scale + 1, size=(2 * C, N)).astype(np.int32),
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


def bipolar_masks(seed, T, B, C, p):
    rng = np.random.default_rng(seed)
    return rng.random((T, B, C)) < p, rng.random((T, B, C)) < p


def pallas_k4(cfg, kp, kn, state):
    """The Pallas K4 itself, in interpret mode (clips kept; the int8 MXU
    projection only where the weights fit int8, as its public entry picks)."""
    rec = int(np.asarray(cfg.w_rec).flat[0])
    out = _lif_count_bipolar_stateful_impl(
        jnp.asarray(kp, jnp.int8), jnp.asarray(kn, jnp.int8),
        jnp.asarray(cfg.w_in, jnp.int32), jnp.asarray(cfg.dash_syn, jnp.int32),
        jnp.asarray(cfg.dash_mem, jnp.int32), jnp.asarray(cfg.threshold, jnp.int32),
        *(jnp.asarray(s, jnp.int32) for s in state),
        rec_coef=rec, time_chunk=8, interpret=True,
        int8_mm=bool(np.all(np.abs(cfg.w_in) <= 127)),
    )
    return [np.asarray(o) for o in out]


def port_k4(cfg, kp, kn, state):
    return [t.numpy() for t in lif_kernel.lif_count_stateful_bipolar_plain(
        cfg, torch.as_tensor(kp), torch.as_tensor(kn), *(torch.as_tensor(s) for s in state))]


def mid_stream_state(cfg, B, C, seed):
    """A state the dynamics reach after 40 steps of random masks."""
    kp, kn = bipolar_masks(seed + 500, 40, B, C, 0.3)
    _, *state = port_k4(cfg, kp, kn, [np.zeros((B, cfg.w_in.shape[1]), np.int32)] * 3)
    return state


CASES = {
    # name: (config, T, B, p)
    "random": (make_config(0), 40, 3, 0.15),
    "recurrent": (make_config(1, rec_coef=-1), 48, 3, 0.3),
    "ragged": (make_config(2), 37, 5, 0.2),
    "saturating": (make_config(3, w_scale=5000), 30, 3, 0.9),
    "saturating recurrent": (make_config(4, rec_coef=-1, w_scale=5000), 29, 2, 0.9),
    # the families K4's words and groups of steps meet: dense masks, C = 32
    # (64-bit words) and C = 1, one batch row, T around the chain's group of
    # 8 steps
    "dense": (make_config(5, C=14, N=30, w_scale=3), 40, 2, 0.9),
    "C=32": (make_config(6, C=32, N=24, w_scale=8), 40, 2, 0.1),
    "C=1": (make_config(7, C=1, N=16, w_scale=60), 40, 3, 0.5),
    "B=1": (make_config(8), 40, 1, 0.2),
    "T=1": (make_config(9, w_scale=200), 1, 3, 0.5),
    "T=7": (make_config(10), 7, 3, 0.3),
    "T=9": (make_config(11), 9, 3, 0.3),
    # 128-bit mask words: C = 33, the three-band model's C = 42, and C = 64
    "C=33": (make_config(12, C=33, N=24, w_scale=8), 40, 2, 0.1),
    "C=42": (make_config(13, C=42, N=30, w_scale=8), 40, 2, 0.1),
    "C=64": (make_config(14, C=64, N=24, w_scale=4), 40, 2, 0.3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_stateful_lif_matches_pallas_k4(case):
    cfg, T, B, p = CASES[case]
    if case.startswith("saturating"):
        cfg.threshold[:] = 25_000
        assert not lif_kernel._no_saturation_possible(cfg, 1, int(cfg.w_rec.flat[0]))
    C = cfg.w_in.shape[0] // 2
    kp, kn = bipolar_masks(list(CASES).index(case), T, B, C, p)
    state = mid_stream_state(cfg, B, C, list(CASES).index(case))
    assert np.abs(state[1]).max() > 0 and state[2].any()  # a real mid-stream state

    ref = pallas_k4(cfg, kp, kn, state)
    got = port_k4(cfg, kp, kn, state)
    for g, r in zip(got, ref):
        assert g.dtype == np.int32 and g.shape == (B, cfg.w_in.shape[1])
        np.testing.assert_array_equal(g, r)
    assert ref[0].sum() > 0

    # the public JAX entry (its CPU path, the _sim_hidden scan) and the port's
    # wrapper on CPU tensors: the plain path, no launch
    jax_out = jax_stateful_bipolar(cfg, jnp.asarray(kp), jnp.asarray(kn),
                                   *(jnp.asarray(s) for s in state), spike_bound=None)
    before = dict(_build.launch_counts)
    wrapped = lif_kernel.lif_count_stateful_bipolar(
        cfg, torch.as_tensor(kp), torch.as_tensor(kn), *(torch.as_tensor(s) for s in state),
        spike_bound=None)
    assert dict(_build.launch_counts) == before
    for w, j, g in zip(wrapped, jax_out, got):
        np.testing.assert_array_equal(w.numpy(), g)
        np.testing.assert_array_equal(np.asarray(j), g)


@pytest.mark.parametrize("rec_coef", [0, -1])
def test_torch_stateful_lif_chunked_equals_full(rec_coef):
    """Three carried chunks (ragged: 30 + 17 + 24) == one pass of 71 steps,
    and the Pallas K4 carried the same way agrees chunk by chunk."""
    cfg = make_config(10 + rec_coef, rec_coef=rec_coef, w_scale=25)
    B, C, N = 3, 6, 20
    kp, kn = bipolar_masks(20, 71, B, C, 0.25)
    zeros = [np.zeros((B, N), np.int32)] * 3
    full = port_k4(cfg, kp, kn, zeros)
    state_t, state_j = zeros, zeros
    total = np.zeros((B, N), np.int64)
    for lo, hi in ((0, 30), (30, 47), (47, 71)):
        counts, *state_t = port_k4(cfg, kp[lo:hi], kn[lo:hi], state_t)
        counts_j, *state_j = pallas_k4(cfg, kp[lo:hi], kn[lo:hi], state_j)
        np.testing.assert_array_equal(counts, counts_j)
        total += counts
    np.testing.assert_array_equal(total, full[0])
    for a, b, c in zip(state_t, full[1:], state_j):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert full[0].sum() > 0


def test_torch_stateful_lif_flagship_config_matches_jax():
    demo = Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 449), fs=48_000, device="cpu")
    cfg = demo.xylo_config
    # RZCC-like density: about one spike per 27 samples per channel
    kp, kn = bipolar_masks(9, 300, 2, 14, 1 / 27)
    state = mid_stream_state(cfg, 2, 14, 9)
    got = port_k4(cfg, kp, kn, state)
    ref = jax_stateful_bipolar(cfg, jnp.asarray(kp), jnp.asarray(kn), *(jnp.asarray(s) for s in state),
                               spike_bound=1)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert got[0].shape == (2, 449) and got[0].sum() > 0


def test_torch_sim_hidden_state_passes_through_empty_chunk():
    cfg = make_config(12)
    state = [torch.full((2, 20), v, dtype=torch.int32) for v in (5, -7, 1)]
    inp = torch.zeros((0, 2, 20), dtype=torch.int32)
    _, counts, final = sim_hidden(inp, cfg.dash_syn, cfg.dash_mem, cfg.threshold, -1,
                                  record=False, state0=state)
    assert int(counts.abs().sum()) == 0
    for a, b in zip(final, state):
        assert torch.equal(a, b)


def test_torch_lif_params_no_saturation_proof():
    """The flagship config with binary spikes proves the clips dead (the
    kernel then skips them); the saturating config does not."""
    demo = Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 449), fs=48_000, device="cpu")
    p = lif_kernel.lif_params(demo.xylo_config, "cpu", spike_bound=1)
    assert p.no_sat and p.rec_coef == 0 and p.w_in.shape == (28, 449) and p.w_in.dtype == torch.int32
    assert not lif_kernel.lif_params(demo.xylo_config, "cpu", spike_bound=None).no_sat
    sat = make_config(3, w_scale=5000)
    assert not lif_kernel.lif_params(sat, "cpu").no_sat
    assert lif_kernel.lif_params(p, "cpu") is p


def test_torch_stateful_lif_rejects_dense_recurrence():
    cfg = make_config(13)
    cfg.w_rec[0, 1] = 5
    kp, kn = bipolar_masks(13, 8, 1, 6, 0.2)
    z = torch.zeros((1, 20), dtype=torch.int32)
    with pytest.raises(ValueError, match="uniform w_rec"):
        lif_kernel.lif_count_stateful_bipolar(cfg, torch.as_tensor(kp), torch.as_tensor(kn), z, z, z)
