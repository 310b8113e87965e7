"""RZCC stage of the PyTorch port: the plain versions of kernels K1/K2
(``ops/peaks.py``) bit-exact against ``haghighatshoarmuir2024_tpu.ops.peaks``,
whose own tests hold the Pallas K1/K2 (interpret mode) equal to them; and the
``rzcc_encode_bipolar_tm`` wrapper on CPU tensors, which runs the plain path.
The CUDA kernels themselves are compared with these plain versions on the
card by ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from haghighatshoarmuir2024_tpu.ops import peaks as jax_peaks
from haghighatshoarmuir2024_tpu.ops.pallas import suppress_kernel as jax_sk

from haghighatshoarmuir2024_tpu_torch.ops import peaks
from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
from haghighatshoarmuir2024_tpu_torch.ops.cuda import suppress_kernel as sk


WINDOWS = [(3, 6), (12, 24), (24, 48), (80, 24)]  # (distance, W); (12, 24) is the flagship


def signal(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return np.cumsum(rng.standard_normal((6, 500)).astype(np.float32), axis=-1)
    if kind == "plateaus":
        cs = np.cumsum(rng.standard_normal((3, 257)).astype(np.float32), axis=-1)
        cs[:, 40:44] = cs[:, 40:41]
        cs[:, 100:103] = cs[:, 100:101]
        cs[:, 200:230] = cs[:, 200:201]  # longer than W for the narrow windows
        return cs
    if kind == "quantized":  # plateaus everywhere, some longer than W
        return (np.round(np.cumsum(rng.standard_normal((4, 600)), axis=-1) * 2) / 2).astype(np.float32)
    if kind == "ragged":
        return np.cumsum(rng.standard_normal((9, 203)).astype(np.float32), axis=-1)
    if kind == "drift":  # widely spaced extrema whose chains cross long spans
        t = np.arange(4000, dtype=np.float32)
        return np.cumsum(np.sin(2 * np.pi * t / 900.0)[None, :]
                         + 0.3 * rng.standard_normal((3, 4000)).astype(np.float32), axis=-1)
    raise ValueError(kind)


_jax_select = jax.jit(jax_peaks.select_by_distance, static_argnums=2)


def jax_select(cand, height, d) -> np.ndarray:
    return np.asarray(_jax_select(jnp.asarray(cand), jnp.asarray(height), d))


def port_select(cand, height, d) -> np.ndarray:
    return peaks.select_by_distance(torch.as_tensor(cand), torch.as_tensor(height), d).numpy()


@pytest.mark.parametrize("kind,d,W", [
    ("random", 3, 6), ("random", 12, 24), ("plateaus", 3, 6), ("plateaus", 12, 24),
    ("quantized", 3, 6), ("quantized", 12, 24), ("ragged", 12, 24), ("drift", 24, 48),
    ("drift", 80, 24),
])
def test_torch_local_extrema_and_selection_match_jax(kind, d, W):
    cs = signal(kind, seed=len(kind) + W)
    jmax, jmin = (np.asarray(m) for m in jax_peaks.local_extrema_mask_bounded(jnp.asarray(cs), W))
    tmax, tmin = (m.numpy() for m in peaks.local_extrema_mask_bounded(torch.as_tensor(cs), W))
    np.testing.assert_array_equal(tmax, jmax)
    np.testing.assert_array_equal(tmin, jmin)
    assert tmax.any() and tmin.any()
    np.testing.assert_array_equal(port_select(tmax, cs, d), jax_select(jmax, cs, d))
    np.testing.assert_array_equal(port_select(tmin, -cs, d), jax_select(jmin, -cs, d))


@pytest.mark.parametrize("d", [6, 11, 40])
def test_torch_select_exact_ties_go_rightmost(d):
    h = np.zeros((1, 64), np.float32)
    cand = np.zeros((1, 64), bool)
    h[0, [10, 15, 40, 45, 50]] = 1.0
    cand[0, [10, 15, 40, 45, 50]] = True
    got = port_select(cand, h, d)
    np.testing.assert_array_equal(got, jax_select(cand, h, d))
    if d == 6:
        assert got[0, 15] and not got[0, 10]


@pytest.mark.parametrize("d", [1, 2, 5, 11])
def test_torch_select_dense_chains(d):
    h = np.random.default_rng(1).standard_normal((3, 257)).astype(np.float32)
    cand = np.ones_like(h, bool)
    np.testing.assert_array_equal(port_select(cand, h, d), jax_select(cand, h, d))


def test_torch_select_empty_candidates():
    h = np.linspace(0, 1, 100, dtype=np.float32)[None, :]
    cand = np.zeros((1, 100), bool)
    assert not port_select(cand, h, 5).any()


@pytest.mark.parametrize("d,W", WINDOWS[1:])
def test_torch_rzcc_wrapper_cpu_runs_plain_path(d, W, monkeypatch):
    """On CPU tensors the wrapper never touches the kernel library and
    equals the JAX wrapper (CPU: XLA extrema + suppression)."""
    def no_library():
        raise AssertionError("the CPU path must not load the CUDA library")

    monkeypatch.setattr(sk, "library", no_library)
    before = dict(_build.launch_counts)
    cs = signal("drift", seed=d)
    kp, kn = sk.rzcc_encode_bipolar_tm(torch.as_tensor(np.ascontiguousarray(cs.T)), d, W)
    jp, jn = jax_sk.rzcc_encode_bipolar_tm(jnp.asarray(cs.T), d, W)
    assert kp.dtype == torch.bool and kp.shape == (4000, 3)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(kn.numpy(), np.asarray(jn))
    assert dict(_build.launch_counts) == before


@pytest.mark.parametrize("kind", ["random", "plateaus", "quantized", "drift"])
def test_torch_k1_then_k2_rounds_compose_to_selection(kind):
    """The kernels' split of the work — K1: extrema + round 1; K2: one
    round, repeated — reaches the same fixed point as the plain selection."""
    cs_tm = torch.as_tensor(np.ascontiguousarray(signal(kind, seed=3).T))
    w, W = sk._windows(12, 24)
    ap, an, kp, kn = sk._k1_plain(cs_tm, w, W)
    while bool(ap.any() or an.any()):
        ap, an, kp, kn = sk._k2_plain(cs_tm, ap, an, kp, kn, w)
    rp, rn = sk.rzcc_encode_bipolar_tm_plain(cs_tm, 12, 24)
    assert torch.equal(kp, rp) and torch.equal(kn, rn)


@pytest.mark.parametrize("w,W,rounds", [(11, 24, 1), (11, 24, 2), (23, 48, 1), (79, 24, 1), (11, 0, 1)])
def test_torch_halo_margin_matches_jax(w, W, rounds):
    assert sk._margin(w, W, rounds) == jax_sk._margin(w, W, rounds)
