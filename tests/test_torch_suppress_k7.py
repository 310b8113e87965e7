"""Time-major greedy suppression of the PyTorch port on the CPU:
``select_by_distance_tm`` (kernel K7) and ``rzcc_select_bipolar_tm`` (kernel
K2) in ``ops/cuda/suppress_kernel.py`` run their plain versions on CPU
tensors, held bit-exact against the JAX ops in interpret mode (the Pallas
kernels ``_round_kernel`` and ``_round_kernel_bipolar``) on the case families
of ``tests/test_pallas_suppress.py``.  The CUDA kernels are held against the
same plain versions on the card by ``chip_smoke.py`` (phase 15)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from haghighatshoarmuir2024_tpu.ops import peaks as jax_peaks
from haghighatshoarmuir2024_tpu.ops.pallas import suppress_kernel as jax_sk

from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
from haghighatshoarmuir2024_tpu_torch.ops.cuda import suppress_kernel as sk


def family(kind: str):
    """(candidates, heights), row-major (rows, T), as tests/test_pallas_suppress.py
    builds them."""
    if kind == "random":
        x = np.cumsum(np.random.default_rng(0).standard_normal((5, 400)).astype(np.float32), axis=-1)
        return np.asarray(jax_peaks.local_maxima_mask(jnp.asarray(x))), x
    if kind == "dense":  # candidates everywhere: long chains, many rounds
        h = np.random.default_rng(1).standard_normal((3, 257)).astype(np.float32)
        return np.ones_like(h, bool), h
    if kind == "ties":  # bit-identical heights inside one window: rightmost wins
        h = np.zeros((1, 64), np.float32)
        cand = np.zeros((1, 64), bool)
        h[0, [10, 15, 40, 45, 50]] = 1.0
        cand[0, [10, 15, 40, 45, 50]] = True
        return cand, h
    if kind == "ragged":  # T not a multiple of 8, rows not of the lane tile
        h = np.cumsum(np.random.default_rng(2).standard_normal((9, 203)).astype(np.float32), axis=-1)
        return np.asarray(jax_peaks.local_maxima_mask(jnp.asarray(h))), h
    if kind == "empty":
        return np.zeros((1, 100), bool), np.linspace(0, 1, 100, dtype=np.float32)[None, :]
    raise ValueError(kind)


def tm(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a.T))


@pytest.fixture
def no_library(monkeypatch):
    """The CPU path must neither load the kernel library nor count a launch."""
    def refuse():
        raise AssertionError("the CPU path must not load the CUDA library")

    monkeypatch.setattr(sk, "library", refuse)
    before = dict(_build.launch_counts)
    yield
    assert dict(_build.launch_counts) == before


@pytest.mark.parametrize("kind,d", [("random", 3), ("random", 12), ("dense", 5), ("ties", 6), ("ties", 40),
                                    ("ragged", 5), ("empty", 5), ("random", 1)])
def test_torch_select_by_distance_tm_matches_pallas(kind, d, no_library):
    cand, h = family(kind)
    got = sk.select_by_distance_tm(tm(cand), tm(h), d)
    ref = np.asarray(jax_sk.select_by_distance_tm(jnp.asarray(cand.T), jnp.asarray(h.T), d, interpret=True))
    assert got.dtype == torch.bool and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == "ties" and d == 6:
        assert got[15, 0] and not got[10, 0]
    if kind == "empty":
        assert not got.any()


@pytest.mark.parametrize("d", [3, 12])
def test_torch_rzcc_select_bipolar_tm_matches_pallas(d, no_library):
    cs = np.cumsum(np.random.default_rng(5).standard_normal((6, 500)).astype(np.float32), axis=-1)
    maxima, minima = (np.asarray(m) for m in jax_peaks.local_extrema_mask_bounded(jnp.asarray(cs), 24))
    kp, kn = sk.rzcc_select_bipolar_tm(tm(cs), tm(maxima), tm(minima), d)
    jp, jn = jax_sk.rzcc_select_bipolar_tm(jnp.asarray(cs.T), jnp.asarray(maxima.T), jnp.asarray(minima.T), d,
                                           interpret=True)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(kn.numpy(), np.asarray(jn))
    assert kp.any() and kn.any()


@pytest.mark.parametrize("kind", ["random", "dense", "ties", "ragged"])
def test_torch_k7_rounds_compose_to_selection(kind):
    """K7's split of the work (one launch = one round, repeated while a
    candidate remains) reaches the plain selection's fixed point."""
    cand, h = family(kind)
    w = sk._windows(11, 1)[0]
    act, kept = tm(cand), torch.zeros_like(tm(cand))
    rounds = 0
    while bool(act.any()):
        act, kept = sk._k7_plain(tm(h), act, kept, w)
        rounds += 1
    assert rounds <= cand.shape[1]
    assert torch.equal(kept, sk.select_by_distance_tm_plain(tm(cand), tm(h), 11))


def test_torch_select_by_distance_tm_nonfinite_heights():
    """A -inf height where there is no candidate changes nothing, as in JAX's
    ``select_by_distance``; at a candidate the JAX op never reaches its fixed
    point, and the port rejects it up front."""
    cand, h = family("random")
    h = h.copy()
    h[0, np.flatnonzero(~cand[0])[:5]] = -np.inf
    got = sk.select_by_distance_tm(tm(cand), tm(h), 12)
    ref = np.asarray(jax_peaks.select_by_distance(jnp.asarray(cand), jnp.asarray(h), 12))
    np.testing.assert_array_equal(got.numpy().T, ref)
    h[0, np.flatnonzero(cand[0])[0]] = -np.inf
    with pytest.raises(ValueError, match="non-finite"):
        sk.select_by_distance_tm(tm(cand), tm(h), 12)
    cs = family("ragged")[1].copy()
    maxima, minima = (m.numpy() for m in sk.peaks.local_extrema_mask_bounded(torch.as_tensor(cs), 24))
    cs[2, np.flatnonzero(minima[2])[0]] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        sk.rzcc_select_bipolar_tm(tm(cs), tm(maxima), tm(minima), 12)


@pytest.mark.parametrize("d", [0.5, 1])
def test_torch_select_by_distance_tm_no_window_returns_candidates(d):
    cand, h = family("random")
    got = sk.select_by_distance_tm(tm(cand.astype(np.int8)), tm(h), d)
    assert got.dtype == torch.bool and torch.equal(got, tm(cand))
