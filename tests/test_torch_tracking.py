"""``top_k_peaks`` and the DoA trackers of the PyTorch port against the JAX
package, on CPU tensors, from numpy seeds.

- ``top_k_peaks``: idx, valid exact and heights equal, with ties (equal
  heights come lower index first, as ``lax.top_k`` gives them), fewer
  peaks than k (idx 0, height -inf, valid False), ``rel_height``,
  ``max_plateau`` and a batch of rows equal to the rows one by one;
- the tensor trackers (``track_angles``, ``track_multi_angles``) against
  JAX's scans in float32 (JAX under ``jax.enable_x64(False)``): angles
  within 1e-6 rad, ``confirmed`` exact; batched lanes equal to the lanes
  one at a time;
- the host trackers (``DoaTracker``, ``MultiDoaTracker``, numpy copies)
  equal to JAX's exactly, and equal to the tensor scans to 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from haghighatshoarmuir2024_tpu.ops import peaks as jax_peaks
from haghighatshoarmuir2024_tpu.utils import tracking as jax_tracking

from haghighatshoarmuir2024_tpu_torch.ops.peaks import top_k_peaks
from haghighatshoarmuir2024_tpu_torch.utils import tracking


def profile(seed, G=96):
    """A smooth multi-peak angular profile with plateaus and exact ties."""
    rng = np.random.default_rng(seed)
    g = np.arange(G)
    x = sum(rng.uniform(0.2, 1.0) * np.exp(-0.5 * ((g - rng.uniform(0, G)) / rng.uniform(1.5, 6)) ** 2)
            for _ in range(6))
    x = np.round(x, 2)  # ties and plateaus
    return x.astype(np.float32)


def jax_top_k(x, k, **kw):
    with jax.enable_x64(False):
        idx, h, v = jax_peaks.top_k_peaks(jnp.asarray(x), k, **kw)
    return np.asarray(idx), np.asarray(h), np.asarray(v)


CASES = [
    dict(k=3),
    dict(k=4, distance=5),
    dict(k=2, distance=12, rel_height=0.3),
    dict(k=8, distance=20),  # fewer peaks than k
    dict(k=3, distance=4, max_plateau=6),
]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_top_k_peaks_matches_jax(case, seed):
    case = dict(case)
    k = case.pop("k")
    x = profile(seed)
    idx, h, v = top_k_peaks(torch.as_tensor(x), k, **case)
    jidx, jh, jv = jax_top_k(x, k, **case)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(h.numpy(), jh)


def test_torch_top_k_peaks_ties_and_padding():
    """Four equal peaks: the lower indices come first; k beyond the peaks
    pads with idx 0, -inf, invalid."""
    x = np.zeros(40, np.float32)
    x[[30, 5, 18, 11]] = 1.0
    x[25] = 2.0
    idx, h, v = top_k_peaks(torch.as_tensor(x), 7)
    jidx, jh, jv = jax_top_k(x, 7)
    np.testing.assert_array_equal(idx.numpy(), [25, 5, 11, 18, 30, 0, 0])
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(h.numpy(), jh)
    assert np.isneginf(h.numpy()[5:]).all()


def test_torch_top_k_peaks_batched_rows():
    X = np.stack([profile(s) for s in range(5)])
    X[3] = 0.0  # a row without peaks
    idx, h, v = top_k_peaks(torch.as_tensor(X), 3, distance=6, rel_height=0.2)
    assert idx.shape == h.shape == v.shape == (5, 3)
    for r in range(5):
        jidx, jh, jv = jax_top_k(X[r], 3, distance=6, rel_height=0.2)
        np.testing.assert_array_equal(idx[r].numpy(), jidx)
        np.testing.assert_array_equal(v[r].numpy(), jv)
        np.testing.assert_array_equal(h[r].numpy(), jh)
    assert not v[3].any()


def angle_sequence(seed, T=60):
    """A moving target with outliers, crossing the ±π seam."""
    rng = np.random.default_rng(seed)
    base = np.angle(np.exp(1j * (2.6 + 0.07 * np.arange(T) + rng.normal(0, 0.03, T))))
    out = rng.random(T) < 0.15
    base[out] = rng.uniform(-np.pi, np.pi, out.sum())
    return base.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_track_angles_matches_jax(seed):
    z = angle_sequence(seed)
    with jax.enable_x64(False):
        want = np.asarray(jax_tracking.track_angles(jnp.asarray(z)))
    got = tracking.track_angles(torch.as_tensor(z), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    host = tracking.DoaTracker()
    jhost = jax_tracking.DoaTracker()
    h = np.array([host.update(v) for v in z])
    np.testing.assert_array_equal(h, [jhost.update(v) for v in z])
    np.testing.assert_allclose(h, want, rtol=0, atol=1e-6)
    # lanes of a (T, B) batch equal the lanes one at a time
    Z = np.stack([z, angle_sequence(seed + 10), angle_sequence(seed + 20)], axis=1)
    batch = tracking.track_angles(torch.as_tensor(Z), alpha=0.5, gate_deg=15.0, max_misses=2, device="cpu")
    for b in range(3):
        one = tracking.track_angles(torch.as_tensor(Z[:, b]), alpha=0.5, gate_deg=15.0, max_misses=2,
                                    device="cpu")
        np.testing.assert_array_equal(batch[:, b].numpy(), one.numpy())


def multi_sequence(seed, T=50, K=4):
    """Two crossing targets plus clutter: (T, K) candidates and validity."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    tracks = np.stack([1.0 + 0.03 * t, -2.8 - 0.05 * t], axis=1) + rng.normal(0, 0.02, (T, 2))
    z = np.concatenate([tracks, rng.uniform(-np.pi, np.pi, (T, K - 2))], axis=1)
    z = np.angle(np.exp(1j * z))
    valid = rng.random((T, K)) < np.array([0.9, 0.9, 0.3, 0.2])
    perm = np.argsort(rng.random((T, K)), axis=1)
    return (np.take_along_axis(z, perm, axis=1).astype(np.float32),
            np.take_along_axis(valid, perm, axis=1))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("num_tracks", [3, 5])
def test_torch_multi_track_matches_jax(seed, num_tracks):
    z, valid = multi_sequence(seed)
    kw = dict(max_misses=4, confirm_hits=2)
    with jax.enable_x64(False):
        jth, jcf = jax_tracking.track_multi_angles(jnp.asarray(z), jnp.asarray(valid), num_tracks, **kw)
    th, cf = tracking.track_multi_angles(torch.as_tensor(z), torch.as_tensor(valid), num_tracks, device="cpu",
                                         **kw)
    np.testing.assert_array_equal(cf.numpy(), np.asarray(jcf))
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=0, atol=1e-6)
    host, jhost = tracking.MultiDoaTracker(num_tracks, **kw), jax_tracking.MultiDoaTracker(num_tracks, **kw)
    for i in range(z.shape[0]):
        hth, hcf = host.update(z[i], valid[i])
        jhth, jhcf = jhost.update(z[i], valid[i])
        np.testing.assert_array_equal(hth, jhth)
        np.testing.assert_array_equal(hcf, jhcf)
        np.testing.assert_array_equal(hcf, cf[i].numpy())
        np.testing.assert_allclose(hth, th[i].numpy(), rtol=0, atol=1e-6)
    assert cf[-1].sum() >= 2  # both targets confirmed by the end


def test_torch_multi_track_batched_lanes():
    """(T, B, K) lanes tracked together equal each lane alone."""
    seqs = [multi_sequence(s) for s in range(3)]
    Z = np.stack([s[0] for s in seqs], axis=1)
    V = np.stack([s[1] for s in seqs], axis=1)
    th, cf = tracking.track_multi_angles(torch.as_tensor(Z), torch.as_tensor(V), 4, gate_deg=20.0, device="cpu")
    assert th.shape == cf.shape == (50, 3, 4)
    for b in range(3):
        th1, cf1 = tracking.track_multi_angles(torch.as_tensor(Z[:, b]), torch.as_tensor(V[:, b]), 4, gate_deg=20.0,
                                              device="cpu")
        np.testing.assert_array_equal(th[:, b].numpy(), th1.numpy())
        np.testing.assert_array_equal(cf[:, b].numpy(), cf1.numpy())
