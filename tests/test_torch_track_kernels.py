"""The routes of the port's last three recurrences on the CPU, against the
JAX package on the same numpy inputs, and models of their hand kernels:

- ``ops.envelope.Envelope.evolve`` (CUDA route ``csrc/envelope.cu``),
  ``utils.tracking.track_angles`` and ``track_multi_angles`` (CUDA route
  ``csrc/tracking.cu``): each CPU route against JAX's ``lax.scan`` from
  seeds.  Tolerances: the envelope in float64 within 1e-12 of JAX's peak
  (JAX under x64; ``tests/test_torch_signal_ops.py``'s), in float32 within
  4e-6 of it (JAX under ``jax.enable_x64(False)``: XLA contracts the
  update into a fused multiply-add, a last bit apart a step, and each
  step's difference is damped by 1 - 1/w; 6.6e-7 was seen on these
  inputs); the trackers' angles within 1e-6 rad and ``confirmed`` exact
  (``tests/test_torch_tracking.py``'s);
- a numpy float32 and float64 model of the envelope kernel's lane (the two
  reciprocals and 1 - 1/w computed once and selected, both candidates of a
  step computed and one selected, each operation rounded on its own) equal
  to the plain loop bit for bit, with NaN, inf and zero samples, a lane that
  only falls and one that only rises, and a carried state;
- a model of the multi-target kernel's scalar greedy assignment (the first
  minimum in row-major order, stopping at an infinite minimum) equal to the
  plain masked form's ``assign`` and ``taken`` on costs with ties, infinite
  rows and columns, K > M and M > K; and scalar models of both trackers'
  per-lane branches (the kernels' first, scalar design) equal to the plain
  loops, the integers exact, the angles within 1e-6 rad;
- models of the redesigned kernels (``csrc/tracking.cu``): the warp's
  greedy rounds (each thread its row's first minimum, a reduction over the
  minima's bits and then over the index m·KC + k, the stop at inf) equal to
  ``greedy_assignment`` and the scalar model at M, K in {1, 2, 4, 16} with
  ties, inf rows, columns and lanes; the spawns by one ballot and ranks
  equal to the plain loop's first-empty-slot rule; the branch-free
  ``track_angles`` frame (three wraps on selected arguments, the states as
  selects) and the warp form of the multi-target lane equal to the plain
  loops (re-acquisition, coasting, the gate's float32 boundary), the
  integers exact, the angles within 1e-6 rad;
- the device repair: a signal that is not a tensor lands on the card unless
  the caller passes ``device="cpu"`` (``Envelope.evolve`` and the
  integrate-and-fire and peak encoders): with ``device="cpu"`` it stays on
  the CPU, without it asks for the card, which raises here;
- the wrappers raise on what the kernels do not take (a dtype, M or K
  outside 1-16, no frame, a tensor off the card) and never run the plain
  loop instead: tensors on the ``meta`` device reach the CUDA route; and
  their constants are held to the library's (stubbed).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_track_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from haghighatshoarmuir2024_tpu.ops import envelope as jax_envelope
from haghighatshoarmuir2024_tpu.utils import tracking as jax_tracking

from haghighatshoarmuir2024_tpu_torch.ops import envelope, spikes
from haghighatshoarmuir2024_tpu_torch.ops.cuda import envelope_kernel, track_kernel
from haghighatshoarmuir2024_tpu_torch.utils import tracking

FS = 48_000
ENV_TOL = {"float64": 1e-12, "float32": 4e-6}
ANGLE_TOL = 1e-6
META = torch.device("meta")
INF = np.float32(np.inf)


def signal(seed: int, T: int = 3001, C: int = 3) -> np.ndarray:
    """Tones in noise under a rising gain: (T, C) float64."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None] / FS
    x = np.sin(2 * np.pi * rng.uniform(300, 3000, C) * t + rng.uniform(0, np.pi, C)) \
        + 0.3 * rng.standard_normal((T, C))
    return x * np.linspace(0.2, 1.5, T)[:, None]


def angle_lanes(seed: int, T: int = 80, B: int = 5) -> np.ndarray:
    """(T, B) float32 bearings of targets crossing ±pi, with outliers and runs
    of them long enough to force re-acquisition."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    z = 2.9 + rng.uniform(0.02, 0.09, B) * t + rng.normal(0, 0.02, (T, B))
    out = rng.random((T, B)) < 0.12
    z[out] = rng.uniform(-np.pi, np.pi, out.sum())
    z[30:36, 0] = z[30:36, 0] + 1.5  # a run of outliers: the lane re-acquires
    return np.angle(np.exp(1j * z)).astype(np.float32)


def multi_lanes(seed: int, T: int = 50, B: int = 3, K: int = 4):
    """(T, B, K) float32 candidates of two crossing targets plus clutter, and
    their validity (two all-invalid frames)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None, None]
    tracks = np.concatenate([1.0 + 0.03 * t, -2.8 - 0.05 * t], axis=-1) + rng.normal(0, 0.02, (T, B, 2))
    z = np.concatenate([tracks, rng.uniform(-np.pi, np.pi, (T, B, K - 2))], axis=-1)
    valid = rng.random((T, B, K)) < np.array([0.9, 0.9] + [0.25] * (K - 2))
    valid[20:22] = False
    perm = np.argsort(rng.random((T, B, K)), axis=-1)
    z = np.angle(np.exp(1j * np.take_along_axis(z, perm, axis=-1)))
    return z.astype(np.float32), np.take_along_axis(valid, perm, axis=-1)


# ------------------------------------------------------------------ the CPU routes against JAX
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rise,fall", [(1e-3, 1e-2), (5e-4, 5e-4)])
def test_torch_envelope_route_matches_jax(dtype, rise, fall):
    x = signal(3).astype(dtype)
    env, jenv = envelope.Envelope(rise, fall, FS), jax_envelope.Envelope(rise, fall, FS)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jenv.evolve(jnp.asarray(x)))
        ja, js = jenv.evolve(jnp.asarray(x[:1200]), return_state=True)
        jb = np.asarray(jenv.evolve(jnp.asarray(x[1200:]), state=js))
    got = env.evolve(x, device="cpu")
    assert got.device.type == "cpu" and got.dtype == getattr(torch, dtype) and got.shape == x.shape
    tol = ENV_TOL[dtype] * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= tol
    a, s = env.evolve(torch.as_tensor(x[:1200]), return_state=True)
    b, s2 = env.evolve(torch.as_tensor(x[1200:]), state=s, return_state=True)
    assert np.abs(s.numpy() - np.asarray(js)).max() <= tol
    assert np.abs(b.numpy() - jb).max() <= tol
    # a chunk with a carried state starts from it in place of its first sample (JAX's and the reference's
    # convention), so two calls are one pass over the signal without the second chunk's first sample
    one, s1 = env.evolve(np.delete(x, 1200, axis=0), device="cpu", return_state=True)
    assert torch.equal(torch.cat([a, b[1:]]), one) and torch.equal(s2, s1)


@pytest.mark.parametrize("seed", range(3))
def test_torch_track_angles_route_matches_jax(seed):
    z = angle_lanes(seed)
    kw = dict(alpha=0.4, gate_deg=20.0, max_misses=2)
    got = tracking.track_angles(z, device="cpu", **kw)
    assert got.device.type == "cpu" and got.shape == z.shape
    for b in range(z.shape[1]):
        with jax.enable_x64(False):
            want = np.asarray(jax_tracking.track_angles(jnp.asarray(z[:, b]), **kw))
        np.testing.assert_allclose(got[:, b].numpy(), want, rtol=0, atol=ANGLE_TOL)
    assert torch.equal(got, tracking.track_angles_plain(torch.as_tensor(z), device="cpu", **kw))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("num_tracks,K", [(4, 2), (3, 4), (2, 5)])
def test_torch_track_multi_route_matches_jax(seed, num_tracks, K):
    z, valid = multi_lanes(seed, K=K)
    kw = dict(max_misses=4, confirm_hits=2)
    th, cf = tracking.track_multi_angles(z, valid, num_tracks, device="cpu", **kw)
    assert th.device.type == "cpu" and th.shape == cf.shape == z.shape[:-1] + (num_tracks,)
    for b in range(z.shape[1]):
        with jax.enable_x64(False):
            jth, jcf = jax_tracking.track_multi_angles(jnp.asarray(z[:, b]), jnp.asarray(valid[:, b]), num_tracks,
                                                       **kw)
        np.testing.assert_array_equal(cf[:, b].numpy(), np.asarray(jcf))
        np.testing.assert_allclose(th[:, b].numpy(), np.asarray(jth), rtol=0, atol=ANGLE_TOL)
    pth, pcf = tracking.track_multi_angles_plain(torch.as_tensor(z), torch.as_tensor(valid), num_tracks,
                                                 device="cpu", **kw)
    assert torch.equal(th, pth) and torch.equal(cf, pcf)


# ------------------------------------------------------------------ a model of the envelope kernel's lane
def envelope_coefficients(dtype, win_lens) -> tuple:
    """The kernel's ``Coef``: the reciprocals ``(1/w)·1`` and ``1 - 1/w`` of
    both windows, in ``dtype``, each rounded on its own."""
    dt = np.dtype(dtype).type
    one = dt(1)
    r_fall, r_rise = ((one / dt(w)) * one for w in win_lens)
    return r_fall, r_rise, one - r_fall, one - r_rise


def envelope_step(x: np.ndarray, s: np.ndarray, coef) -> np.ndarray:
    """The kernel's ``step``: both candidates, each operation rounded on its
    own, one selected by ``|x| >= s``."""
    r_fall, r_rise, c_fall, c_rise = coef
    dt = s.dtype.type
    xa = np.abs(x)
    with np.errstate(invalid="ignore", over="ignore"):
        up = c_rise * s + (r_rise * xa) * dt(1)
        down = c_fall * s + (r_fall * xa) * dt(0)
        return np.where(xa >= s, up, down)


def envelope_lane_model(x: np.ndarray, win_lens, s0=None) -> tuple[np.ndarray, np.ndarray]:
    """``csrc/envelope.cu``'s arithmetic in numpy, lane by lane, in ``x``'s
    dtype: the reciprocals ``(1/w)·1`` and ``1 - 1/w`` of both windows once,
    then per step both candidates, each operation rounded on its own, one
    selected by ``x >= s``."""
    coef = envelope_coefficients(x.dtype, win_lens)
    s = np.abs(x[0]) if s0 is None else np.asarray(s0, x.dtype).copy()
    out = np.empty_like(x)
    for t in range(1, x.shape[0]):
        out[t - 1] = s
        s = envelope_step(x[t], s, coef)
    out[-1] = s
    return out, s


def envelope_edges(dtype) -> np.ndarray:
    """(T, 6) lanes: noise, NaN and inf samples, zeros, a lane that only falls
    (a spike, then silence) and one that only rises (a ramp)."""
    rng = np.random.default_rng(5)
    T = 700
    x = rng.standard_normal((T, 6))
    x[100, 1], x[300, 1] = np.nan, 0.0
    x[50, 2], x[51, 2] = np.inf, -np.inf
    x[:, 3] = 0.0
    x[:, 4] = 0.0
    x[0, 4] = 5.0
    x[:, 5] = np.arange(T) * 1e-3
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("carried", [False, True])
def test_torch_envelope_kernel_lane_model(dtype, carried):
    """The kernel's arithmetic, lane by lane, equals the plain loop bit for
    bit (NaN for NaN), from ``|x[0]|`` and from a carried state."""
    x = np.concatenate([signal(7, T=700, C=3).astype(dtype), envelope_edges(dtype)], axis=1)
    env = envelope.Envelope(1e-3, 1e-2, FS)
    s0 = np.abs(np.random.default_rng(1).standard_normal(x.shape[1])).astype(dtype) if carried else None
    want, want_s = env.evolve_plain(torch.as_tensor(x), None if s0 is None else torch.as_tensor(s0),
                                    return_state=True)
    got, got_s = envelope_lane_model(x, env.win_lens, s0)
    assert np.array_equal(got, want.numpy(), equal_nan=True)
    assert np.array_equal(got_s, want_s.numpy(), equal_nan=True)
    if not carried:
        assert np.isnan(got[100:, 4]).all() and np.isinf(got[52:, 5]).all() and not got[:, 6].any()
        assert (np.diff(got[:, 7]) <= 0).all() and (np.diff(got[:, 8]) >= 0).all()


# ------------------------------------------------------------------ a model of the envelope kernel's tiles
ENV_LANES, ENV_TS, ENV_STAGES = envelope_kernel.ENV_LANES, envelope_kernel.ENV_TS, envelope_kernel.ENV_STAGES
ENV_GROUP = 8  # csrc/envelope.cu's GROUP: steps a whole tile reads ahead into registers


def envelope_tiles_model(x: np.ndarray, win_lens, s0=None, x_ptr: int = 0, out_ptr: int = 0):
    """``hm_envelope``'s schedule in numpy, in ``x``'s dtype, on contiguous
    (T, L) ``x`` at address ``x_ptr`` into ``out`` at ``out_ptr``, cut as
    ``envelope_kernel.plan`` says.  Every block runs the same schedule, so
    all run at once: the ring holds (ENV_STAGES, ENV_TS, blocks·ENV_LANES)
    items, lane j of every block at column j.  For each tile of ENV_TS
    steps the producer's 32 threads fill the slot tile % ENV_STAGES (thread
    p: 16-byte copies ``[lane0 + vcol, + VEC)`` of rows ``vrow``, ``vrow +
    ROWS_A_COPY``, ... where the plan moves x by rows, else lane ``lane0 +
    p`` of every row), the consumer runs the tile's steps in place (a whole
    tile after the first reads its x a group of ENV_GROUP steps ahead, two
    groups in turn; the first tile's first step is the initial state, and
    the first and the last, partial tile step by step), and the producer
    drains the slot to ``out`` the same two ways.  Idle lanes compute on
    what the slot holds (NaN here) and are never drained.  Returns ``(out,
    s_fin, plan, reads, writes)``: ``reads`` and ``writes`` count the
    copies of each (t, lane) of x in and of out out."""
    T, L = x.shape
    plan = envelope_kernel.plan(T, L, x.itemsize, x_ptr, out_ptr)
    coef = envelope_coefficients(x.dtype, win_lens)
    vec = envelope_kernel.ENV_VEC_BYTES // x.itemsize
    copies_a_row = ENV_LANES // vec
    rows_a_copy = ENV_LANES // copies_a_row
    lane0 = np.arange(plan.blocks) * ENV_LANES
    ring = np.full((ENV_STAGES, ENV_TS, plan.blocks * ENV_LANES), np.nan, x.dtype)
    out = np.full_like(x, np.nan)
    reads, writes = np.zeros((T, L), np.int64), np.zeros((T, L), np.int64)
    s = np.zeros(plan.blocks * ENV_LANES, x.dtype)
    if s0 is not None:
        s[:L] = s0

    def threads(by_rows: bool, n: int):
        """``(rows, lanes)`` each producer thread moves in a tile of ``n`` rows."""
        for p in range(ENV_LANES):
            if by_rows:
                vcol, vrow = (p % copies_a_row) * vec, p // copies_a_row
                first = lane0[lane0 + vcol < L] + vcol
                yield np.arange(vrow, n, rows_a_copy), (first[:, None] + np.arange(vec)).ravel()
            else:
                lanes = lane0 + p
                yield np.arange(n), lanes[lanes < L]

    for tile in range(plan.tiles):
        slot, t0 = tile % ENV_STAGES, tile * ENV_TS
        n = min(ENV_TS, T - t0)
        v = ring[slot]
        for rows, lanes in threads(plan.vec_x, n):
            v[np.ix_(rows, lanes)] = x[np.ix_(t0 + rows, lanes)]
            reads[np.ix_(t0 + rows, lanes)] += 1
        if tile > 0 and n == ENV_TS:
            ahead = v[:ENV_GROUP].copy()
            for k in range(0, ENV_TS, 2 * ENV_GROUP):
                behind = v[k + ENV_GROUP:k + 2 * ENV_GROUP].copy()
                for u in range(ENV_GROUP):
                    s = v[k + u] = envelope_step(ahead[u], s, coef)
                if k + 2 * ENV_GROUP < ENV_TS:
                    ahead = v[k + 2 * ENV_GROUP:k + 3 * ENV_GROUP].copy()
                for u in range(ENV_GROUP):
                    s = v[k + ENV_GROUP + u] = envelope_step(behind[u], s, coef)
        else:
            k = 0
            if tile == 0:
                s = v[0] = np.abs(v[0]) if s0 is None else s
                k = 1
            for k in range(k, n):
                s = v[k] = envelope_step(v[k], s, coef)
        for rows, lanes in threads(plan.vec_out, n):
            out[np.ix_(t0 + rows, lanes)] = v[np.ix_(rows, lanes)]
            writes[np.ix_(t0 + rows, lanes)] += 1
    return out, s[:L].copy(), plan, reads, writes


def tile_signal(T: int, L: int, dtype, seed: int = 9) -> np.ndarray:
    return signal(seed, T=T, C=L).astype(dtype)


def assert_tiles_model(x: np.ndarray, s0=None, x_ptr: int = 0, out_ptr: int = 0):
    """The tile model on ``x`` equals the plain loop bit for bit (NaN for
    NaN), outputs and final state, every (t, lane) read once and written
    once; returns the model's outputs, state and plan."""
    env = envelope.Envelope(1e-3, 1e-2, FS)
    y, s, plan, reads, writes = envelope_tiles_model(x, env.win_lens, s0, x_ptr, out_ptr)
    want, want_s = (t.numpy() for t in env.evolve_plain(torch.as_tensor(x), None if s0 is None else
                                                        torch.as_tensor(s0), return_state=True))
    assert np.array_equal(y, want, equal_nan=True) and np.array_equal(s, want_s, equal_nan=True)
    assert (reads == 1).all() and (writes == 1).all()
    return y, s, plan


TILE_T = (1, 2, ENV_TS - 1, ENV_TS, ENV_TS + 1, ENV_STAGES * ENV_TS + 1, 12_000)
TILE_L = (1, 7, 31, 32, 33, 672)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L", TILE_L)
@pytest.mark.parametrize("T", TILE_T)
def test_torch_envelope_kernel_tiles_model(T, L, dtype):
    """The redesigned kernel's schedule (a consumer and a producer warp over
    a ring of tiles) equals the plain loop bit for bit at every T and L
    around a tile, the ring, a warp and the flagship shapes, each (t, lane)
    read and written once, by the cut ``plan`` names: 16-byte rows where L
    items fill whole 16-byte vectors (672 lanes in float32; 32 in either
    dtype), an item a lane otherwise (7 lanes)."""
    x = tile_signal(T, L, dtype)
    _, _, plan = assert_tiles_model(x)
    itemsize = np.dtype(dtype).itemsize
    assert plan.blocks == -(-L // ENV_LANES) and plan.tiles == -(-T // ENV_TS)
    assert plan.last_rows == T - (plan.tiles - 1) * ENV_TS and 1 <= plan.last_rows <= ENV_TS
    assert plan.vec_x == plan.vec_out == ((L * itemsize) % 16 == 0)
    if (L, dtype) in ((672, "float32"), (32, "float64")):
        assert plan.vec_x
    if L == 7:
        assert not plan.vec_x


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L", [7, 672])
@pytest.mark.parametrize("T", [ENV_TS - 1, ENV_TS + 1, ENV_STAGES * ENV_TS + 1])
def test_torch_envelope_kernel_tiles_model_carried(T, L, dtype):
    """A carried state (some lanes above the signal, some below) takes the
    first step in place of ``|x[0]|``, through the tiles as through the
    plain loop."""
    x = tile_signal(T, L, dtype, seed=10)
    s0 = (np.random.default_rng(11).random(L) * 3).astype(dtype)
    y, s, _ = assert_tiles_model(x, s0)
    assert np.array_equal(y[0], s0)


@pytest.mark.parametrize("L,dtype", [(672, "float32"), (2, "float64"), (64, "float64")])
def test_torch_envelope_kernel_tiles_model_unaligned(L, dtype):
    """x one item past a 16-byte boundary moves an item a lane a step while
    the aligned output still drains by 16-byte rows, and the other way
    round; both equal the plain loop."""
    x = tile_signal(ENV_STAGES * ENV_TS + 3, L, dtype, seed=12)
    itemsize = np.dtype(dtype).itemsize
    for x_ptr, out_ptr, want in ((itemsize, 0, (False, True)), (0, itemsize, (True, False))):
        _, _, plan = assert_tiles_model(x, x_ptr=x_ptr, out_ptr=out_ptr)
        assert (plan.vec_x, plan.vec_out) == want


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_torch_envelope_kernel_tiles_model_nan_across_tiles(dtype):
    """NaN, inf and zeros at the last step of a tile, the first of the next
    and the ring's turn (step ENV_STAGES·ENV_TS) propagate as in the plain
    loop: a NaN sample makes the state NaN from its step on."""
    T, turn = ENV_STAGES * ENV_TS + 77, ENV_STAGES * ENV_TS
    x = tile_signal(T, 6, dtype, seed=13)
    x[ENV_TS - 1, 1], x[ENV_TS, 2], x[turn, 5] = np.nan, np.nan, np.nan
    x[ENV_TS - 1, 3], x[ENV_TS, 3] = np.inf, -np.inf
    x[ENV_TS - 3:ENV_TS + 3, 4] = 0.0
    x[turn - 1:turn + 1, 0] = 0.0
    y, _, _ = assert_tiles_model(x)
    for lane, t in ((1, ENV_TS - 1), (2, ENV_TS), (5, turn)):
        assert np.isnan(y[t:, lane]).all() and not np.isnan(y[:t, lane]).any()
    assert np.isfinite(y[:, [0, 4]]).all()


@pytest.mark.parametrize("L,dtype", [(7, "float32"), (33, "float64"), (672, "float32")])
def test_torch_envelope_kernel_tiles_model_split_mid_tile(L, dtype):
    """Two calls split in the middle of the second tile, the state carried,
    equal the plain loop's two calls and one pass over the signal without
    the second call's first sample (which the carried state replaces)."""
    x = tile_signal(3 * ENV_TS + 50, L, dtype, seed=14)
    h = ENV_TS + ENV_TS // 2
    a, sa, _ = assert_tiles_model(x[:h])
    b, sb, _ = assert_tiles_model(x[h:], sa)
    one, s1, _ = assert_tiles_model(np.delete(x, h, axis=0))
    assert np.array_equal(np.concatenate([a, b[1:]]), one) and np.array_equal(sb, s1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("T,L,carried", [(ENV_TS + 1, 33, False), (ENV_STAGES * ENV_TS + 1, 7, True)])
def test_torch_envelope_kernel_tiles_model_matches_jax(T, L, carried, dtype):
    """The tile model against JAX's ``Envelope.evolve`` on the same numpy
    input, outputs and final state, within ``ENV_TOL`` of JAX's peak (float32:
    XLA contracts the update into a fused multiply-add)."""
    x = tile_signal(T, L, dtype, seed=15)
    s0 = (np.random.default_rng(16).random(L) * 2).astype(dtype) if carried else None
    y, s, _ = assert_tiles_model(x, s0)
    jenv = jax_envelope.Envelope(1e-3, 1e-2, FS)
    with jax.enable_x64(dtype == "float64"):
        want, want_s = jenv.evolve(jnp.asarray(x), None if s0 is None else jnp.asarray(s0), return_state=True)
        want, want_s = np.asarray(want), np.asarray(want_s)
    tol = ENV_TOL[dtype] * np.abs(want).max()
    assert np.abs(y - want).max() <= tol and np.abs(s - want_s).max() <= tol


@pytest.mark.parametrize("T,L,itemsize,ptrs,want", [
    (1, 1, 4, (0, 0), (1, 1, 1, False, False)),
    (12_000, 7, 4, (0, 0), (1, 94, 96, False, False)),
    (12_000, 672, 4, (0, 0), (21, 94, 96, True, True)),
    (12_000, 7, 8, (0, 0), (1, 94, 96, False, False)),
    (ENV_STAGES * ENV_TS, 33, 8, (0, 0), (2, ENV_STAGES, ENV_TS, False, False)),
    (ENV_TS + 1, 36, 4, (4, 0), (2, 2, 1, False, True)),
    (ENV_TS - 1, 2, 8, (16, 8), (1, 1, ENV_TS - 1, True, False)),
])
def test_torch_envelope_plan(T, L, itemsize, ptrs, want):
    """``plan``'s cut: blocks of 32 lanes, tiles of 128 steps with the last
    one's rows, and 16-byte row copies only where L items make whole
    16-byte vectors and the tensor's base is 16-byte aligned."""
    assert tuple(envelope_kernel.plan(T, L, itemsize, *ptrs)) == want


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_torch_envelope_chain_samples_take_both_sides(dtype):
    """The chain probe's samples, cycled as the probe cycles them, make
    every lane's state rise and fall in turn, so the probe's steps take
    both sides of the select (the kernel's arithmetic, lane model)."""
    xs = envelope_kernel.chain_samples(getattr(torch, dtype)).numpy()
    assert xs.shape == (envelope_kernel.ENV_CHAIN_X, ENV_LANES) and xs.dtype == np.dtype(dtype)
    y, _ = envelope_lane_model(np.tile(xs, (64, 1)), envelope.Envelope(1e-3, 1e-2, FS).win_lens)
    d = np.diff(y[envelope_kernel.ENV_CHAIN_X:], axis=0)
    assert ((d > 0).sum(axis=0) > 0).all() and ((d < 0).sum(axis=0) > 0).all()


@pytest.mark.parametrize("T,L", [(0, 7), (12, 0)])
def test_torch_envelope_plan_refuses_empty(T, L):
    with pytest.raises(ValueError, match="T, L >= 1"):
        envelope_kernel.plan(T, L, 4)


# ------------------------------------------------------------------ models of the tracking kernels
def greedy_model(cost: np.ndarray):
    """The scalar design's assignment of one lane's (M, K) cost: rounds of a
    scalar scan for the first minimum (strict <), stopping at inf."""
    M, K = cost.shape
    c = cost.astype(np.float32).ravel().copy()
    assign, taken = np.full(M, -1), np.zeros(K, bool)
    for _ in range(min(M, K)):
        best, bc = 0, c[0]
        for i in range(1, M * K):
            if c[i] < bc:
                best, bc = i, c[i]
        if not bc < INF:
            break
        m, k = divmod(best, K)
        assign[m], taken[k] = k, True
        c[m * K:(m + 1) * K] = INF
        c[k::K] = INF
    return assign, taken


@pytest.mark.parametrize("M,K", [(4, 2), (2, 4), (3, 3), (16, 16), (1, 5), (5, 1)])
def test_torch_track_multi_assignment_model(M, K):
    """Ties (costs from a set of four values), rows and columns all inf and
    whole lanes inf: the scalar greedy rounds give the plain masked form's
    ``assign`` and ``taken``."""
    rng = np.random.default_rng(M * 31 + K)
    B = 64
    cost = rng.choice(np.array([0.1, 0.2, 0.3, np.inf], np.float32), size=(B, M, K), p=[0.3, 0.3, 0.2, 0.2])
    cost[1::7] = np.inf
    cost[2::5, 0] = np.inf
    cost[3::6, :, -1] = np.inf
    cost[4::9] = np.float32(0.1)  # every entry tied
    assign, taken = tracking.greedy_assignment(torch.as_tensor(cost))
    for b in range(B):
        ma, mt = greedy_model(cost[b])
        np.testing.assert_array_equal(assign[b].numpy(), ma)
        np.testing.assert_array_equal(taken[b].numpy(), mt)


def wrap(x: float) -> float:
    """The plain loops' ``atan2(sin x, cos x)`` on one float32 value (PyTorch's
    CPU kernels round a long tensor's transcendentals otherwise than a short
    one's: this is the short tensors' form, which the models' lanes meet)."""
    return float(tracking._wrap(torch.tensor(np.float32(x))))


def f32(v) -> np.float32:
    return np.float32(v)


def track_angles_model(z: np.ndarray, alpha=0.35, beta=None, gate_deg=25.0, max_misses=3):
    """The scalar design's ``track_angles_kernel``: its branches for one
    lane, float32."""
    alpha32, beta32 = f32(alpha), f32(tracking._beta(alpha, beta))
    gate = f32(np.deg2rad(gate_deg))
    theta = omega = f32(0)
    misses = init = 0
    out = np.empty(len(z), np.float32)
    for t, zt in enumerate(z):
        zt = f32(zt)
        if init == 0:
            theta, omega, misses, init = zt, f32(0), 0, 1
        elif init == 1:
            omega, theta, misses, init = f32(wrap(zt - theta)), zt, 0, 2
        else:
            pred = f32(wrap(theta + omega))
            delta = f32(wrap(zt - pred))
            inlier = abs(delta) <= gate
            m = 0 if inlier else misses + 1
            if m > max_misses:
                theta, omega, misses, init = zt, f32(0), 0, 1
            elif inlier:
                theta, omega, misses = f32(wrap(pred + alpha32 * delta)), omega + beta32 * delta, 0
            else:
                theta, misses = pred, m
        out[t] = theta
    return out


def track_multi_model(z: np.ndarray, valid: np.ndarray, M: int, alpha=0.35, beta=None, gate_deg=25.0,
                      max_misses=3, confirm_hits=2):
    """The scalar design's ``track_multi_kernel``: its branches for one lane,
    (T, K) in, (T, M) thetas and confirmed out, float32."""
    alpha32, beta32 = f32(alpha), f32(tracking._beta(alpha, beta))
    gate, pi = f32(np.deg2rad(gate_deg)), f32(np.pi)
    T, K = z.shape
    th, om = np.zeros(M, np.float32), np.zeros(M, np.float32)
    mi, ini, hi = np.zeros(M, int), np.zeros(M, int), np.zeros(M, int)
    thetas, confirmed = np.empty((T, M), np.float32), np.empty((T, M), bool)
    for t in range(T):
        pred = np.array([wrap(th[m] + om[m]) for m in range(M)], np.float32)
        d = np.array([[wrap(z[t, k] - pred[m]) for k in range(K)] for m in range(M)], np.float32)
        cost = np.full((M, K), INF)
        for m in range(M):
            g = gate if ini[m] == 2 else pi
            for k in range(K):
                if ini[m] in (1, 2) and valid[t, k] and abs(d[m, k]) <= g:
                    cost[m, k] = abs(d[m, k])
        assign, taken = greedy_model(cost)
        for m in range(M):
            tracking_, booting, has = ini[m] == 2, ini[m] == 1, assign[m] >= 0
            k = assign[m] if has else 0
            if tracking_ and has:
                th[m] = wrap(pred[m] + alpha32 * d[m, k])
                om[m] = om[m] + beta32 * d[m, k]
                mi[m], hi[m] = 0, hi[m] + 1
            elif tracking_:
                th[m], mi[m] = pred[m], mi[m] + 1
                if mi[m] > max_misses:
                    ini[m] = hi[m] = mi[m] = 0
            elif booting and has:
                om[m] = wrap(z[t, k] - th[m])
                th[m], hi[m], mi[m], ini[m] = z[t, k], hi[m] + 1, 0, 2
            elif booting:
                ini[m] = hi[m] = mi[m] = 0
        for k in range(K):
            if not valid[t, k] or taken[k]:
                continue
            free = np.flatnonzero(ini == 0)
            if free.size == 0:
                break
            s = free[0]
            th[s], om[s], mi[s], hi[s], ini[s] = z[t, k], 0.0, 0, 0, 1
        thetas[t], confirmed[t] = th, (ini == 2) & (hi >= confirm_hits)
    return thetas, confirmed


@pytest.mark.parametrize("seed", range(2))
def test_torch_track_angles_kernel_model(seed):
    """The kernel's per-lane branches (bootstrap, gate, coast, re-acquire)
    give the plain loop's angles, lane by lane."""
    z = angle_lanes(seed + 4)
    kw = dict(alpha=0.3, gate_deg=15.0, max_misses=2)
    want = tracking.track_angles_plain(torch.as_tensor(z), device="cpu", **kw).numpy()
    for b in range(z.shape[1]):
        np.testing.assert_allclose(track_angles_model(z[:, b], **kw), want[:, b], rtol=0, atol=ANGLE_TOL)


@pytest.mark.parametrize("M,K", [(4, 2), (2, 4), (3, 3)])
def test_torch_track_multi_kernel_model(M, K):
    """The kernel's per-lane scalar form (gated cost, greedy rounds, updates,
    deaths, spawns in the first free slot) gives the plain loop's
    ``confirmed`` exactly and its angles within 1e-6 rad."""
    z, valid = multi_lanes(M + K, K=K)
    kw = dict(max_misses=2, confirm_hits=3)
    want_th, want_cf = tracking.track_multi_angles_plain(torch.as_tensor(z), torch.as_tensor(valid), M,
                                                         device="cpu", **kw)
    for b in range(z.shape[1]):
        th, cf = track_multi_model(z[:, b], valid[:, b], M, **kw)
        np.testing.assert_array_equal(cf, want_cf[:, b].numpy())
        np.testing.assert_allclose(th, want_th[:, b].numpy(), rtol=0, atol=ANGLE_TOL)


# ------------------------------------------------------------------ models of the redesigned tracking kernels
FULL32 = 0xFFFFFFFF
INF_BITS = 0x7F800000


def capacity(K: int) -> int:
    """The measurement capacity KC the multi-target kernel is built for at
    K measurements: 2, 4, 8 or 16."""
    return max(2, 1 << (K - 1).bit_length())


def warp_assignment_model(cost: np.ndarray):
    """``track_multi_kernel``'s greedy rounds on one lane's (M, K) cost, as
    the warp computes them: thread m holds row m (rows M..31 all inf), each
    round every thread takes its row's first minimum (strict <), the warp
    reduces the minima's bits (non-negative floats order as their bits),
    then the index m·KC + k among the threads that hold the minimum, and
    stops at inf; the winner's row and column close."""
    M, K = cost.shape
    KC = capacity(K)
    c = np.full((32, KC), INF, np.float32)
    c[:M, :K] = cost
    assign, taken = np.full(32, -1), 0
    for _ in range(min(M, K)):
        rc, rk = np.full(32, INF, np.float32), np.zeros(32, int)
        for m in range(32):
            for k in range(KC):
                if c[m, k] < rc[m]:
                    rc[m], rk[m] = c[m, k], k
        bits = rc.view(np.uint32)
        best = int(bits.min())
        if best == INF_BITS:
            break
        idx = min(m * KC + int(rk[m]) if bits[m] == best else FULL32 for m in range(32))
        bm, bk = divmod(idx, KC)
        taken |= 1 << bk
        assign[bm] = bk
        c[bm, :] = INF
        c[:, bk] = INF
    return assign[:M], np.array([(taken >> k) & 1 for k in range(K)], bool)


def ballot_spawn_model(empty: np.ndarray, left: np.ndarray) -> dict:
    """The kernel's spawns: one ballot of the empty slots, and the empty
    slot of rank r among them takes the r-th leftover measurement (its r
    lowest set bits dropped, then the first), if there is one.  Returns
    ``{slot: measurement}``."""
    free = sum(1 << int(m) for m in np.flatnonzero(empty))
    lmask = sum(1 << int(k) for k in np.flatnonzero(left))
    out = {}
    for m in np.flatnonzero(empty):
        s = lmask
        for _ in range(bin(free & ((1 << int(m)) - 1)).count("1")):
            s &= s - 1
            if not s:
                break
        if s:
            out[int(m)] = (s & -s).bit_length() - 1
    return out


def sequential_spawn(empty: np.ndarray, left: np.ndarray) -> dict:
    """The plain loop's spawns: each leftover measurement, in order, in the
    first empty slot, until none is empty."""
    empty, out = empty.copy(), {}
    for k in np.flatnonzero(left):
        free = np.flatnonzero(empty)
        if free.size == 0:
            break
        out[int(free[0])] = int(k)
        empty[free[0]] = False
    return out


ASSIGN_SHAPES = [(1, 1), (1, 2), (1, 16), (2, 1), (4, 1), (16, 1), (2, 2), (4, 2), (2, 4), (4, 4), (4, 16), (16, 4),
                 (16, 2), (16, 16)]


@pytest.mark.parametrize("M,K", ASSIGN_SHAPES)
def test_torch_track_multi_warp_assignment_model(M, K):
    """The warp's rounds (row minima, the reduction over bits and then
    index, the stop at inf) give ``greedy_assignment``'s and the scalar
    model's ``assign`` and ``taken`` on tie-heavy costs, whole rows,
    columns and lanes inf, and every entry tied."""
    rng = np.random.default_rng(M * 37 + K)
    B = 48
    cost = rng.choice(np.array([0.0, 0.1, 0.2, 0.3, np.inf], np.float32), size=(B, M, K),
                      p=[0.1, 0.25, 0.25, 0.2, 0.2])
    cost[1::7] = np.inf
    cost[2::5, 0] = np.inf
    cost[3::6, :, -1] = np.inf
    cost[4::9] = np.float32(0.1)
    cost[5::11] = np.float32(0.0)
    assign, taken = tracking.greedy_assignment(torch.as_tensor(cost))
    for b in range(B):
        wa, wt = warp_assignment_model(cost[b])
        sa, st = greedy_model(cost[b])
        np.testing.assert_array_equal(wa, assign[b].numpy())
        np.testing.assert_array_equal(wt, taken[b].numpy())
        np.testing.assert_array_equal(wa, sa)
        np.testing.assert_array_equal(wt, st)


@pytest.mark.parametrize("M,K", ASSIGN_SHAPES)
def test_torch_track_multi_ballot_spawn_model(M, K):
    """One ballot and ranks give the plain loop's spawns (each leftover
    measurement in order into the first empty slot), with every slot empty,
    none empty, and every measurement or none left over."""
    rng = np.random.default_rng(M * 41 + K)
    cases = [(np.ones(M, bool), np.ones(K, bool)), (np.zeros(M, bool), np.ones(K, bool)),
             (np.ones(M, bool), np.zeros(K, bool))]
    cases += [(rng.random(M) < p, rng.random(K) < q) for p in (0.2, 0.5, 0.8) for q in (0.3, 0.7) for _ in range(8)]
    for empty, left in cases:
        assert ballot_spawn_model(empty, left) == sequential_spawn(empty, left)


def track_angles_select_model(z: np.ndarray, alpha=0.35, beta=None, gate_deg=25.0, max_misses=3):
    """``track_angles_kernel``'s frame for one lane, float32: three wraps
    on arguments selected first (z - theta when booting, z - pred
    otherwise), then the state machine as selects."""
    alpha32, beta32 = f32(alpha), f32(tracking._beta(alpha, beta))
    gate = f32(np.deg2rad(gate_deg))
    theta = omega = f32(0)
    misses = init = 0
    out = np.empty(len(z), np.float32)
    for t, zt in enumerate(z):
        zt = f32(zt)
        pred = f32(wrap(theta + omega))
        w2 = f32(wrap(zt - (theta if init == 1 else pred)))
        inlier = abs(w2) <= gate
        m = 0 if inlier else misses + 1
        w3 = f32(wrap(pred + alpha32 * w2))
        om_upd = f32(omega + beta32 * w2)
        tracking_, reacquire = init == 2, m > max_misses
        th_track = zt if reacquire else (w3 if inlier else pred)
        om_track = f32(0) if reacquire else (om_upd if inlier else omega)
        theta = th_track if tracking_ else zt
        omega = om_track if tracking_ else (w2 if init == 1 else f32(0))
        misses = m if tracking_ and not reacquire else 0
        init = (1 if reacquire else 2) if tracking_ else init + 1
        out[t] = theta
    return out


def gate_lanes(gate_deg: float = 25.0) -> np.ndarray:
    """(3, 6) lanes: two frames at 0 (spawn, bootstrap), then a measurement
    whose wrapped distance from the prediction 0 is the float32 just below
    float32(gate), float32(gate) itself and the one just above, both signs."""
    g = np.float32(np.deg2rad(gate_deg))
    edge = np.array([np.nextafter(g, np.float32(0)), g, np.nextafter(g, np.float32(1))], np.float32)
    edge = np.concatenate([edge, -edge])
    return np.stack([np.zeros(6, np.float32), np.zeros(6, np.float32), edge])


ANGLE_MODEL_CASES = {
    "re-acquisition": (lambda: angle_lanes(6), dict(alpha=0.3, gate_deg=15.0, max_misses=2)),
    "coasting, max_misses = 5": (lambda: angle_lanes(7), dict(gate_deg=10.0, max_misses=5)),
    "max_misses = 0": (lambda: angle_lanes(8), dict(max_misses=0)),
    "the gate's float32 boundary": (gate_lanes, {}),
}


@pytest.mark.parametrize("case", list(ANGLE_MODEL_CASES))
def test_torch_track_angles_select_model(case):
    """The branch-free frame (three wraps on selected arguments, the states
    as selects) gives the plain loop's angles lane by lane, the inlier
    decisions exact: at the gate's boundary |delta| = float32(gate) is an
    inlier and the next float32 is not."""
    make, kw = ANGLE_MODEL_CASES[case]
    z = make()
    want = tracking.track_angles_plain(torch.as_tensor(z), device="cpu", **kw).numpy()
    for b in range(z.shape[1]):
        np.testing.assert_allclose(track_angles_select_model(z[:, b], **kw), want[:, b], rtol=0, atol=ANGLE_TOL)
    if case == "the gate's float32 boundary":
        assert (want[-1] != 0).tolist() == [True, True, False, True, True, False]


def track_multi_warp_model(z: np.ndarray, valid: np.ndarray, M: int, alpha=0.35, beta=None, gate_deg=25.0,
                           max_misses=3, confirm_hits=2):
    """``track_multi_kernel`` for one lane, float32: the costs of each
    slot's row, :func:`warp_assignment_model`, the update's one wrap on a
    selected argument, the deaths, :func:`ballot_spawn_model`."""
    alpha32, beta32 = f32(alpha), f32(tracking._beta(alpha, beta))
    gate, pi = f32(np.deg2rad(gate_deg)), f32(np.pi)
    T, K = z.shape
    th, om = np.zeros(M, np.float32), np.zeros(M, np.float32)
    mi, ini, hi = np.zeros(M, int), np.zeros(M, int), np.zeros(M, int)
    thetas, confirmed = np.empty((T, M), np.float32), np.empty((T, M), bool)
    for t in range(T):
        pred = np.array([wrap(th[m] + om[m]) for m in range(M)], np.float32)
        d = np.array([[wrap(z[t, k] - pred[m]) for k in range(K)] for m in range(M)], np.float32)
        live = (ini == 1) | (ini == 2)
        g = np.where(ini == 2, gate, pi)[:, None]
        cost = np.where(live[:, None] & valid[t][None, :] & (np.abs(d) <= g), np.abs(d), INF).astype(np.float32)
        assign, taken = warp_assignment_model(cost)
        for m in range(M):
            tracking_, booting, has = ini[m] == 2, ini[m] == 1, assign[m] >= 0
            za, da = (z[t, assign[m]], d[m, assign[m]]) if has else (f32(0), f32(0))
            wv = f32(wrap(za - th[m] if booting else pred[m] + alpha32 * da))
            if tracking_ and has:
                th[m], om[m], mi[m], hi[m] = wv, om[m] + beta32 * da, 0, hi[m] + 1
            elif tracking_:
                th[m], mi[m] = pred[m], mi[m] + 1
                if mi[m] > max_misses:
                    ini[m] = hi[m] = mi[m] = 0
            elif booting and has:
                om[m], th[m], hi[m], mi[m], ini[m] = wv, za, hi[m] + 1, 0, 2
            elif booting:
                ini[m] = hi[m] = mi[m] = 0
        for m, k in ballot_spawn_model(ini == 0, valid[t] & ~taken).items():
            th[m], om[m], mi[m], hi[m], ini[m] = z[t, k], 0.0, 0, 0, 1
        thetas[t], confirmed[t] = th, (ini == 2) & (hi >= confirm_hits)
    return thetas, confirmed


@pytest.mark.parametrize("M,K", [(4, 2), (1, 1), (1, 4), (4, 1), (16, 2), (2, 16), (6, 6)])
def test_torch_track_multi_warp_model(M, K):
    """The redesigned kernel's lane (a thread a slot, the warp's rounds, one
    update wrap on a selected argument, ballot spawns) gives the plain
    loop's ``confirmed`` exactly and its angles within 1e-6 rad."""
    if K >= 2:
        z, valid = multi_lanes(M * 7 + K, K=K)
    else:
        z, valid = multi_lanes(M * 7 + K, K=2)
        z, valid = z[..., :1].copy(), valid[..., :1].copy()
    kw = dict(max_misses=2, confirm_hits=3)
    want_th, want_cf = tracking.track_multi_angles_plain(torch.as_tensor(z), torch.as_tensor(valid), M,
                                                         device="cpu", **kw)
    for b in range(z.shape[1]):
        th, cf = track_multi_warp_model(z[:, b], valid[:, b], M, **kw)
        np.testing.assert_array_equal(cf, want_cf[:, b].numpy())
        np.testing.assert_allclose(th, want_th[:, b].numpy(), rtol=0, atol=ANGLE_TOL)


PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__a539b8c9_11_tracking_cu_f5cfa07818track_multi_kernelILi8EEEvNS_9MultiArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__a539b8c9_11_tracking_cu_f5cfa07818track_multi_kernelILi8EEEvNS_9MultiArgsE
    48 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 48 bytes cumulative stack size, 5120 bytes smem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__a539b8c9_11_tracking_cu_f5cfa07817wrap_chain_kernelILi0EEEvffiPfPx' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__a539b8c9_11_tracking_cu_f5cfa07817wrap_chain_kernelILi0EEEvffiPfPx
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__a539b8c9_11_tracking_cu_f5cfa07819track_angles_kernelENS_9TrackArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__a539b8c9_11_tracking_cu_f5cfa07819track_angles_kernelENS_9TrackArgsE
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, used 0 barriers, 32 bytes cumulative stack size, 8192 bytes smem
"""


def test_torch_track_kernel_resources_parse_ptxas():
    """The tracking kernels' registers, stack frames and spills read from a
    build log's ``ptxas -v`` lines (these from an sm_90a build), each
    template instantiation apart and other kernels left out; SASS opcodes
    without their predicates and modifiers."""
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    got = scan_kernels.kernel_resources(PTXAS_LOG)
    assert got == {"track_multi_kernel<8>": dict(stack=48, spill_stores=16, spill_loads=16, registers=80),
                   "track_angles_kernel": dict(stack=32, spill_stores=0, spill_loads=0, registers=46)}
    assert [scan_kernels._opcode(i) for i in ("@!P2 BRA 0x6270", "LDL.64 R2, [R1]", "REDUX.MIN UR4, R57",
                                              "@P0 EXIT")] == ["BRA", "LDL", "REDUX", "EXIT"]


@pytest.mark.parametrize("M,K,ops", [(4, 2, 21), (1, 1, 10), (16, 16, 7 + 16 * 17)])
def test_torch_track_chain_floors_from_the_measured_link(M, K, ops):
    """The chain floors take the wrap's measured link: three links a frame
    and the float32 and integer operations between them (the rounds' tree
    of ceil(log2(M·K)) levels), 4 cycles each."""
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    assert scan_kernels.multi_chain_ops(M, K) == ops
    assert scan_kernels.multi_chain_cycles(M, K, 300.0) == 900.0 + 4 * ops
    assert scan_kernels.track_chain_cycles(300.0) == 908.0
    assert scan_kernels.track_chain_ms(240, 1980.0, 300.0) == pytest.approx(240 * 908.0 / 1.98e6)


SASS_TEXT = """
\t\tFunction : _ZN44_GLOBAL__N__9f3ad860_11_envelope_cu_f858a88015envelope_kernelIfEEvPKT_
        /*0000*/                   MOV R1, c[0x0][0x28] ;                          /* 0x00000a00ff017b82 */
        /*0010*/                   FMUL R2, R2, R3 ;                               /* 0x0000000302027220 */
        /*0020*/                   LDS R4, [R5] ;                                  /* 0x0000000005047984 */
        /*0030*/                   FADD R2, R2, R4 ;                               /* 0x0000000402027221 */
        /*0040*/               @!P0 BRA 0x20 ;                                     /* 0xfffffffc00008947 */
        /*0050*/                   ISETP.GE.AND P1, PT, R6, 0x4, PT ;              /* 0x000000040600780c */
        /*0060*/               @!P1 BRA 0x10 ;                                     /* 0xfffffffc00009947 */
        /*0070*/                   EXIT ;                                          /* 0x000000000000794d */
        /*0080*/                   BRA 0x80;                                       /* 0xfffffff000007947 */
\t\tFunction : _ZN44_GLOBAL__N__9f3ad860_11_envelope_cu_f858a88021envelope_chain_kernelIfEEvPKT_
        /*0000*/                   EXIT ;                                          /* 0x000000000000794d */
"""


def test_torch_envelope_sass_innermost_loops():
    """``sass --kernel envelope``'s reading of ``cuobjdump -sass``: the
    instantiations of ``envelope_kernel`` alone (not the chain probe's),
    the n-th instruction at address 16 n, and of their backward branches
    only the innermost loop's span, the branch to itself after ``EXIT``
    left out; the opcodes counted from the kernel's table."""
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    code = scan_kernels.parse_sass(SASS_TEXT, "envelope_kernel")
    assert list(code) == ["envelope_kernelIfEEvPKT_"]
    ins = code["envelope_kernelIfEEvPKT_"]
    assert ins[0] == "MOV R1, c[0x0][0x28]" and ins[4] == "@!P0 BRA 0x20" and len(ins) == 9
    assert scan_kernels.SASS_KERNELS["envelope"][:2] == ("envelope.cu", ("envelope_kernel",))
    counts = scan_kernels._opcode_counts(ins, scan_kernels.SASS_KERNELS["envelope"][2])
    assert (counts["BRA"], counts["LDS"], counts["FMUL"], counts["ISETP"], counts["LDG"]) == (3, 1, 1, 1, 0)
    assert scan_kernels.innermost_loops(ins) == [
        dict(first="0x20", last="0x40", instructions=3, opcodes={"LDS": 1, "FADD": 1, "BRA": 1})]


# ------------------------------------------------------------------ the device repair
def _numpy_signal():
    return signal(2, T=400, C=2)


DEVICE_ROUTES = {
    "Envelope.evolve": lambda x, **kw: envelope.Envelope(1e-3, 1e-2, FS).evolve(x, **kw),
    "IAFSpikeEncoder.evolve": lambda x, **kw: spikes.IAFSpikeEncoder(2000.0, FS).evolve(x, **kw),
    "IAFZeroCrossingSpikeEncoder.evolve": lambda x, **kw: spikes.IAFZeroCrossingSpikeEncoder(500.0, FS).evolve(x, **kw),
    "PeakSpikeEncoder.evolve": lambda x, **kw: spikes.PeakSpikeEncoder(FS).evolve(x, **kw),
}


@pytest.mark.parametrize("route", list(DEVICE_ROUTES))
def test_torch_numpy_signal_lands_on_the_card(route, monkeypatch):
    """A numpy signal stays on the CPU with ``device="cpu"``, equal to the
    same signal as a CPU tensor; without ``device`` it asks for the card,
    which raises ``RuntimeError`` on a host without one (never runs on the
    CPU); a tensor stays where it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _numpy_signal()
    call = DEVICE_ROUTES[route]
    got = call(x, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, call(torch.as_tensor(x)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(x.tolist())


# ------------------------------------------------------------------ the wrappers refuse
def _no_plain(monkeypatch):
    """Make the plain versions fail loudly, so that a wrapper that fell back
    to one would not raise its own error."""
    def boom(*args, **kwargs):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(envelope.Envelope, "evolve_plain", boom)
    monkeypatch.setattr(tracking, "track_angles_plain", boom)
    monkeypatch.setattr(tracking, "track_multi_angles_plain", boom)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _env(x, **kw):
    return envelope.Envelope(1e-3, 1e-2, FS).evolve(x, **kw)


def _multi(shape, M, **kw):
    return tracking.track_multi_angles(_meta(shape), _meta(shape, torch.bool), M, device=META, **kw)


REFUSALS = {
    "envelope float16": (TypeError, lambda: _env(_meta((50, 3), torch.float16))),
    "envelope complex64": (TypeError, lambda: _env(_meta((50, 3), torch.complex64))),
    "envelope no sample": (ValueError, lambda: _env(_meta((0, 3)))),
    "envelope off the card": (ValueError, lambda: _env(_meta((50, 3)))),
    "envelope float64 off the card": (ValueError, lambda: _env(_meta((50,), torch.float64), return_state=True)),
    "envelope chain float16": (TypeError, lambda: envelope_kernel.chain_cycles(
        envelope.Envelope(1e-3, 1e-2, FS), torch.float16)),
    "envelope chain steps no multiple of its samples": (ValueError, lambda: envelope_kernel.chain_cycles(
        envelope.Envelope(1e-3, 1e-2, FS), torch.float32, n=12)),
    "envelope kernel plan float16": (TypeError, lambda: envelope_kernel.kernel_plan(12, 7, torch.float16, 0, 0)),
    "track_angles float64": (TypeError, lambda: track_kernel.track_angles(_meta((20, 4), torch.float64))),
    "track_angles max_misses beyond int32": (ValueError, lambda: tracking.track_angles(_meta((20, 4)), device=META,
                                                                                      max_misses=2**31)),
    "track_angles off the card": (ValueError, lambda: tracking.track_angles(_meta((20, 4)), device=META)),
    "track_multi M = 17": (ValueError, lambda: _multi((20, 3, 2), 17)),
    "track_multi M = 0": (ValueError, lambda: _multi((20, 3, 2), 0)),
    "track_multi K = 17": (ValueError, lambda: _multi((20, 3, 17), 4)),
    "track_multi no frame": (ValueError, lambda: _multi((0, 3, 2), 4)),
    "track_multi float64": (TypeError, lambda: track_kernel.track_multi(_meta((20, 2), torch.float64),
                                                                        _meta((20, 2), torch.bool), 4)),
    "track_multi off the card": (ValueError, lambda: _multi((20, 3, 2), 4)),
    "track_multi at the caps off the card": (ValueError, lambda: _multi((20, 16), 16)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_torch_track_wrappers_raise(case, monkeypatch):
    _no_plain(monkeypatch)
    err, call = REFUSALS[case]
    with pytest.raises(err, match="CUDA" if case.endswith("card") else None):
        call()


MIRRORS = {
    "envelope": (envelope_kernel, "hm_envelope_constants", (envelope_kernel.ENV_LANES, envelope_kernel.ENV_TS,
                                                            envelope_kernel.ENV_STAGES, envelope_kernel.ENV_VEC_BYTES,
                                                            envelope_kernel.ENV_CHAIN_X)),
    "tracking": (track_kernel, "hm_track_constants", (track_kernel.TRACK_THREADS, track_kernel.M_MAX,
                                                      track_kernel.K_MAX)),
}


@pytest.mark.parametrize("kernel", list(MIRRORS))
def test_torch_track_wrappers_hold_their_constants_to_the_library(kernel, monkeypatch):
    """Each wrapper loads the library only once the constants its source
    exports (block size, read-ahead, caps) equal the module's mirrors of
    them, and raises on any that differs (the library stubbed: no nvcc
    here)."""
    module, symbol, mirrors = MIRRORS[kernel]
    lib = object()
    asked = []

    def constants(name, n):
        asked.append((name, n))
        return tuple(wrong)

    monkeypatch.setattr(module, "library", lambda: lib)
    monkeypatch.setattr(module, "library_constants", constants)
    for i in range(len(mirrors)):
        wrong = list(mirrors)
        wrong[i] += 1
        module.checked_library.cache_clear()
        with pytest.raises(RuntimeError, match="differ"):
            module.checked_library()
    wrong = list(mirrors)
    module.checked_library.cache_clear()
    try:
        assert module.checked_library() is lib
    finally:
        module.checked_library.cache_clear()
    assert set(asked) == {(symbol, len(mirrors))}


def test_torch_track_wrappers_round_scalars_as_pytorch():
    """The Python scalars the plain loops hand PyTorch's float32 kernels are
    rounded to float32 there: the gate of 25 degrees as float32 lies above
    the double, and a float32 |delta| equal to it is an inlier in the plain
    step, so the wrapper passes the float32 gate to the kernel."""
    gate = float(np.deg2rad(25.0))
    g32 = track_kernel.float32(gate)
    assert g32 > gate and g32 == np.float32(gate)
    delta = torch.tensor([g32, float(np.nextafter(np.float32(g32), np.float32(1)))], dtype=torch.float32)
    assert (delta.abs() <= gate).tolist() == [True, False]
    assert torch.where(torch.tensor([True, False]), gate, float(np.pi)).dtype == torch.float32
