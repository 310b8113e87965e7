"""The routes of the port's two scan kernels on the CPU, against the JAX
package on the same numpy inputs:

- ``ops.iir.iir_scan`` (and ``iir_filter(method="scan")``), whose CUDA route
  is ``csrc/iir_scan.cu``: its CPU route against JAX's
  ``iir_filter(method="scan")``, real and complex, orders 1 and 2, within
  5e-6 of JAX's peak on a low-Q bandpass (3-9 kHz) and, on the flagship's
  high-Q bandpass (1600-1900 Hz), no further from scipy's float64 ``lfilter``
  than twice JAX is (plus 1e-6 of the peak); the state carried over two
  chunks equal to one pass, bit for bit, and within 1e-5 of JAX's state;
- a model of the kernel's indexing: the wrapper's launch arguments
  (``iir_kernel.scan_layout``: lanes, strides, the state's layout) on CPU
  tensors, the kernel's per-lane arithmetic in numpy float32 (each product,
  difference and sum rounded on its own), equal to the plain loop bit for
  bit on contiguous, strided, sliced and uncollapsible layouts; and the
  producer warp's copies, tile by tile through the ring (16-byte rows where
  ``iir_kernel.vector_rows`` allows them, a float a lane otherwise), equal
  to it too, with ``vector_rows`` taking only flat, aligned lanes;
- the simulator's launch plan (``sim_kernel.sim_launch``): without a
  recurrence the flat grid, a warp's neurons one 128-byte line of a step
  where B x N is a multiple of 32, and a numpy model of that kernel's
  index map equal to the plain loop; with one, the on-chip kernel: the
  width of ``w_rec``'s entries at its boundaries (+-127/128, +-32767/32768),
  N at each width's limit on one CTA and on eight, forced clusters that do
  not fit raising, only the forms the kernel is built in planned, N = 4096
  and int32 past N = 597 on the global-memory row kernel, the shared-memory
  image read back entry by entry and kept by ``sim_kernel.DenseRec``, and a
  numpy model of the kernel from the wrapper's plan and image (cluster rank
  -> column slice, padded columns, the spike list and its counts, 16-bit
  lanes and their chunks, step 0 from ``spk0``'s values) equal to the plain
  loop in the four conventions;
- ``models.xylo.sim.scan_hidden``, whose CUDA route is ``csrc/xylo_sim.cu``:
  its CPU route against JAX's ``_sim_hidden``, bit for bit, in both orderings
  and both resets, with a uniform and a dense ``w_rec``, recording on and
  off, the state carried over two calls;
- both wrappers raise on what their kernels do not take (dtype, state size,
  neurons, conventions, a tensor off the card) and never run the plain
  version instead: tensors on the ``meta`` device reach the CUDA route;
- the plain twins of K3-K6 still run the plain loop, never the dispatch.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scan_kernels.py

``python tests/test_torch_scan_kernels.py --jax-bounds`` prints JAX's
float64 error on the inputs of ``experiments/scan_kernels.iir_inputs`` (the
shapes ``chip_smoke.py`` phase 28 holds the kernel to), the numbers behind
that phase's ``JAX_SCAN_REL64``.
"""
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.signal import butter, lfilter

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # run as a script: the repository's packages
from haghighatshoarmuir2024_tpu.models.xylo.sim import _sim_hidden as jax_sim_hidden
from haghighatshoarmuir2024_tpu.ops import iir as jax_iir

from haghighatshoarmuir2024_tpu_torch.models.xylo import sim
from haghighatshoarmuir2024_tpu_torch.ops import iir
from haghighatshoarmuir2024_tpu_torch.ops.cuda import iir_kernel, lif_kernel, sim_kernel

FS = 48_000
BANDS = {"low-Q": (3000.0, 9000.0), "high-Q": (1600.0, 1900.0)}
CONVENTIONS = list(itertools.product(("decay_first", "integrate_first"), ("subtract", "zero")))
META = torch.device("meta")


def bandpass(order: int, band):
    b, a = butter(order, list(band), btype="bandpass", fs=FS)
    return b, a


def signal(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if kind == "complex":
        return (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x.astype(np.float32)


def jax_scan(b, a, x, **kw):
    with jax.enable_x64(False):
        out = jax_iir.iir_filter(b, a, jnp.asarray(x), axis=0, method="scan", **kw)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def float64_of(x: np.ndarray) -> np.ndarray:
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


# ------------------------------------------------------------------ the IIR scan
@pytest.mark.parametrize("q", list(BANDS))
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_torch_scan_route_matches_jax(kind, order, q):
    """The dispatch's CPU route (``iir_scan`` and ``iir_filter(method=
    "scan")``) against JAX's scan: within 5e-6 of JAX's peak on the low-Q
    band; on the high-Q band no further from float64 than twice JAX."""
    x = signal(kind, (3000, 3), seed=order)
    b, a = bandpass(order, BANDS[q])
    want = jax_scan(b, a, x)
    got, _ = iir.iir_scan(b, a, torch.as_tensor(x))
    via_filter = iir.iir_filter(b, a, torch.as_tensor(x), method="scan")
    assert got.dtype == via_filter.dtype == torch.as_tensor(x).dtype
    assert torch.equal(got, via_filter)
    got = got.numpy()
    if q == "low-Q":
        assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()
    else:
        ref = lfilter(b, a, float64_of(x), axis=0)
        jerr, perr = np.abs(want - ref).max(), np.abs(got - ref).max()
        assert perr <= 2 * jerr + 1e-6 * np.abs(ref).max(), (perr, jerr)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_torch_scan_route_carries_state(kind, order):
    """``zi`` and the returned state over two chunks equal one pass bit for
    bit, and the first chunk's state is within 1e-5 of JAX's."""
    x = signal(kind, (2000, 2, 3), seed=10 + order)
    b, a = bandpass(order, BANDS["low-Q"])
    N = len(a) - 1
    zi = signal(kind, (2, 3, N), seed=20 + order)
    xt, zt = torch.as_tensor(x), torch.as_tensor(zi)
    whole, s_whole = iir.iir_scan(b, a, xt, zt)
    y1, s1 = iir.iir_scan(b, a, xt[:1200], zt)
    y2, s2 = iir.iir_scan(b, a, xt[1200:], s1)
    assert torch.equal(torch.cat([y1, y2]), whole) and torch.equal(s2, s_whole)
    jy, js = jax_scan(b, a, x[:1200], zi=zi, return_state=True)
    assert s1.shape == js.shape == (2, 3, N)
    assert np.abs(s1.numpy() - js).max() <= 1e-5 * np.abs(js).max()
    assert np.abs(y1.numpy() - jy).max() <= 5e-6 * np.abs(jy).max()


def emulate_scan(b, a, x: torch.Tensor, zi):
    """``hm_iir_scan`` in numpy from the wrapper's launch arguments: each
    lane's samples read through the strides, the recurrence in float32 one
    rounding an operation, the outputs written through ``y``'s strides and
    the final state in the (R, N, comps) layout."""
    bp, a_tail = iir.scan_coefficients(b, a)
    N = len(a_tail)
    x, y, state, (L, comps, D2, xs0, xs1, xs2, ys0, ys1, ys2) = iir_kernel.scan_layout(x, zi, N)
    xr, yr, zr = (torch.view_as_real(t) if t.is_complex() else t for t in (x, y, state))
    T = x.shape[0]
    j = np.arange(L)
    c, r = j % comps, j // comps
    i1, i2 = r // D2, r % D2
    x_off, y_off = i1 * xs1 + i2 * xs2 + c, i1 * ys1 + i2 * ys2 + c

    def flat(t):  # the storage a strided float tensor views, from its first element
        span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        return t.as_strided((span,), (1,))

    xf, yf = flat(xr).numpy(), flat(yr).numpy()
    f32 = np.float32
    coef = np.concatenate([bp, a_tail]).astype(f32)
    s = zr.reshape(-1, N, comps).numpy()[r, :, c].astype(f32) if zi is not None else np.zeros((L, N), f32)
    s = np.concatenate([s, np.zeros((L, 1), f32)], axis=1)
    for t in range(T):
        xv = xf[x_off + t * xs0]
        yv = (coef[0] * xv) + s[:, 0]
        for i in range(N):
            s[:, i] = ((coef[1 + i] * xv) - (coef[1 + N + i] * yv)) + s[:, i + 1]
        yf[y_off + t * ys0] = yv
    zf = np.zeros((L // comps, N, comps), f32)
    zf[r, :, c] = s[:, :N]
    zf = torch.as_tensor(zf)
    return y, (torch.view_as_complex(zf) if x.is_complex() else zf).reshape(state.shape)


LAYOUTS = {
    "real (T, 3)": lambda: torch.as_tensor(signal("real", (300, 3), 1)),
    "complex (T, 2, 3)": lambda: torch.as_tensor(signal("complex", (300, 2, 3), 2)),
    "real (B, T, M) along dim 1": lambda: torch.as_tensor(signal("real", (4, 300, 3), 3)).movedim(1, 0),
    "complex sliced": lambda: torch.as_tensor(signal("complex", (300, 6, 3), 4))[:, ::2],
    "real (T,)": lambda: torch.as_tensor(signal("real", (300,), 5)),
    "real uncollapsible": lambda: torch.as_tensor(signal("real", (300, 2, 3, 4), 6)).permute(0, 2, 1, 3),
}


@pytest.mark.parametrize("with_zi", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_torch_scan_kernel_indexing_model(layout, with_zi):
    """The kernel's indexing and order of operations, modelled in numpy from
    the wrapper's launch arguments, equal the plain loop bit for bit."""
    x = LAYOUTS[layout]()
    b, a = bandpass(2, BANDS["high-Q"])
    zi = torch.as_tensor(signal("complex" if x.is_complex() else "real", tuple(x.shape[1:]) + (4,), 9)) \
        if with_zi else None
    y, s = emulate_scan(b, a, x, zi)
    py, ps = iir.iir_scan_plain(b, a, x, zi)
    assert y.shape == py.shape and s.shape == ps.shape
    assert torch.equal(y, py) and torch.equal(s, ps)


def emulate_scan_tiles(b, a, x: torch.Tensor, zi):
    """``hm_iir_scan``'s copies in numpy: for each block of ``SCAN_LANES``
    lanes and each tile of ``SCAN_TS`` steps, the producer fills the ring
    (16-byte row pieces ``[lane0 + 4v, +4)`` of rows ``v // 8 + 4i`` where
    ``vector_rows`` allows them, else a float a live lane a step), the
    consumer runs its steps on the ring in place, and the producer drains y
    the same way; the lanes' state in (R, N, comps)."""
    bp, a_tail = iir.scan_coefficients(b, a)
    N = len(a_tail)
    x, y, state, (L, comps, D2, xs0, xs1, xs2, ys0, ys1, ys2) = iir_kernel.scan_layout(x, zi, N)
    xr, yr, zr = (torch.view_as_real(t) if t.is_complex() else t for t in (x, y, state))
    vec_x = iir_kernel.vector_rows(L, comps, D2, xs0, xs1, xs2, xr.data_ptr())
    vec_y = iir_kernel.vector_rows(L, comps, D2, ys0, ys1, ys2, yr.data_ptr())
    LANES, TS, VEC = iir_kernel.SCAN_LANES, iir_kernel.SCAN_TS, iir_kernel.SCAN_VEC

    def flat(t):  # the storage a strided float tensor views, from its first element
        span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        return t.as_strided((span,), (1,))

    xf, yf = flat(xr).numpy(), flat(yr).numpy()
    f32 = np.float32
    coef = np.concatenate([bp, a_tail]).astype(f32)
    zin = zr.reshape(-1, N, comps).numpy() if zi is not None else None
    zf = np.zeros((L // comps, N, comps), f32)
    T = x.shape[0]
    for lane0 in range(0, L, LANES):
        j = lane0 + np.arange(LANES)
        live = j < L
        c, r = j % comps, j // comps
        x_off = (r // D2) * xs1 + (r % D2) * xs2 + c
        y_off = (r // D2) * ys1 + (r % D2) * ys2 + c
        s = np.zeros((LANES, N + 1), f32)
        if zin is not None:
            s[live, :N] = zin[r[live], :, c[live]]
        for t0 in range(0, T, TS):
            n = min(TS, T - t0)
            ring = np.full((TS, LANES), np.nan, f32)
            for k in range(n):
                if vec_x:
                    for v in range(0, LANES, VEC):
                        if lane0 + v < L:
                            start = (t0 + k) * xs0 + lane0 + v
                            ring[k, v:v + VEC] = xf[start:start + VEC]
                else:
                    ring[k, live] = xf[(t0 + k) * xs0 + x_off[live]]
            for k in range(n):
                xv = ring[k]
                yv = (coef[0] * xv) + s[:, 0]
                for i in range(N):
                    s[:, i] = ((coef[1 + i] * xv) - (coef[1 + N + i] * yv)) + s[:, i + 1]
                ring[k] = yv
            for k in range(n):
                if vec_y:
                    for v in range(0, LANES, VEC):
                        if lane0 + v < L:
                            start = (t0 + k) * ys0 + lane0 + v
                            yf[start:start + VEC] = ring[k, v:v + VEC]
                else:
                    yf[(t0 + k) * ys0 + y_off[live]] = ring[k, live]
        zf[r[live], :, c[live]] = s[live, :N]
    zf = torch.as_tensor(zf)
    return y, (torch.view_as_complex(zf) if x.is_complex() else zf).reshape(state.shape), (vec_x, vec_y)


TILE_LAYOUTS = {
    "complex (T, 4, 7): 16-byte rows": (lambda: torch.as_tensor(signal("complex", (150, 4, 7), 11)), (True, True)),
    "real (T, 40): 16-byte rows, a partial block": (lambda: torch.as_tensor(signal("real", (70, 40), 12)),
                                                     (True, True)),
    "real (T, 14): a float a lane": (lambda: torch.as_tensor(signal("real", (130, 14), 13)), (False, False)),
    "real (B, T, M) along dim 1": (lambda: torch.as_tensor(signal("real", (8, 140, 4), 14)).movedim(1, 0),
                                   (False, False)),
    "real (T, 32) from column 1: x a float a lane, y by rows": (
        lambda: torch.as_tensor(signal("real", (65, 37), 15))[:, 1:33], (False, True)),
}


@pytest.mark.parametrize("with_zi", [False, True])
@pytest.mark.parametrize("layout", list(TILE_LAYOUTS))
def test_torch_scan_kernel_tiles_model(layout, with_zi):
    """The producer warp's copies through the ring, tile by tile, and the
    consumer's in-place steps, modelled in numpy: equal to the plain loop
    bit for bit, by the copy path ``vector_rows`` picks for the layout."""
    make, want_vec = TILE_LAYOUTS[layout]
    x = make()
    b, a = bandpass(2, BANDS["high-Q"])
    zi = torch.as_tensor(signal("complex" if x.is_complex() else "real", tuple(x.shape[1:]) + (4,), 16)) \
        if with_zi else None
    y, s, vec = emulate_scan_tiles(b, a, x, zi)
    py, ps = iir.iir_scan_plain(b, a, x, zi)
    assert vec == want_vec
    assert torch.equal(y, py) and torch.equal(s, ps)


@pytest.mark.parametrize("layout", list(LAYOUTS) + list(TILE_LAYOUTS))
def test_torch_scan_vector_rows_only_flat_lanes(layout):
    """``vector_rows`` takes a tensor's lanes by 16-byte rows only where lane
    j lies at float j of its step's row and the rows are whole aligned
    vectors: checked against the lanes' offsets from ``scan_layout``."""
    x = (LAYOUTS.get(layout) or TILE_LAYOUTS[layout][0])()
    x, y, _, (L, comps, D2, xs0, xs1, xs2, ys0, ys1, ys2) = iir_kernel.scan_layout(x, None, 2)
    for t, (s0, s1, s2) in ((x, (xs0, xs1, xs2)), (y, (ys0, ys1, ys2))):
        ptr = (torch.view_as_real(t) if t.is_complex() else t).data_ptr()
        j = np.arange(L)
        r = j // comps
        offsets = (r // D2) * s1 + (r % D2) * s2 + j % comps
        flat = np.array_equal(offsets, j)
        want = flat and L % 4 == 0 and s0 % 4 == 0 and ptr % 16 == 0
        assert iir_kernel.vector_rows(L, comps, D2, s0, s1, s2, ptr) == want
        assert not iir_kernel.vector_rows(L, comps, D2, s0, s1, s2, ptr + 4)  # never off a 16-byte boundary


# ------------------------------------------------------------------ the simulator
@pytest.mark.parametrize("B,N", [(1, 449), (96, 449), (3, 37), (2, 4096), (5, 1), (4, 700)])
def test_torch_sim_launch_plan(B, N):
    """Without a recurrence the flat grid covers the B x N neurons once, a
    thread each, and where B x N is a multiple of 32 every warp's neurons of
    every step are one 128-byte line.  A uniform recurrence takes the
    on-chip kernel, one CTA a row of at most ``ONCHIP_THREADS_MAX`` threads,
    the fewest neurons a thread; a dense one at each width the on-chip
    kernel on the fewest CTAs a row whose shared memory holds its slice,
    ``DENSE_SLOTS[width]`` neurons a thread, or, where no cluster holds it,
    the global-memory row kernel's block a row of whole warps, the fewest
    neurons a thread from two."""
    plan = sim_kernel.sim_launch(B, N)
    M = B * N
    assert (plan.kernel, plan.threads, plan.slots) == ("xylo_sim", sim_kernel.SIM_FREE_THREADS, 1)
    assert plan.blocks * plan.threads >= M > (plan.blocks - 1) * plan.threads
    if M % 32 == 0:
        warp_starts = np.arange(0, M, 32)
        for t in (0, 1, 7, 11_999):
            assert np.all((4 * (t * M + warp_starts)) % 128 == 0)
    plan = sim_kernel.sim_launch(B, N, "uniform")
    assert (plan.kernel, plan.blocks, plan.cluster, plan.width) == ("xylo_sim_onchip", B, 1, 0)
    assert plan.threads == -(-N // plan.slots) <= sim_kernel.ONCHIP_THREADS_MAX
    assert plan.slots == 1 or -(-N // (plan.slots // 2)) > sim_kernel.ONCHIP_THREADS_MAX
    for width in (1, 2, 4):
        plan = sim_kernel.sim_launch(B, N, "dense", width)
        fits = [c for c in sim_kernel.CLUSTERS if onchip_layout(N, width, c)]
        if fits:
            c = fits[0]
            S, nt, smem = onchip_layout(N, width, c)
            assert plan == sim_kernel.SimPlan("xylo_sim_onchip", B * c, nt, S, c, width, smem)
            assert nt * S * c >= N and smem <= sim_kernel.ONCHIP_SMEM_MAX and S * width <= 4
            assert c == 1 or nt % 32 == 0
        else:
            assert (plan.kernel, plan.blocks, plan.cluster) == ("xylo_sim_row", B, 1)
            assert plan.threads % 32 == 0 and plan.threads <= sim_kernel.SIM_THREADS_MAX
            assert plan.threads * plan.slots >= N and plan.slots in (2, 4, 8)
            assert plan.slots == 2 or (plan.slots // 2) * sim_kernel.SIM_THREADS_MAX < N


# the forms xylo_sim_onchip_kernel is built in: (neurons a thread, bytes an entry) of a dense w_rec
DENSE_FORMS = {(2, 1), (1, 2), (1, 4)}


def onchip_layout(N: int, width: int, c: int):
    """``(S, nt, smem)`` of a dense N x N ``w_rec`` at ``width`` bytes an
    entry on c CTAs a row, or None where it does not fit: S the neurons a
    thread of its width's form (:data:`DENSE_FORMS`), nt threads (whole
    warps on a cluster, at most 512), and the image of N + 1 rows of nt * S
    * width bytes (16-byte padded), two lists of ``onchip_cap`` uint16 and
    three counts, within 227 KB (counted here from the layout, not from the
    wrapper's helpers)."""
    S = next(k for k, w in DENSE_FORMS if w == width)
    per = -(-(-(-N // c)) // S)
    nt = per if c == 1 else -(-per // 32) * 32
    cap = -(-N // 8) * 8 + 8
    smem = -(-((N + 1) * nt * S * width) // 16) * 16 + 2 * 2 * cap + 16
    return (S, nt, smem) if nt <= 512 and smem <= 232_448 else None


WIDTH_EDGES = [(127, 1), (-128, 1), (128, 2), (-129, 2), (32767, 2), (-32768, 2), (32768, 4), (-32769, 4),
               (2**31 - 1, 4), (-2**31, 4)]


@pytest.mark.parametrize("value,width", WIDTH_EDGES)
def test_torch_sim_weight_width_boundaries(value, width):
    """int8 holds [-128, 127], int16 [-32768, 32767], int32 the rest: one
    entry at a boundary decides the width of a matrix of small entries."""
    w = np.zeros((5, 5), np.int64)
    w[2, 3] = value
    w[0, 0] = 1
    assert sim_kernel.weight_width(w) == width
    assert sim_kernel.weight_width(np.zeros((3, 3), np.int32)) == 1


def onchip_limit(width: int, c: int) -> int:
    """The largest N whose dense ``w_rec`` at ``width`` fits c CTAs a row."""
    N = 1
    while onchip_layout(N + 1, width, c):
        N += 1
    return N


# the largest N of each width on one CTA and on the portable cluster of eight
ONCHIP_LIMITS = {(1, 1): 479, (2, 1): 339, (4, 1): 240, (1, 8): 1184, (2, 8): 892, (4, 8): 597}


@pytest.mark.parametrize("width,c", list(ONCHIP_LIMITS))
def test_torch_sim_onchip_limits(width, c):
    """N at each width's on-chip limit: the largest N that fits one CTA a
    row (and eight) takes c = 1 (at most 8), one more neuron takes more CTAs
    (the global-memory row kernel past eight); a plan forced where it does not fit
    raises.  Xylo-A2's 1000 neurons in int8 take eight CTAs; N = 4096 takes
    the row kernel at every width."""
    N = ONCHIP_LIMITS[(width, c)]
    assert N == onchip_limit(width, c)
    plan = sim_kernel.sim_launch(96, N, "dense", width)
    assert plan.kernel == "xylo_sim_onchip" and plan.cluster <= c
    assert sim_kernel.sim_launch(96, N, "dense", width, cluster=c).cluster == c
    past = sim_kernel.sim_launch(96, N + 1, "dense", width)
    if c == 1:
        assert past.kernel == "xylo_sim_onchip" and past.cluster > 1
    else:
        assert past.kernel == "xylo_sim_row"
    with pytest.raises(ValueError, match="does not fit"):
        sim_kernel.sim_launch(96, N + 1, "dense", width, cluster=c)
    assert sim_kernel.sim_launch(96, 1000, "dense", 1) == sim_kernel.sim_launch(96, 1000, "dense", 1, cluster=8)
    assert sim_kernel.sim_launch(96, 4096, "dense", width).kernel == "xylo_sim_row"
    flagship = sim_kernel.sim_launch(96, 477, "dense", 1)
    assert flagship[:2] == ("xylo_sim_onchip", 96) and flagship.cluster == 1


@pytest.mark.parametrize("width", [1, 2, 4])
def test_torch_sim_planned_forms(width):
    """Every N from 1 to 4096 plans only a form the kernels are built in: a
    dense ``w_rec`` on chip at its width's neurons a thread
    (:data:`DENSE_FORMS`) on 1-8 CTAs, or the global-memory row kernel with
    2, 4 or 8 neurons a thread, never below N = 598 (int32 fits eight CTAs
    up to N = 597); a uniform one on one CTA a row at 1, 2, 4 or 8 neurons a
    thread, and a uniform one forced onto more CTAs raises."""
    for N in range(1, 4097):
        plan = sim_kernel.sim_launch(3, N, "dense", width)
        if plan.kernel == "xylo_sim_onchip":
            assert (plan.slots, plan.width) in DENSE_FORMS and plan.cluster in sim_kernel.CLUSTERS
            assert (plan.slots, plan.threads, plan.smem) == onchip_layout(N, width, plan.cluster)
        else:
            assert plan.kernel == "xylo_sim_row" and plan.slots in (2, 4, 8) and N >= 598
        uniform = sim_kernel.sim_launch(3, N, "uniform")
        assert uniform.cluster == 1 and uniform.slots in sim_kernel.UNIFORM_SLOTS
    for c in (2, 4, 8):
        with pytest.raises(ValueError, match="one CTA"):
            sim_kernel.sim_launch(3, 100, "uniform", cluster=c)
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        sim_kernel.sim_launch(3, 100, "dense", width, cluster=3)


def decode_image(image: np.ndarray, plan) -> np.ndarray:
    """``onchip_image`` read back the way the kernel reads it: CTA r's
    thread t's entry k of row m at byte ``m*row_bytes + (t*S + k)*W``
    (``entry_at``), at column r*Vc + k*nt + t."""
    c, nt, S, W = plan.cluster, plan.threads, plan.slots, plan.width
    row_bytes = nt * S * W
    N1 = image.shape[1] // row_bytes
    raw = image[:, :N1 * row_bytes].reshape(c, N1, nt, S, W).astype(np.int64)
    v = sum(raw[..., b] << (8 * b) for b in range(W))
    v = v - 128 if W == 1 else np.where(v >= 1 << (8 * W - 1), v - (1 << (8 * W)), v)
    return v.transpose(1, 0, 3, 2).reshape(N1, c * S * nt)  # (N1, c, S, nt): column r*Vc + k*nt + t


@pytest.mark.parametrize("N,width,c", [(37, 1, 1), (37, 1, 2), (45, 2, 4), (13, 4, 8), (477, 1, 1), (50, 2, 1),
                                       (61, 1, 8)])
def test_torch_sim_onchip_image_layout(N, width, c):
    """The image holds every entry of ``w_rec`` where the kernel looks for
    it, zeros in the padded columns and the pad row N, and each CTA's image
    a whole number of 16-byte vectors."""
    lo, hi = sim_kernel.WIDTHS[width]
    rng = np.random.default_rng(N + width + c)
    w = rng.integers(lo, hi, size=(N, N), endpoint=True)
    w[0, :2] = lo, hi
    plan = sim_kernel.sim_launch(3, N, "dense", width, cluster=c)
    image = sim_kernel.onchip_image(w, plan)
    assert image.dtype == np.uint8
    assert image.shape == (c, sim_kernel.onchip_image_bytes(N, plan.threads, plan.slots, width))
    assert image.shape[1] % 16 == 0
    got = decode_image(image, plan)
    assert got.shape[0] == N + 1
    np.testing.assert_array_equal(got[:N, :N], w)
    assert not got[N].any() and not got[:, N:].any()


@pytest.mark.parametrize("N,width,kernel", [(61, 1, "xylo_sim_onchip"), (700, 4, "xylo_sim_row")])
def test_torch_sim_dense_rec_keeps_its_operand(N, width, kernel):
    """``DenseRec`` copies the matrix it is given, checks it once, and
    builds the array its planned kernel reads once a layout and device:
    the on-chip image (read back equal to ``w_rec``) or the int32 matrix of
    the global-memory row kernel; the models hold one for a dense
    ``w_rec``."""
    lo, hi = sim_kernel.WIDTHS[width]
    w = np.random.default_rng(N).integers(-5, 6, size=(N, N))
    w[0, :2] = lo, hi
    held = sim_kernel.DenseRec(w)
    w[1, 1] = 99  # the caller's array changes later: the held copy does not
    assert held.w_rec[1, 1] != 99 and held.checked()[1] == width and held.checked() is held.checked()
    plan = sim_kernel.sim_launch(2, N, "dense", width)
    assert plan.kernel == kernel
    cpu = torch.device("cpu")
    got = held.operand(plan, cpu)
    assert held.operand(plan, cpu) is got
    if kernel == "xylo_sim_onchip":
        np.testing.assert_array_equal(decode_image(got.numpy(), plan)[:N, :N], held.w_rec)
    else:
        assert got.dtype == torch.int32 and torch.equal(got, torch.as_tensor(held.w_rec, dtype=torch.int32))
    cfg_rec = np.asarray(held.w_rec, np.int32)
    assert isinstance(sim.held_recurrence(cfg_rec)[1], sim_kernel.DenseRec)
    assert sim.held_recurrence(np.full((4, 4), -2))[1] is None


def emulate_onchip_sim(inp: np.ndarray, ds, dm, th, state0, ordering, reset, plan, *, w=None, coef=0):
    """``xylo_sim_onchip_kernel`` in numpy from the wrapper's ``plan`` and image:
    each row's c CTAs, CTA r's neurons r*Vc + k*nt + t; step 0's recurrence
    from ``spk0``'s values through the image (``entry_at``); every later
    step's from each CTA's own list of the step before's spikes, its warps'
    places reserved in an order that differs from CTA to CTA (the atomics'
    arrival), gathered ``ONCHIP_BLOCK`` entries at a time with the last
    block's surplus masked to a zero entry (its indices the list's stale
    ones: rows of the image), a thread's two int8 entries (stored + 128)
    summed as two 16-bit lanes an add and widened every ``ONCHIP_CHUNK``
    entries, less 128 an entry; the counts over three buffers, the lists
    over two; int32 LIF as the plain loop.  Returns the records and the
    final state."""
    T, B, N = inp.shape
    dense = w is not None
    assert plan.kernel == "xylo_sim_onchip" and plan.blocks == B * plan.cluster
    c, nt, S, W = plan.cluster, plan.threads, plan.slots, plan.width
    Vc, cap, BLOCK = S * nt, sim_kernel.onchip_cap(N), sim_kernel.ONCHIP_BLOCK
    nid = np.arange(c)[:, None, None] * Vc + np.arange(S)[None, :, None] * nt + np.arange(nt)[None, None, :]
    live = nid < N
    m = np.where(live, nid, 0)
    i64 = np.int64
    shift = lambda d: np.where((d < 0) | (d >= 31), 31, d)  # noqa: E731
    sds, sdm, thr = shift(np.asarray(ds)[m]), shift(np.asarray(dm)[m]), np.asarray(th, i64)[m]
    sat = lambda v: np.clip(v, -32768, 32767)  # noqa: E731
    stored = None
    if dense:  # the image's entries as stored: (c, N + 1, S, nt), int8 + 128
        image = sim_kernel.onchip_image(w, plan)
        raw = image[:, :(N + 1) * nt * S * W].reshape(c, N + 1, nt, S, W).astype(i64)
        stored = sum(raw[..., b] << (8 * b) for b in range(W)).transpose(0, 1, 3, 2)
        if W > 1:
            stored = np.where(stored >= 1 << (8 * W - 1), stored - (1 << (8 * W)), stored)
    pad = 128 if W == 1 else 0
    lanes16 = W == 1

    def gather(r, L, n):
        rec = np.zeros((S, nt), i64)
        i = 0
        while i < n:
            start, end = i, min(n, i + 256)
            acc = np.zeros((2, S, nt), i64)  # even and odd entries of the block
            while i < end:
                for j in range(BLOCK):
                    x = stored[r, L[i + j]] if i + j < end else np.full((S, nt), pad, i64)
                    acc[j & 1] += x
                    if lanes16:  # each 16-bit lane holds at most 128 entries of 255: no carry into the next
                        assert (acc[j & 1] < 1 << 16).all()
                i += BLOCK
            rec += acc.sum(0) - (128 * (i - start) if W == 1 else 0)
        return rec

    out = {k: np.zeros((T, B, N), np.int32) for k in ("spikes", "Isyn", "Vmem")}
    final = [np.zeros((B, N), np.int32) for _ in range(3)]
    warps = [(r, wp) for r in range(c) for wp in range(-(-nt // 32))]
    for b in range(B):
        isyn, vmem, spk = (np.asarray(s, i64).reshape(B, N)[b][m] * live for s in state0)
        lists = np.full((c, 2, cap), N, i64)  # every entry the pad row at first
        counts = np.zeros((c, 3), i64)
        rec = np.zeros((c, S, nt), i64)
        spk0 = np.asarray(state0[2], i64).reshape(B, N)[b]
        for r in range(c):
            if dense:
                for mm in np.flatnonzero(spk0):
                    rec[r] += spk0[mm] * (stored[r, mm] - (128 if W == 1 else 0))
            else:
                rec[r] = coef * spk0.sum()
        for t in range(T):
            if t > 0:
                for r in range(c):
                    n = counts[r, (t - 1) % 3]
                    rec[r] = gather(r, lists[r, (t - 1) % 2], n) if dense else coef * n
                    counts[r, (t + 1) % 3] = 0
            x = inp[t, b][m] * live + rec
            if ordering == "decay_first":
                isyn = sat(isyn - (isyn >> sds) + x)
                vmem = sat(vmem - (vmem >> sdm) + isyn)
            else:
                xv = sat(isyn + x)
                isyn = sat(xv - (xv >> sds))
                yv = sat(vmem + isyn)
                vmem = sat(yv - (yv >> sdm))
            fire = live & (vmem >= thr)
            spk = fire.astype(i64)
            vmem = np.where(fire, 0, vmem) if reset == "zero" else vmem - spk * thr
            for q in range(c):  # the warps' reservations reach CTA q in an order of their own
                order = warps[q % len(warps):] + warps[:q % len(warps)]
                if q % 2:
                    order = order[::-1]
                for r, wp in order:
                    lanes_ = slice(32 * wp, min(32 * wp + 32, nt))
                    got = [nid[r, k, lanes_][fire[r, k, lanes_]] for k in range(S)]
                    nw = sum(len(g) for g in got)
                    base = counts[q, t % 3]
                    counts[q, t % 3] += nw
                    if dense:
                        lists[q, t % 2, base:base + nw] = np.concatenate(got)
            for name, v in (("spikes", spk), ("Isyn", isyn), ("Vmem", vmem)):
                out[name][t, b][nid[live]] = v[live]
        for f, v in zip(final, (isyn, vmem, spk)):
            f[b][nid[live]] = v[live]
    return {k: torch.as_tensor(v) for k, v in out.items()}, tuple(torch.as_tensor(f) for f in final)


def onchip_case(rec, width, N, B, T, seed):
    """Inputs of the on-chip model: a sparse random dense ``w_rec`` whose
    entries reach its width's bounds (an all-zero row among them), or the
    uniform -1; ``spk0`` with values above 1."""
    rng = np.random.default_rng(seed)
    inp = rng.integers(-40, 91, size=(T, B, N)).astype(np.int32)
    ds, dm = rng.integers(-1, 33, size=N), rng.integers(1, 6, size=N)
    th = rng.integers(20, 60, size=N)
    state0 = (rng.integers(-300, 300, size=(B, N)).astype(np.int32),
              rng.integers(-300, 300, size=(B, N)).astype(np.int32),
              (rng.integers(0, 4, size=(B, N)) * (rng.random((B, N)) < 0.3)).astype(np.int32))
    w = None
    if rec == "dense":
        lo, hi = sim_kernel.WIDTHS[width]
        scale = {1: 1, 2: 300, 4: 70_000}[width]
        w = (rng.integers(-5, 6, size=(N, N)) * scale * (rng.random((N, N)) < 0.3)).astype(np.int64)
        w[0, 1] = lo if width == 1 else lo // 4096
        w[1, 0] = hi if width == 1 else hi // 4096 + 1
        w[2] = 0  # a spiking neuron whose row is all zeros
        state0[2][:, 2] = 2
    return inp, ds, dm, th, state0, w


# (recurrence, width, N, B, T, CTAs a row, neurons a thread, whether the plan chooses that many CTAs itself or the
# case forces them)
ONCHIP_MODEL_CASES = [
    ("dense", 1, 37, 3, 60, 1, 2, True), ("dense", 1, 37, 2, 60, 2, 2, False), ("dense", 1, 45, 1, 70, 4, 2, False),
    ("dense", 1, 61, 2, 50, 1, 2, True), ("dense", 1, 61, 2, 50, 8, 2, False), ("dense", 2, 45, 2, 50, 1, 1, True),
    ("dense", 2, 30, 2, 50, 4, 1, False), ("dense", 4, 23, 2, 50, 1, 1, True), ("dense", 4, 50, 1, 40, 8, 1, False),
    ("uniform", 0, 37, 3, 60, 1, 1, True), ("uniform", 0, 601, 2, 30, 1, 2, True),
    ("uniform", 0, 1100, 1, 20, 1, 4, True), ("uniform", 0, 2100, 1, 12, 1, 8, True),
    ("dense", 1, 601, 1, 12, 2, 2, True), ("dense", 2, 477, 1, 10, 4, 1, True),
]


@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
@pytest.mark.parametrize("rec,width,N,B,T,c,S,planned", ONCHIP_MODEL_CASES)
def test_torch_sim_onchip_kernel_model(rec, width, N, B, T, c, S, planned, ordering, reset):
    """The on-chip kernel's plan, image and index map, its list and counts,
    modelled in numpy (:func:`emulate_onchip_sim`): records and final state
    equal to the plain loop's, for dense ``w_rec`` at each width (entries at
    the width's bounds) on 1-8 CTAs a row, forced at small N and as N plans
    them (int8 at N = 601 on two, int16 at N = 477 on four), and the
    uniform -1 at 1, 2, 4 and 8 neurons a thread; N no multiple of S·c, B =
    1, ``spk0`` with values above 1 and a spiking neuron whose row of
    ``w_rec`` is zero."""
    inp, ds, dm, th, state0, w = onchip_case(rec, width, N, B, T, seed=N + B + c + 7 * width + S)
    if rec == "dense":
        assert sim_kernel.weight_width(w) == width
    plan = sim_kernel.sim_launch(B, N, rec, width if rec == "dense" else 4, None if planned else c)
    assert (plan.cluster, plan.slots) == (c, S)
    got, final = emulate_onchip_sim(inp, ds, dm, th, state0, ordering, reset, plan, w=w,
                                    coef=-1 if rec == "uniform" else 0)
    kw = dict(w_rec=w) if rec == "dense" else dict(rec_coef=-1)
    spikes, _, want_final, want = sim.scan_hidden_plain(torch.as_tensor(inp), ds, dm, th, state0, ordering=ordering,
                                                         reset=reset, record_state=True, **kw)
    assert int(spikes.sum()) > 0
    assert torch.equal(got["spikes"], spikes) and torch.equal(got["Isyn"], want["Isyn"])
    assert torch.equal(got["Vmem"], want["Vmem"])
    for g, v in zip(final, want_final):
        assert torch.equal(g, v)


@pytest.mark.parametrize("c", [1, 2, 4])
def test_torch_sim_onchip_kernel_model_long_lists(c):
    """Steps with more spikes than an int8 chunk (256): the 16-bit lanes
    widened between chunks, the last chunk's block masked, equal to the
    plain loop."""
    inp, ds, dm, th, state0, w = onchip_case("dense", 1, 300, 1, 12, seed=5)
    inp = np.full_like(inp, 400)
    dm = np.full_like(dm, 1)
    th = np.full_like(th, 20)
    plan = sim_kernel.sim_launch(1, 300, "dense", 1, cluster=c)
    got, final = emulate_onchip_sim(inp, ds, dm, th, state0, "decay_first", "subtract", plan, w=w)
    spikes, _, want_final, want = sim.scan_hidden_plain(torch.as_tensor(inp), ds, dm, th, state0, w_rec=w,
                                                         record_state=True)
    assert int(spikes.sum(-1).max()) > 256
    assert torch.equal(got["spikes"], spikes) and torch.equal(got["Vmem"], want["Vmem"])
    assert all(torch.equal(g, v) for g, v in zip(final, want_final))


def emulate_free_sim(inp: torch.Tensor, ds, dm, th, state0, ordering, reset):
    """``xylo_sim_free_kernel`` in numpy: thread m of ``sim_launch``'s flat
    grid (m < B x N) takes neuron n = m % N, reads its current at t * M + m
    and writes its records there; int32 throughout, PyTorch's shift rule."""
    T, B, N = inp.shape
    M = B * N
    plan = sim_kernel.sim_launch(B, N)
    m = np.arange(plan.blocks * plan.threads)
    m = m[m < M]
    n = m % N
    i32 = np.int32
    shift = lambda d: np.where((d < 0) | (d >= 31), 31, d).astype(i32)  # noqa: E731
    sds, sdm, thr = shift(np.asarray(ds)[n]), shift(np.asarray(dm)[n]), np.asarray(th, i32)[n]
    flat_in = inp.numpy().reshape(-1)
    isyn, vmem = (np.asarray(s, i32).reshape(-1)[m].copy() for s in state0[:2])
    spk = np.zeros_like(isyn)
    rec = {k: np.zeros(T * M, i32) for k in ("spikes", "Isyn", "Vmem")}
    sat = lambda v: np.clip(v, -32768, 32767).astype(i32)  # noqa: E731
    for t in range(T):
        cur = flat_in[t * M + m]
        if ordering == "decay_first":
            isyn = sat(isyn - (isyn >> sds) + cur)
            vmem = sat(vmem - (vmem >> sdm) + isyn)
        else:
            xv = sat(isyn + cur)
            isyn = sat(xv - (xv >> sds))
            yv = sat(vmem + isyn)
            vmem = sat(yv - (yv >> sdm))
        spk = (vmem >= thr).astype(i32)
        vmem = np.where(spk == 1, 0, vmem).astype(i32) if reset == "zero" else (vmem - spk * thr).astype(i32)
        for k, v in (("spikes", spk), ("Isyn", isyn), ("Vmem", vmem)):
            rec[k][t * M + m] = v
    return {k: torch.as_tensor(v.reshape(T, B, N)) for k, v in rec.items()}, (isyn, vmem, spk)


@pytest.mark.parametrize("T,B,N", [(37, 4, 45), (21, 1, 449)])
@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_sim_free_kernel_model(ordering, reset, T, B, N):
    """The flat kernel's index map and step, modelled in numpy on batches
    whose B x N (4 x 45, 1 x 449) is no multiple of a block and T no
    multiple of the 16-step read-ahead: records and final state equal to the
    plain loop's."""
    rng = np.random.default_rng(7)
    inp = torch.as_tensor(rng.integers(-90, 91, size=(T, B, N)).astype(np.int32))
    ds, dm = rng.integers(-1, 33, size=N), rng.integers(1, 6, size=N)
    th = rng.integers(20, 60, size=N)
    state0 = tuple(rng.integers(-300, 300, size=(B, N)).astype(np.int32) for _ in range(2)) + \
        (np.zeros((B, N), np.int32),)
    got, final = emulate_free_sim(inp, ds, dm, th, state0, ordering, reset)
    spikes, _, want_final, want = sim.scan_hidden_plain(inp, ds, dm, th, state0, ordering=ordering, reset=reset,
                                                         record_state=True)
    assert torch.equal(got["spikes"], spikes) and torch.equal(got["Isyn"], want["Isyn"])
    assert torch.equal(got["Vmem"], want["Vmem"])
    for g, w in zip(final, want_final):
        np.testing.assert_array_equal(g, w.numpy().reshape(-1))


def sim_inputs(rec: str, seed: int, T: int = 160, N: int = 13):
    rng = np.random.default_rng(seed)
    inp = rng.integers(-90, 91, size=(T, N)).astype(np.int32)
    w_rec = (np.full((N, N), -3) if rec == "uniform" else rng.integers(-8, 9, size=(N, N))).astype(np.int32)
    ds, dm = rng.integers(0, 6, size=N).astype(np.int32), rng.integers(1, 6, size=N).astype(np.int32)
    th = rng.integers(20, 60, size=N).astype(np.int32)
    state0 = (rng.integers(-300, 300, size=N).astype(np.int32), rng.integers(-300, 300, size=N).astype(np.int32),
              (rng.random(N) < 0.5).astype(np.int32))
    return inp, w_rec, ds, dm, th, state0


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("rec", ["uniform", "dense"])
@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_sim_route_matches_jax(ordering, reset, rec, record):
    """The dispatch's CPU route against ``_sim_hidden`` over two calls, the
    state carried: spikes, counts, records and states bit for bit."""
    inp, w_rec, ds, dm, th, state0 = sim_inputs(rec, seed=100 + 10 * CONVENTIONS.index((ordering, reset)) + len(rec))
    uniform = rec == "uniform"
    port_rec = dict(rec_coef=-3) if uniform else dict(w_rec=w_rec)
    j_state, t_state = tuple(jnp.asarray(s) for s in state0), state0
    for part in (inp[:70], inp[70:]):
        j_spk, j_state, j_rec = jax_sim_hidden(
            jnp.asarray(part), jnp.asarray(w_rec), jnp.asarray(-3 if uniform else 0, jnp.int32), jnp.asarray(ds),
            jnp.asarray(dm), jnp.asarray(th), j_state, uniform_rec=uniform, record=record, ordering=ordering,
            reset=reset)
        spk, counts, t_state, t_rec = sim.scan_hidden(torch.as_tensor(part), ds, dm, th, t_state, **port_rec,
                                                      ordering=ordering, reset=reset, record_state=record,
                                                      count=True)
        np.testing.assert_array_equal(spk.numpy(), np.asarray(j_spk))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(j_spk).sum(axis=0))
        assert sorted(t_rec) == sorted(j_rec)
        for k in j_rec:
            np.testing.assert_array_equal(t_rec[k].numpy(), np.asarray(j_rec[k]))
        for g, w in zip(t_state, j_state):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ the wrappers refuse
def _no_plain(monkeypatch):
    """Make the plain versions fail loudly, so that a wrapper that fell back
    to one would not raise its own error."""
    def boom(*args, **kwargs):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(iir, "iir_scan_plain", boom)
    monkeypatch.setattr(sim, "scan_hidden_plain", boom)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


SCAN_REFUSALS = {
    "float64": (TypeError, lambda: iir.iir_scan(*bandpass(2, BANDS["high-Q"]), _meta((50, 3), torch.float64))),
    "complex128": (TypeError, lambda: iir.iir_scan(*bandpass(2, BANDS["high-Q"]), _meta((50, 3), torch.complex128))),
    "int32": (TypeError, lambda: iir.iir_scan(*bandpass(1, BANDS["high-Q"]), _meta((50, 3), torch.int32))),
    "N = 10": (ValueError, lambda: iir.iir_scan(*bandpass(5, BANDS["high-Q"]), _meta((50, 3), torch.float32))),
    "off the card": (ValueError, lambda: iir.iir_scan(*bandpass(2, BANDS["high-Q"]), _meta((50, 3), torch.float32))),
    "iir_filter off the card": (ValueError, lambda: iir.iir_filter(*bandpass(1, BANDS["high-Q"]),
                                                                   _meta((50, 3), torch.complex64), method="scan")),
}


@pytest.mark.parametrize("case", list(SCAN_REFUSALS))
def test_torch_scan_wrapper_raises(case, monkeypatch):
    _no_plain(monkeypatch)
    err, call = SCAN_REFUSALS[case]
    with pytest.raises(err, match="CUDA" if case.endswith("card") else None):
        call()


def _sim_call(inp, N=5, **kw):
    rng = np.random.default_rng(0)
    return sim.scan_hidden(inp, rng.integers(1, 4, N), rng.integers(1, 4, N), np.full(N, 30), **kw)


SIM_REFUSALS = {
    "int64": (TypeError, lambda: _sim_call(_meta((20, 2, 5), torch.int64))),
    "float32": (TypeError, lambda: _sim_call(_meta((20, 2, 5), torch.float32))),
    "4097 neurons": (ValueError, lambda: _sim_call(_meta((20, 4097), torch.int32), N=4097)),
    "ordering": (ValueError, lambda: _sim_call(_meta((20, 5), torch.int32), ordering="leak_first")),
    "reset": (ValueError, lambda: _sim_call(_meta((20, 5), torch.int32), reset="none")),
    "w_rec shape": (ValueError, lambda: _sim_call(_meta((20, 5), torch.int32), w_rec=np.ones((4, 4), np.int32))),
    "rec_coef beyond int32": (ValueError, lambda: _sim_call(_meta((20, 5), torch.int32), rec_coef=2**31)),
    "off the card": (ValueError, lambda: _sim_call(_meta((20, 2, 5), torch.int32), rec_coef=-1)),
    "XyloSim off the card": (ValueError, lambda: sim_kernel.scan_hidden(_meta((20, 5), torch.int32), 1, 1, 30)),
    "a held w_rec off the card": (ValueError, lambda: _sim_call(_meta((20, 5), torch.int32),
                                                                 w_rec=sim_kernel.DenseRec(np.eye(5, dtype=np.int32)))),
    "a cluster without a dense w_rec": (ValueError, lambda: sim_kernel.scan_hidden(
        _meta((20, 5), torch.int32), 1, 1, 30, rec_coef=-1, cluster=2)),
}


@pytest.mark.parametrize("case", list(SIM_REFUSALS))
def test_torch_sim_wrapper_raises(case, monkeypatch):
    _no_plain(monkeypatch)
    err, call = SIM_REFUSALS[case]
    with pytest.raises(err, match="CUDA" if case.endswith("card") else None):
        call()


MIRRORS = {
    "iir_scan": (iir_kernel, "checked_scan_library", "hm_iir_scan_constants",
                 (iir_kernel.SCAN_N_MAX, iir_kernel.SCAN_LANES, iir_kernel.SCAN_TS, iir_kernel.SCAN_VEC)),
    "xylo_sim": (sim_kernel, "checked_library", "hm_xylo_sim_constants", sim_kernel.CONSTANTS),
}


@pytest.mark.parametrize("kernel", list(MIRRORS))
def test_torch_scan_wrappers_hold_their_constants_to_the_library(kernel, monkeypatch):
    """Each wrapper loads the library only once the constants its source
    exports (limits, block and tile sizes) equal the module's mirrors of
    them, and raises on any that differs (the library stubbed: no nvcc
    here)."""
    module, loader, symbol, mirrors = MIRRORS[kernel]
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
        getattr(module, loader).cache_clear()
        with pytest.raises(RuntimeError, match="differ"):
            getattr(module, loader)()
    wrong = list(mirrors)
    getattr(module, loader).cache_clear()
    try:
        assert getattr(module, loader)() is lib
    finally:
        getattr(module, loader).cache_clear()
    assert set(asked) == {(symbol, len(mirrors))}


def test_torch_sim_kernel_refuses_fractional_w_rec():
    with pytest.raises(ValueError, match="int32 integers"):
        sim_kernel._integer_weights(np.full((3, 3), 0.5))


# ------------------------------------------------------------------ K3-K6's twins stay on the loop
def test_torch_lif_twins_run_the_plain_loop(monkeypatch):
    """``lif_count_plain``, ``lif_count_stateful_bipolar_plain`` and
    ``lif_count_stateful_plain`` run ``scan_hidden_plain`` and never the
    dispatch, so that K3-K6 are held against the loop on the card."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import XyloConfig

    def no_dispatch(*args, **kwargs):
        raise AssertionError("a plain twin of K3-K6 reached the kernel's dispatch")

    calls = []
    plain = sim.scan_hidden_plain

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(sim, "scan_hidden", no_dispatch)
    monkeypatch.setattr(sim, "scan_hidden_plain", spy)
    rng = np.random.default_rng(3)
    C, N, T, B = 3, 7, 40, 2
    cfg = XyloConfig(w_in=rng.integers(-20, 21, size=(2 * C, N)).astype(np.int32), w_rec=np.zeros((N, N), np.int32),
                     w_out=np.zeros((N, 1), np.int32), dash_syn=np.full(N, 2, np.int32),
                     dash_mem=np.full(N, 3, np.int32), dash_syn_out=np.ones(1, np.int32),
                     dash_mem_out=np.ones(1, np.int32), threshold=np.full(N, 25, np.int32),
                     threshold_out=np.ones(1, np.int32), dt=1e-3, weight_scale=1.0)
    kp = torch.as_tensor(rng.random((T, B, C)) < 0.3)
    kn = torch.as_tensor(rng.random((T, B, C)) < 0.3)
    counts = lif_kernel.lif_count_plain(cfg, kp, kn)
    zero = torch.zeros((B, N), dtype=torch.int32)
    state_counts = lif_kernel.lif_count_stateful_bipolar_plain(cfg, kp, kn, zero, zero, zero)[0]
    raster = torch.cat([kp & ~kn, kn], dim=-1).to(torch.int8)
    raster_counts = lif_kernel.lif_count_stateful_plain(cfg, raster)[0]
    assert len(calls) == 3 and all(s == (T, B, N) for s in calls)
    assert torch.equal(counts, state_counts) and torch.equal(counts, raster_counts)


# ------------------------------------------------------------------ the bounds of phase 28
def jax_bounds() -> dict:
    """JAX's float64 error (largest |y - lfilter| over the largest |ref|) on
    each input of ``experiments/scan_kernels.iir_inputs``."""
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    out = {}
    for name, (b, a, x, axis, zi) in scan_kernels.iir_inputs().items():
        xm = x.movedim(axis, 0).numpy()
        kw = {} if zi is None else dict(zi=zi.numpy(), return_state=True)
        y = jax_scan(b, a, xm, **kw)
        y = y[0] if isinstance(y, tuple) else y
        ref = (lfilter(b, a, float64_of(xm), axis=0) if zi is None else
               lfilter(b, a, float64_of(xm), axis=0, zi=np.moveaxis(zi.numpy().astype(np.float64), -1, 0))[0])
        out[name] = float(np.abs(y - ref).max() / np.abs(ref).max())
    return out


if __name__ == "__main__":
    if "--jax-bounds" in sys.argv:
        print(jax_bounds())
