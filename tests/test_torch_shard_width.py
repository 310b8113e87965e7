"""A stream's answer independent of the width of its batch.

On the card ``ops/iir.iir_cumsum_blocked`` runs the hand kernel
``csrc/iir_lifted.cu`` and matched scoring runs ``csrc/matched.cu``, each
with one order of summation per column or frame whatever the call's width;
their plain versions run on the CPU.  These tests hold, on the CPU:

- the plain lifted IIR per stream bit-identical at 1, 4, 7, 12, 24 and 96
  streams (level 2 and level 1, carried state, blocks of 32 and 48);
- a numpy model of the kernel's stages (the super-block pass: increments,
  level 2 with each row tile's trailing zero columns skipped, e's running
  sum; the assembly: the outer recurrence up to its super-block, the entry
  state, z; and level 1) against the plain version and the JAX package's
  ``blocked_cumsum``, within 3 sqrt(T) eps_f32 of each column's largest
  value, and the matrices it reads;
- a numpy model of the matched kernel's tiled order against the plain
  version and JAX's matched scores, within 2 K eps sum |r t|;
- the routes: a CPU tensor never reaches a CUDA wrapper, and a wrapper whose
  library cannot load raises instead of running its plain version;
- the GPU lane ``tests_gpu/`` skips every test here, and neither it, the
  port nor ``chip_smoke.py`` imports JAX.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from haghighatshoarmuir2024_tpu_torch.ops import iir
from haghighatshoarmuir2024_tpu_torch.ops.cuda import iir_kernel, matched_kernel

REPO = Path(__file__).resolve().parent.parent
C = 14  # the flagship's columns a stream: 2 x 7 microphones
WIDTHS = (1, 4, 7, 12, 24, 96)
EPS = float(np.finfo(np.float32).eps)


def _band(fs=48_000.0):
    return iir.butter_bandpass(1, (1600.0, 1900.0), fs)


def _inputs(T, streams, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, streams, C)).astype(np.float32)
    zi = (0.5 * rng.standard_normal((streams, C, 3))).astype(np.float32)
    return torch.as_tensor(x), torch.as_tensor(zi)


# (T, sb, fs): level 2 (nb = 60 and 50 blocks, Q = nb) and level 1 (nb = 2, Q = 2)
CASES = {"level2-sb32": (1920, 32, 48_000.0), "level2-sb48": (2400, 48, 24_000.0),
         "level1-sb32": (64, 32, 48_000.0), "level1-sb48": (96, 48, 24_000.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_lifted_iir_same_per_stream_at_every_width(case):
    T, sb, fs = CASES[case]
    b, a = _band(fs)
    nb, Q = iir.lifted_plan(2, T, sb)
    assert (Q > 2) == case.startswith("level2")
    x, zi = _inputs(T, max(WIDTHS), seed=sb + T)
    z_all, s_all = iir.iir_cumsum_blocked_plain(b, a, x, zi=zi, return_state=True, sb=sb)
    for w in WIDTHS:
        z, s = iir.iir_cumsum_blocked_plain(b, a, x[:, :w], zi=zi[:w], return_state=True, sb=sb)
        assert torch.equal(z, z_all[:, :w]), f"{w} streams: the output moved"
        assert torch.equal(s, s_all[:w]), f"{w} streams: the final state moved"


def _kernel_model(b, a, x, zi, sb):
    """What csrc/iir_lifted.cu computes, stage by stage, in numpy float32
    over all columns at once: (z (T, L), state (L, N+1)).  Level 2: the
    super-block pass (the increments, each row tile of WsBm2 up to its last
    nonzero column, e and its exclusive running sum and total), then the
    assembly, which runs its column's outer recurrence up to its super-block
    from the carried state, forms the entry state from U and run, and
    assembles z.  Level 1: the increments, the block recurrence, the same
    assembly."""
    b_key = tuple(np.asarray(b, np.float64).tolist())
    a_key = tuple(np.asarray(a, np.float64).tolist())
    N = len(a_key) - 1
    T, L = x.shape
    nb, Q = iir.lifted_plan(N, T, sb)
    m = {k: v.numpy() for k, v in iir_kernel.kernel_matrices(b_key, a_key, sb, Q, torch.device("cpu")).items()}
    xb = np.zeros((nb * sb, L), np.float32)
    xb[:T] = x
    xb = xb.reshape(nb, sb, L)
    proj = m["proj"]
    # the increments: row SB (the block sum) and SB+1.. (the state increment)
    sp = np.einsum("ki,bil->bkl", proj[sb:], xb).astype(np.float32)
    cP, sP = sp[:, 0], sp[:, 1:]
    s0 = zi[:, :N].T.copy()
    c0 = zi[:, N].copy()
    s_prev = np.zeros((nb, N, L), np.float32)
    c_prev = np.zeros((nb, L), np.float32)
    if "w2" in m:
        nb2, R2 = nb // Q, (Q + 1) * N
        # (a) the super-block pass: U and V, each tile of RT rows up to its last nonzero column,
        # e = cP + h1m . U and its exclusive running sum over the super-block, and its total
        uv = np.zeros((nb2, R2, L), np.float32)
        sP2 = sP.reshape(nb2, Q * N, L)
        for t, ke in enumerate(m["kend"]):
            r = slice(t * iir_kernel.RT, min((t + 1) * iir_kernel.RT, R2))
            uv[:, r] = np.einsum("kr,ikl->irl", m["w2t"][:ke, r], sP2[:, :ke])
        U = uv[:, :Q * N].reshape(nb, N, L)
        V = uv[:, Q * N:]
        e = cP + np.einsum("n,bnl->bl", m["h1m"], U).astype(np.float32)
        run = np.zeros((nb, L), np.float32)
        total = np.zeros((nb2, L), np.float32)
        for i in range(nb2):
            acc = np.zeros(L, np.float32)
            for q in range(Q):
                run[i * Q + q] = acc
                acc = acc + e[i * Q + q]
            total[i] = acc
        # (b) the assembly's entry states: every super-block runs the outer recurrence anew up to itself
        for i in range(nb2 + 1):
            s, c = m["tinv"] @ s0, c0
            for k in range(i):
                s, c = m["ablk"] @ s + V[k], (c + total[k]) + m["hblk"] @ s
            if i == nb2:
                break
            for q in range(Q):
                s_prev[i * Q + q] = U[i * Q + q] + m["ps"][q * N:(q + 1) * N] @ s
                c_prev[i * Q + q] = (c + run[i * Q + q]) + m["hc"][q] @ s
        s = m["tm"] @ s
    else:
        s, c = s0, c0
        for k in range(nb):
            s_prev[k], c_prev[k] = s, c
            s, c = m["ablk"] @ s + sP[k], (c + cP[k]) + m["hblk"] @ s
    # the assembly: G2's lower triangle, Hout . s_prev, c_prev
    g2 = np.tril(proj[:sb])
    assert np.array_equal(g2, proj[:sb]), "G2 has entries above its diagonal"
    z = (np.einsum("ji,bil->bjl", g2, xb) + np.einsum("jn,bnl->bjl", m["hout"], s_prev)) + c_prev[:, None]
    return z.reshape(nb * sb, L)[:T], np.concatenate([s.T, c[:, None]], axis=1)


# (T, sb, filter order): order 1 is the flagship's 1600-1900 Hz bandpass (N = 2); order 2 (N = 4) is the
# 500-3000 Hz bandpass of chip_smoke's second scan case: the 1600-1900 Hz one of order 2 has its poles so close
# to the unit circle that two float32 orders of its sums part by more than 3 sqrt(T) eps (JAX's tests run it in
# float64), and at level 1 its 257-step block recurrence in float32 parts from another order by 5e-5 of a
# column's largest value at T = 12 336 (bound 4e-5), so level 1 is held at N = 2
MODEL_CASES = {"flagship": (12_000, 32, 1), "sb48": (12_000, 48, 1), "level1-prime": (8224, 32, 1),
               "ragged": (1001, 32, 1), "sb8": (480, 8, 1), "sb24": (6000, 24, 1), "sb64": (12_800, 64, 1),
               "level1-nb2": (64, 32, 1), "N4": (12_000, 32, 2), "N4-sb48": (4800, 48, 2),
               "N4-ragged": (3001, 32, 2)}


def _model_inputs(case):
    T, sb, order = MODEL_CASES[case]
    b, a = iir.butter_bandpass(order, (1600.0, 1900.0) if order == 1 else (500.0, 3000.0), 48_000.0)
    N = len(a) - 1
    rng = np.random.default_rng(T + sb + order)
    x = rng.standard_normal((T, 6)).astype(np.float32)
    zi = (0.5 * rng.standard_normal((6, N + 1))).astype(np.float32)
    return b, a, x, zi, T, sb


def _col_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float((np.abs(np.asarray(got, np.float64) - ref).max(axis=0) / np.abs(ref).max(axis=0)).max())


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_kernel_model_matches_plain(case):
    b, a, x, zi, T, sb = _model_inputs(case)
    nb, Q = iir.lifted_plan(len(a) - 1, T, sb)
    assert (Q > 2) == ("level1" not in case)
    z, s = _kernel_model(b, a, x, zi, sb)
    kw = dict(zi=torch.as_tensor(zi), sb=sb)
    if T % sb == 0:
        rz, rs = iir.iir_cumsum_blocked_plain(b, a, torch.as_tensor(x), return_state=True, **kw)
        sref = rs.numpy()
        assert np.abs(s - sref).max() <= 3 * np.sqrt(T) * EPS * np.abs(sref).max()
    else:
        rz = iir.iir_cumsum_blocked_plain(b, a, torch.as_tensor(x), **kw)
    assert _col_err(z, rz.numpy()) <= 3 * np.sqrt(T) * EPS


@pytest.mark.parametrize("case", ["sb48", "ragged", "sb24", "sb8", "level1-nb2", "N4-sb48", "N4-ragged"])
def test_kernel_model_matches_jax_blocked_cumsum(case):
    """The model against the JAX package's ``iir_filter(method=
    "blocked_cumsum")`` on the same float32 input and carried state, as the
    JAX tests run it on the CPU, within 3 sqrt(T) eps_f32 of each column's
    largest value."""
    import jax.numpy as jnp

    from haghighatshoarmuir2024_tpu.ops.iir import iir_filter as jax_iir_filter

    b, a, x, zi, T, sb = _model_inputs(case)
    z, _ = _kernel_model(b, a, x, zi, sb)
    ref = np.asarray(jax_iir_filter(b, a, jnp.asarray(x), axis=0, method="blocked_cumsum", zi=jnp.asarray(zi), sb=sb))
    assert _col_err(z, ref) <= 3 * np.sqrt(T) * EPS


def test_kernel_matrices_skip_only_zero_columns():
    """Every column a level-2 row tile skips is zero in each of its rows."""
    b, a = _band()
    for sb, T in ((32, 12_000), (48, 12_000), (8, 480)):
        nb, Q = iir.lifted_plan(2, T, sb)
        m = iir_kernel.kernel_matrices(tuple(b.tolist()), tuple(a.tolist()), sb, Q, torch.device("cpu"))
        w2 = m["w2"].numpy()
        assert w2.shape == ((Q + 1) * 2, Q * 2)
        for t, ke in enumerate(m["kend"].tolist()):
            rows = w2[t * iir_kernel.RT:(t + 1) * iir_kernel.RT]
            assert not rows[:, ke:].any() and rows[:, ke - 1].any()


@pytest.mark.parametrize("order,sb,T", [(1, 32, 12_000), (1, 48, 12_000), (1, 8, 480), (2, 32, 4800)])
def test_kernel_matrices_w2t_is_w2_transposed_in_whole_tiles(order, sb, T):
    """``w2t``, the level-2 coefficients as the super-block pass reads them:
    ``w2`` transposed, its rows padded with zeros to whole tiles of RT, so
    a tile's coefficients of one column are four aligned float4s."""
    b, a = iir.butter_bandpass(order, (1600.0, 1900.0) if order == 1 else (500.0, 3000.0), 48_000.0)
    N = len(a) - 1
    nb, Q = iir.lifted_plan(N, T, sb)
    m = iir_kernel.kernel_matrices(tuple(b.tolist()), tuple(a.tolist()), sb, Q, torch.device("cpu"))
    w2, w2t = m["w2"].numpy(), m["w2t"].numpy()
    R2 = (Q + 1) * N
    tiles = len(m["kend"])
    assert w2t.shape == (Q * N, tiles * iir_kernel.RT) and tiles == -(-R2 // iir_kernel.RT)
    assert w2t.dtype == np.float32 and m["w2t"].is_contiguous()
    assert np.array_equal(w2t[:, :R2], w2.T) and not w2t[:, R2:].any()
    assert (w2t.shape[1] * 4) % 16 == 0


def _butterfly(v):
    """The kernels' warp_sum over the last axis (32 lanes): at each of the
    offsets 16, 8, 4, 2, 1 a lane adds its partner's value, lane ^ off, to
    its own; returns lane 0's sum (every lane ends with the same bits)."""
    v = v.copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ off]).astype(np.float32)
    return v[..., 0]


def _matched_model(rate, table, ft=8, rows=32, center=True):
    """What csrc/matched.cu computes, in numpy float32: tiles of ``ft``
    frames and ``rows`` table rows; a frame's mean by lanes j over k = j
    (mod 32), ascending, then the butterfly, over K; a score by the lanes
    the same way (one multiply-add a term) and the same butterfly.  A tile's
    frames share only the table loads: each score's order is its own."""
    B, K = rate.shape
    G = table.shape[0]
    out = np.zeros((B, G), np.float32)
    kpad = -(-K // 32) * 32
    for b0 in range(0, B, ft):
        r = np.zeros((min(ft, B - b0), kpad), np.float32)
        r[:, :K] = rate[b0:b0 + ft]
        lanes = r.reshape(len(r), -1, 32)  # [frame][k // 32][lane]
        if center:
            acc = np.zeros((len(r), 32), np.float32)
            for step in range(lanes.shape[1]):
                acc = (acc + lanes[:, step]).astype(np.float32)
            mean = (_butterfly(acc) / np.float32(K)).astype(np.float32)
            r[:, :K] = (r[:, :K] - mean[:, None]).astype(np.float32)
        for g0 in range(0, G, rows):
            t = np.zeros((min(rows, G - g0), kpad), np.float32)
            t[:, :K] = table[g0:g0 + rows]
            acc = np.zeros((len(r), len(t), 32), np.float32)
            for step in range(kpad // 32):
                ks = slice(32 * step, 32 * step + 32)
                acc = (acc + r[:, None, ks] * t[None, :, ks]).astype(np.float32)
            out[b0:b0 + len(r), g0:g0 + len(t)] = _butterfly(acc)
    return out


@pytest.mark.parametrize("B,K,G,center", [(96, 449, 449, True), (7, 449, 449, True), (13, 1347, 449, False),
                                          (5, 50, 33, True)])
def test_matched_kernel_model_matches_plain_and_jax(B, K, G, center):
    """The tiled model of the matched kernel against ``matched_scores_plain``
    and the JAX pipeline's matched scores (its matmul of the centred rates
    at HIGHEST precision), within the dot products' error bound
    2 K eps sum |r t|; and each frame's scores the same in any tile."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(B + K + G)
    rate = (rng.random((B, K)) * 300).astype(np.float32)
    table = rng.standard_normal((G, K)).astype(np.float32)
    got = _matched_model(rate, table, center=center)
    r64 = rate.astype(np.float64) - (rate.astype(np.float64).mean(axis=-1, keepdims=True) if center else 0.0)
    tol = 2 * K * EPS * (np.abs(r64) @ np.abs(table.astype(np.float64)).T)
    plain = matched_kernel.matched_scores_plain(torch.as_tensor(rate), torch.as_tensor(table), center).numpy()
    jr = jnp.asarray(rate)
    if center:
        jr = jr - jnp.mean(jr, axis=-1, keepdims=True)
    ref_jax = np.asarray(jnp.matmul(jr, jnp.asarray(table).T, precision=jax.lax.Precision.HIGHEST))
    for ref in (plain, ref_jax):
        assert np.all(np.abs(got.astype(np.float64) - ref) <= tol)
    # the width contract of the tiled order: a frame scored alone or in another tile, bit for bit
    alone = _matched_model(rate[1:2], table, center=center)
    assert np.array_equal(alone[0], got[1])
    assert np.array_equal(_matched_model(rate, table, ft=4, center=center), got)


def _refuse(*_, **__):
    raise AssertionError("a CPU tensor reached a CUDA wrapper")


def test_cpu_tensor_never_reaches_the_cuda_wrappers(monkeypatch):
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(iir_kernel, "iir_lifted", _refuse)
    monkeypatch.setattr(iir_kernel, "library", _refuse)
    monkeypatch.setattr(matched_kernel, "library", _refuse)
    monkeypatch.setattr(_build, "library", _refuse)
    b, a = _band()
    x, zi = _inputs(640, 2, seed=1)
    z, s = iir.iir_cumsum_blocked(b, a, x, zi=zi, return_state=True)
    rz, rs = iir.iir_cumsum_blocked_plain(b, a, x, zi=zi, return_state=True)
    assert torch.equal(z, rz) and torch.equal(s, rs)
    rate, table = torch.rand(5, 17), torch.rand(17, 17)
    assert torch.equal(matched_kernel.matched_scores(rate, table), matched_kernel.matched_scores_plain(rate, table))


def test_cpu_matched_epilogue_unchanged():
    """The CPU route of matched scoring is the epilogue as it was: one
    matmul of the centred rates with the table."""
    rng = np.random.default_rng(4)
    rate = torch.as_tensor(rng.random((7, 449)).astype(np.float32) * 300)
    table = torch.as_tensor(rng.standard_normal((449, 449)).astype(np.float32))
    want = torch.matmul(rate - rate.mean(dim=-1, keepdim=True), table.T)
    assert torch.equal(matched_kernel.matched_scores(rate, table), want)


def _old_blockcos(x, G):
    xb = x.reshape(*x.shape[:-1], -1, G)
    xb = xb - xb.mean(dim=-1, keepdim=True)
    return (xb / torch.linalg.vector_norm(xb, dim=-1, keepdim=True).clamp_min(1e-12)).reshape(x.shape)


def _old_cos1(x):
    xc = x - x.mean(dim=-1, keepdim=True)
    return xc / torch.linalg.vector_norm(xc, dim=-1, keepdim=True).clamp_min(1e-12)


@pytest.mark.parametrize("weight", ["peak", "peak2", "contrast"])
def test_cpu_stacked_scoring_unchanged(weight):
    """The CPU route of the band-stacked estimators is the scoring as it was
    before their sums went through ``row_sums`` on the card: the same
    reductions, einsum and matmuls, bit for bit."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import pipeline as pl

    rng = np.random.default_rng(5)
    G, F = 449, 3
    rate = torch.as_tensor((rng.random((7, F * G)) * 300).astype(np.float32))
    prof = torch.as_tensor((rng.random((G, F * G)) * 300).astype(np.float32))
    cb, pb = _old_blockcos(rate, G).reshape(7, F, G), _old_blockcos(prof, G).reshape(G, F, G)
    rf = _old_cos1(rate.reshape(7, F, G).mean(dim=-2))
    pf = _old_cos1(prof.reshape(G, F, G).mean(dim=-2))
    comp = torch.cat([torch.einsum("...fg,pfg->...fp", cb, pb), torch.matmul(rf, pf.T)[..., None, :]], dim=-2)
    pk = comp.amax(dim=-1)
    w = {"peak": pk, "peak2": pk**2, "contrast": torch.clamp_min(pk - pl._median(comp), 0.0)}[weight]
    assert torch.equal(pl._auto_blend_scores(rate, prof, G, weight), (comp * w[..., None]).sum(dim=-2))
    assert torch.equal(pl._blockcos(rate, G), _old_blockcos(rate, G))
    assert torch.equal(pl._cos1(rate), _old_cos1(rate))


def _cannot_load():
    raise RuntimeError("the kernel library cannot load")


@pytest.mark.parametrize("route", ["iir_lifted", "matched"])
def test_wrapper_raises_when_its_library_cannot_load(route, monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: with the library
    unloadable it raises, and its plain version never runs."""
    monkeypatch.setattr(iir, "iir_cumsum_blocked_plain", _refuse)
    monkeypatch.setattr(matched_kernel, "matched_scores_plain", _refuse)
    monkeypatch.setattr(iir_kernel, "library", _cannot_load)
    monkeypatch.setattr(matched_kernel, "library", _cannot_load)
    b, a = _band()
    x = torch.empty((640, 28), device="meta")
    with pytest.raises(RuntimeError, match="cannot load"):
        if route == "iir_lifted":
            iir.iir_cumsum_blocked(b, a, x)
        else:
            matched_kernel.matched_scores(x[:3, :17], torch.empty((17, 17), device="meta"))


def test_gpu_lane_skips_without_a_card():
    """``python -m pytest tests_gpu -q`` on a host with no card: exit 0,
    every test skipped, none run."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "pytest", "tests_gpu", "-q", "-p", "no:cacheprovider",
                           "-p", "no:randomly", "-rs"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    tail = proc.stdout.strip().splitlines()[-1]
    assert "skipped" in tail and "passed" not in tail and "failed" not in tail and "error" not in tail, tail


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_in_the_gpu_lane_the_port_or_chip_smoke():
    files = [REPO / "chip_smoke.py", *sorted((REPO / "tests_gpu").glob("*.py")),
             *sorted((REPO / "haghighatshoarmuir2024_tpu_torch").rglob("*.py"))]
    assert len(files) > 50 and any(f.parent.name == "tests_gpu" for f in files)
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "haghighatshoarmuir2024_tpu"), f"{f.relative_to(REPO)} imports {mod}"
