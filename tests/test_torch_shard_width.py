"""A stream's answer independent of the width of its batch.

On the card ``ops/iir.iir_cumsum_blocked`` runs the hand kernel
``csrc/iir_lifted.cu`` and matched scoring runs ``csrc/matched.cu``, each
with one order of summation per column or frame whatever the call's width;
their plain versions run on the CPU.  These tests hold, on the CPU:

- the plain lifted IIR per stream bit-identical at 1, 4, 7, 12, 24 and 96
  streams (level 2 and level 1, carried state, blocks of 32 and 48);
- a numpy model of the kernel's four stages (increments, level 2 with each
  row tile's trailing zero columns skipped, the per-column recurrence, the
  assembly) against the plain version, within 3 sqrt(T) eps_f32 of each
  column's largest value;
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
    over all columns at once: (z (T, L), state (L, N+1))."""
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
    # 1. increments: rows SB (the block sum) and SB+1.. (the state increment)
    sp = np.einsum("ki,bil->bkl", proj[sb:], xb).astype(np.float32)
    cP, sP = sp[:, 0], sp[:, 1:]
    s = zi[:, :N].T.copy()
    c = zi[:, N].copy()
    s_prev = np.zeros((nb, N, L), np.float32)
    c_prev = np.zeros((nb, L), np.float32)
    if "w2" in m:
        nb2, R2 = nb // Q, (Q + 1) * N
        # 2. level 2, each tile of RT rows summed up to its last nonzero column
        uv = np.zeros((nb2, R2, L), np.float32)
        sP2 = sP.reshape(nb2, Q * N, L)
        for t, ke in enumerate(m["kend"]):
            r = slice(t * iir_kernel.RT, min((t + 1) * iir_kernel.RT, R2))
            uv[:, r] = np.einsum("rk,ikl->irl", m["w2"][r, :ke], sP2[:, :ke])
        # 3. the recurrence: e's running sum over a super-block, every block's incoming state
        s = m["tinv"] @ s
        for i in range(nb2):
            run = np.zeros(L, np.float32)
            for q in range(Q):
                u = uv[i, q * N:(q + 1) * N]
                e = cP[i * Q + q] + m["h1m"] @ u
                s_prev[i * Q + q] = u + m["ps"][q * N:(q + 1) * N] @ s
                c_prev[i * Q + q] = (c + run) + m["hc"][q] @ s
                run = run + e
            s, c = m["ablk"] @ s + uv[i, Q * N:], (c + run) + m["hblk"] @ s
        s = m["tm"] @ s
    else:
        for k in range(nb):
            s_prev[k], c_prev[k] = s, c
            s, c = m["ablk"] @ s + sP[k], (c + cP[k]) + m["hblk"] @ s
    # 4. the assembly
    z = (np.einsum("ji,bil->bjl", proj[:sb], xb) + np.einsum("jn,bnl->bjl", m["hout"], s_prev)) + c_prev[:, None]
    return z.reshape(nb * sb, L)[:T], np.concatenate([s.T, c[:, None]], axis=1)


@pytest.mark.parametrize("T,sb", [(12_000, 32), (12_000, 48), (8224, 32), (1001, 32), (480, 8)],
                         ids=["flagship", "sb48", "level1-prime", "ragged", "sb8"])
def test_kernel_model_matches_plain(T, sb):
    b, a = _band()
    rng = np.random.default_rng(T + sb)
    x = rng.standard_normal((T, 6)).astype(np.float32)
    zi = (0.5 * rng.standard_normal((6, 3))).astype(np.float32)
    z, s = _kernel_model(b, a, x, zi, sb)
    kw = dict(zi=torch.as_tensor(zi), sb=sb)
    if T % sb == 0:
        rz, rs = iir.iir_cumsum_blocked_plain(b, a, torch.as_tensor(x), return_state=True, **kw)
        sref = rs.numpy()
        assert np.abs(s - sref).max() <= 3 * np.sqrt(T) * EPS * np.abs(sref).max()
    else:
        rz = iir.iir_cumsum_blocked_plain(b, a, torch.as_tensor(x), **kw)
    ref = rz.numpy().astype(np.float64)
    scale = np.abs(ref).max(axis=0)
    assert (np.abs(z - ref).max(axis=0) / scale).max() <= 3 * np.sqrt(T) * EPS


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
