"""The roofline probes of the PyTorch port on the CPU: the plain versions of
P1–P3 (``ops/cuda/roofline_kernel.py``) bit-exact against the JAX probe
bodies of ``experiments/vpu_roofline.py`` run through ``pl.pallas_call`` in
interpret mode; the ported op and byte counters; the harness
(``experiments/roofline.py``) refusing to run without a card; and the port's
entry points refusing to fall back to the CPU.  The CUDA kernels are held
against the same plain versions on the card by ``chip_smoke.py`` (phase 16).
"""
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from haghighatshoarmuir2024_tpu_torch import CenterCircularArray
from haghighatshoarmuir2024_tpu_torch.config import BeamformerConfig, MUSICConfig
from haghighatshoarmuir2024_tpu_torch.experiments import (roofline, target_push_to_hidden, target_xylo_localization,
                                                          xylo_ordering_sensitivity)
from haghighatshoarmuir2024_tpu_torch.models.beamformer import Beamformer
from haghighatshoarmuir2024_tpu_torch.models.music import MUSIC
from haghighatshoarmuir2024_tpu_torch.models.snn_beamformer import SNNBeamformer
from haghighatshoarmuir2024_tpu_torch.models.srp_phat import SRPPHAT
from haghighatshoarmuir2024_tpu_torch.models.xylo import (Demo, DemoPushToHidden, XyloConfig, XyloSim,
                                                          sim_hidden_batch)
from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import XyloSimPushToHidden
from haghighatshoarmuir2024_tpu_torch.parallel import montecarlo
from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel as lk
from haghighatshoarmuir2024_tpu_torch.ops.cuda import roofline_kernel as rk
from haghighatshoarmuir2024_tpu_torch.runtime.streaming import StreamState
from haghighatshoarmuir2024_tpu_torch.tools import localize
from haghighatshoarmuir2024_tpu_torch.utils import tracking

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def vr():
    """The TPU harness, loaded from its path (``experiments/`` is no package)."""
    spec = importlib.util.spec_from_file_location("vpu_roofline", REPO / "experiments" / "vpu_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_library(monkeypatch):
    """The CPU path must neither load the kernel library nor count a launch."""
    def refuse():
        raise AssertionError("the CPU path must not load the CUDA library")

    monkeypatch.setattr(rk, "library", refuse)
    before = dict(_build.launch_counts)
    yield
    assert dict(_build.launch_counts) == before


@pytest.mark.parametrize("lo,hi", [(1, 2), (-1000, 1000)])
def test_torch_p1_plain_matches_pallas(vr, lo, hi, no_library):
    x = np.random.default_rng(abs(lo)).integers(lo, hi, size=(8, 512)).astype(np.int32)
    with jax.enable_x64(False):  # the probe's shift amounts are Python ints, int32 as on the TPU
        ref = pl.pallas_call(functools.partial(vr._peak_kernel, iters=64, unroll=16),
                             out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32), interpret=True)(jnp.asarray(x))
    got = rk.lif_peak(torch.as_tensor(x), 64, ilp=4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tbe,w,rep", [(64, 5, 2), (352, 11, 1), (40, 1, 3)])
def test_torch_p2_plain_matches_pallas(vr, tbe, w, rep, no_library):
    x = np.random.default_rng(tbe).standard_normal((tbe, 128)).astype(np.float32)
    ref = pl.pallas_call(functools.partial(vr._shiftmax_peak_kernel, rep=rep, w=w),
                         out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True)(jnp.asarray(x))
    got = rk.shiftmax(torch.as_tensor(x)[None], w, rep)[0]
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(ref).view(np.int32))
    assert (got.numpy() != x).any()


def small_config(seed: int, C: int = 6, N: int = 20) -> XyloConfig:
    """A random bipolar config whose 16-bit clips are provably dead (the
    flagship fast path P3 takes): weights in [-20, 20], dash 1-3."""
    r = np.random.default_rng(seed)
    return XyloConfig(
        w_in=r.integers(-20, 21, size=(2 * C, N)).astype(np.int32), w_rec=np.zeros((N, N), np.int32),
        w_out=np.ones((N, 1), np.int32), dash_syn=r.integers(1, 4, size=N).astype(np.int32),
        dash_mem=r.integers(1, 4, size=N).astype(np.int32), dash_syn_out=np.ones(1, np.int32),
        dash_mem_out=np.ones(1, np.int32), threshold=r.integers(30, 200, size=N).astype(np.int32),
        threshold_out=np.ones(1, np.int32), dt=1e-3, weight_scale=1.0,
    )


@pytest.mark.parametrize("K", [2, 4])
def test_torch_p3_matches_pallas_kstep(vr, K, no_library):
    """P3 on CPU tensors (K3's plain counts) against ``_lif_kernel_bipolar_k``
    in interpret mode, built as ``_lif_count_bipolar_k`` builds it."""
    T, B, C, N, N_pad, TC = 64, 4, 6, 20, 128, 32
    cfg = small_config(K)
    assert rk.lif_kernel._no_saturation_possible(cfg, 1, 0)
    r = np.random.default_rng(10 + K)
    kp = (r.random((T, B, C)) < 0.2).astype(np.int8)
    kn = (r.random((T, B, C)) < 0.2).astype(np.int8)
    pad = lambda a, c=0: jnp.pad(jnp.asarray(a), (0, N_pad - N), constant_values=c).reshape(1, N_pad)
    wp = jnp.pad(jnp.asarray(cfg.w_in[:C]).astype(jnp.int8), ((0, 0), (0, N_pad - N)))
    wn = jnp.pad(jnp.asarray(cfg.w_in[C:]).astype(jnp.int8), ((0, 0), (0, N_pad - N)))
    spike_spec = pl.BlockSpec((TC, B, C), lambda t: (t, 0, 0))
    w_spec = pl.BlockSpec((C, N_pad), lambda t: (0, 0))
    vec_spec = pl.BlockSpec((1, N_pad), lambda t: (0, 0))
    ref = pl.pallas_call(
        functools.partial(vr._lif_kernel_bipolar_k, TC=TC, B=B, K=K), grid=(T // TC,),
        in_specs=[spike_spec, spike_spec, w_spec, w_spec, vec_spec, vec_spec, vec_spec],
        out_specs=pl.BlockSpec((B, N_pad), lambda t: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, N_pad), jnp.int32),
        scratch_shapes=[pltpu.VMEM((B, N_pad), jnp.int32)] * 3 + [pltpu.VMEM((TC * B, N_pad), jnp.int32)],
        interpret=True,
    )(jnp.asarray(kp), jnp.asarray(kn), wp, wn, pad(cfg.dash_syn), pad(cfg.dash_mem),
      pad(cfg.threshold, 2**15 - 1))
    got = rk.lif_count_kstep(cfg, torch.as_tensor(kp != 0), torch.as_tensor(kn != 0), K)
    ref = np.asarray(ref)[:, :N]
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0


@pytest.mark.parametrize("w,W,rounds", [(11, 24, 1), (11, 24, 2), (23, 48, 2), (79, 24, 1), (1, 1, 1), (0, 0, 1)])
def test_torch_suppression_counters_match_jax(vr, w, W, rounds):
    assert rk.suppression_shiftmax_pairs(w, W, rounds) == vr.suppression_shiftmax_pairs(w, W, rounds)
    assert all(rk.chain_len(L) == vr._chain_len(L) for L in range(0, 3 * (w + W) + 3))


def van_herk_max(x: np.ndarray, L: int):
    """Sliding max over the L samples ending at each index, by van Herk /
    Gil-Werman (a prefix and a suffix scan per block of L, one compare to
    join them), and the compares it made."""
    n, cmp = len(x), 0
    pre, suf = x.copy(), x.copy()
    for i in range(n):
        if i % L:
            pre[i] = max(pre[i - 1], x[i])
            cmp += 1
    for i in range(n - 2, -1, -1):
        if (i + 1) % L:
            suf[i] = max(suf[i + 1], x[i])
            cmp += 1
    out = np.empty_like(x)
    for i in range(n):
        lo = i - L + 1
        if lo <= 0:
            out[i] = pre[i]
        elif i % L == L - 1:
            out[i] = pre[i]  # the window is one whole block
        else:
            out[i] = max(suf[lo], pre[i])
            cmp += 1
    return out, cmp


@pytest.mark.parametrize("L", [1, 2, 3, 5, 12, 23, 25])
def test_torch_window_compares_suffice(L):
    """A sliding max over L samples takes at most window_compares(L) compares
    per element: the doubling chain's steps below 3, van Herk's 3 above."""
    x = np.random.default_rng(L).standard_normal(500)
    want = np.array([x[max(0, i - L + 1):i + 1].max() for i in range(len(x))])
    got, cmp = van_herk_max(x, L)
    np.testing.assert_array_equal(got, want)
    assert cmp <= 3 * len(x)
    assert roofline.window_compares(L) == min(3, rk.chain_len(L)) <= 3


def test_torch_roofline_counters():
    # P2's executed chain steps: one per element per step
    assert rk.shiftmax_pairs((3, 64, 32), 5, 2) == 2 * rk.chain_len(6) * 2 * 3 * 64 * 32
    # P2's function needs 3 compares per element per sliding max or min
    assert roofline.p2_work((3, 64, 32), 11, 2) == (2 * 2 * 3 * 3 * 64 * 32, 8 * 3 * 64 * 32)
    ops, nbytes = roofline.lif_work(nnz=7, T=10, B=2, N=3, C_in=4)
    assert ops == 10 * 10 * 2 * 3 + 7 * 3 and nbytes == 10 * 2 * 4 + 4 * (4 * 3 + 3 * 3 + 2 * 3)
    assert roofline.lif_work(7, 10, 2, 3, 4, stateful=True)[1] == nbytes + 24 * 2 * 3
    # K1 at the flagship windows: extrema 2 * 3 + 1, a round 2 * 3 + 1 + 3 per polarity
    assert roofline.extrema_compares(24) == 7 and roofline.round_compares(11) == 10
    assert roofline.k1_work(100, 7, 11, 24) == (float(27 * 700), 5600.0)
    assert roofline.bound(2e12, 1e12, 0.0) == (2000.0, "operations")
    assert roofline.bound(0.0, 1e12, 3.35e12) == (1000.0, "bytes")


def test_torch_roofline_live_elements_match_brute_force():
    """The tiles a K2/K7 round does not skip: 256 × 32 tiles with a candidate
    within their halo, counted element by element in numpy."""
    r = np.random.default_rng(4)
    T, R, w = 1100, 70, 11
    act = np.zeros((T, R), bool)
    act[r.integers(0, T, 6), r.integers(0, R, 6)] = True
    M, tb = roofline.sk._margin(w), roofline.sk.TB
    want = 0
    for t0 in range(0, T, tb):
        for r0 in range(0, R, 32):
            if act[max(0, t0 - M):t0 + tb + M, r0:r0 + 32].any():
                want += min(tb, T - t0) * min(32, R - r0)
    assert roofline.live_elements(torch.as_tensor(act), w) == want > 0
    compares, nbytes = roofline.round_work((torch.as_tensor(act),), w, new_kept=3)
    assert compares == roofline.round_compares(w) * want and nbytes == 2 * T * R + 4 * want + 3


def test_torch_roofline_flagship_work_table():
    """The one table of what each kernel is counted for, on CPU tensors at a
    small size: every kernel of the kernels line, each with a bound."""
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import suppress_kernel as sk

    r = np.random.default_rng(7)
    T, B, C, N, w, W = 600, 2, 7, 20, 11, 24
    cs = torch.as_tensor(np.cumsum(r.standard_normal((T, B * C)).astype(np.float32), axis=0))
    kp, kn = (m.reshape(T, B, C) for m in sk.rzcc_encode_bipolar_tm_plain(cs, w + 1, W))
    u = (torch.as_tensor(r.random((T, B, C))) < 0.05).to(torch.int8)
    p1 = dict(ops=1e9, n=1000)
    p2 = dict(shape=(2, rk.P2_TBE, rk.P2_ROWS), w=w, rep=2)
    work = roofline.flagship_work(cs, w, W, kp, kn, u, N, p1, p2)
    assert set(work) == set(roofline.UNIT)
    assert all(ops > 0 and nbytes > 0 for ops, nbytes in work.values())
    assert work["rzcc_k1"] == roofline.k1_work(T, B * C, w, W)
    # K3/K4 counted as their function needs, the pack pass they launch first on its own
    assert work["lif_pack"] == roofline.pack_work(T, B, C) and work["lif_k3"][1] < work["lif_k4"][1]
    bounds = roofline.bounds(work, dict(int32=1e12, compares=2e12))
    ops, nbytes = work["suppress_k7"]
    assert bounds["suppress_k7"] == roofline.bound(ops, 2e12, nbytes)
    assert all(ms > 0 and by in ("operations", "bytes") for ms, by in bounds.values())
    pack_ops, pack_bytes = work["lif_pack"]
    assert roofline.bound(pack_ops, 31e12, pack_bytes)[1] == "bytes"  # at the card's integer rate


def test_torch_roofline_three_band_work_is_priced_as_the_flagship():
    """The three-band model's K3/K4 (C = 42 a polarity, N = 1347) and its
    K1/K2 (R = B·C rows) are counted by the functions that count the
    flagship's: ``lif_work`` on 2C = 84 input channels, ``pack_work`` with a
    16-byte mask word, ``k1_work`` on the rows."""
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import suppress_kernel as sk

    r = np.random.default_rng(8)
    T, B, C, N, w, W = 300, 2, 42, 1347, 11, 24
    kp, kn = (torch.as_tensor(r.random((T, B, C)) < 0.04) for _ in range(2))
    work = roofline.lif_bipolar_work(kp, kn, N)
    nnz = int((kp & ~kn).sum() + kn.sum())
    assert work["lif_k3"] == roofline.lif_work(nnz, T, B, N, 2 * C)
    assert work["lif_k4"] == roofline.lif_work(nnz, T, B, N, 2 * C, stateful=True)
    assert work["lif_pack"] == roofline.pack_work(T, B, C) == (4.0 * T * B * C, 2.0 * T * B * C + 16.0 * T * B)
    assert work["lif_k3"][0] == rk.P1_OPS_PER_STEP * T * B * N + nnz * N
    cs = torch.as_tensor(np.cumsum(r.standard_normal((T, B * C)).astype(np.float32), axis=0))
    rz = roofline.rzcc_work(cs, w, W)
    assert rz["rzcc_k1"] == roofline.k1_work(T, B * C, w, W) and rz["rzcc_k2"][0] > 0


@pytest.mark.parametrize("C, word", [(1, 4), (14, 4), (16, 4), (17, 8), (32, 8), (33, 16), (42, 16), (64, 16)])
def test_torch_roofline_pack_work_counts_the_function(C, word):
    """The pack pass's bytes are its function's: the two one-byte masks in
    and one mask word per step and row out (32 bits while 2C <= 32, 64 while
    2C <= 64, else 128), none of the slots or counts its design adds."""
    T, B = 12_000, 96
    ops, nbytes = roofline.pack_work(T, B, C)
    assert nbytes == 2 * T * B * C + word * T * B
    assert ops == 4 * T * B * C
    small = torch.zeros((40, 2, C), dtype=torch.bool)
    words = lk.pack_bipolar_masks_plain(small, small).words
    assert words[0, 0].numel() * words.element_size() == word


@pytest.mark.parametrize("call", [
    lambda: roofline.run(reps=1, batch=2),
    lambda: roofline.main(["--reps", "1"]),
    lambda: roofline.p1_sweep(reps=1),
    lambda: roofline.p2_ceiling(11, reps=1),
])
def test_torch_roofline_harness_needs_cuda(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


EXPERIMENTS = "haghighatshoarmuir2024_tpu_torch.experiments"
HARNESSES = ["target_localization", "target_localization_music", "srp_phat_baseline", "target_snn_localization",
             "array_resolution", "array_resolution_snn", "array_resolution_music", "multiple_targets",
             "moving_target", "multi_target_tracking", "mismatch_robustness"]


@pytest.mark.parametrize("entry", ["Demo", "Demo.load", "SNNBeamformer", "SNNBeamformer.from_config",
                                   "StreamState.from_numpy", "Beamformer", "Beamformer.from_config", "MUSIC",
                                   "MUSIC.from_config", "SRPPHAT", "localize", "track_angles",
                                   "track_multi_angles", "XyloSim", "XyloSim.from_config",
                                   "XyloSimPushToHidden", "DemoPushToHidden", "sim_hidden_batch",
                                   "make_trial_fn", "target_xylo_localization", "xylo_ordering_sensitivity",
                                   "target_push_to_hidden", "SNNBeamformer.apply_to_template",
                                   "SNNBeamformer.apply_to_signal (batch)"] + HARNESSES)
def test_torch_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """Without ``device`` every entry point asks for the card, and without a
    card it raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    n = 3
    cfg = XyloConfig(w_in=np.ones((n, n), np.int32), w_rec=np.zeros((n, n), np.int32),
                     w_out=np.ones((n, 1), np.int32), dash_syn=np.ones(n), dash_mem=np.ones(n), dash_syn_out=np.ones(1),
                     dash_mem_out=np.ones(1), threshold=np.ones(n), threshold_out=np.ones(1), dt=1e-3,
                     weight_scale=1.0)
    calls = {
        "Demo": lambda: Demo(geo, [[1600, 1900]], np.linspace(-np.pi, np.pi, 449), fs=48_000),
        "Demo.load": lambda: Demo.load(str(tmp_path / "demo.npz")),
        "SNNBeamformer": lambda: SNNBeamformer(geo, 10e-3, [1600, 1900], [1e-4, 1e-4], fs=48_000),
        "SNNBeamformer.from_config": lambda: SNNBeamformer.from_config(types.SimpleNamespace(
            kernel_duration=10e-3, freq_range=[1600, 1900], tau_syn=1e-4, tau_mem=1e-4, bipolar_spikes=True,
            fs=48_000, design_chunk=32), geo),
        "StreamState.from_numpy": lambda: StreamState.from_numpy(
            {name: np.zeros((2, 3)) for name in StreamState.__dataclass_fields__}),
        "Beamformer": lambda: Beamformer(geo, 10e-3, [1600, 1900], fs=48_000),
        "Beamformer.from_config": lambda: Beamformer.from_config(BeamformerConfig(), geo),
        "MUSIC": lambda: MUSIC(geo, [1600, 1900], np.linspace(-np.pi, np.pi, 9), fs=48_000),
        "MUSIC.from_config": lambda: MUSIC.from_config(MUSICConfig(), geo, np.linspace(-np.pi, np.pi, 9)),
        "SRPPHAT": lambda: SRPPHAT(geo, [1600, 1900], np.linspace(-np.pi, np.pi, 9), fs=48_000),
        "localize": lambda: localize.main([str(tmp_path / "tone.wav"), "--model", "srp"]),
        "track_angles": lambda: tracking.track_angles(np.zeros(3)),
        "track_multi_angles": lambda: tracking.track_multi_angles(np.zeros((3, 2)), np.ones((3, 2), bool), 4),
        "XyloSim": lambda: XyloSim(cfg),
        "XyloSim.from_config": lambda: XyloSim.from_config(cfg),
        "XyloSimPushToHidden": lambda: XyloSimPushToHidden(cfg, 1, np.ones(n), np.ones(n), np.ones(n)),
        "DemoPushToHidden": lambda: DemoPushToHidden(geo, [[1600, 1900]], np.linspace(-np.pi, np.pi, 9), fs=48_000),
        "sim_hidden_batch": lambda: sim_hidden_batch(cfg, np.zeros((1, 4, n), np.int32)),
        "make_trial_fn": lambda: montecarlo.make_trial_fn(geo, np.zeros(4), np.zeros(4), lambda f: f, 48_000),
        "target_xylo_localization": lambda: target_xylo_localization.main(["--quick"]),
        "xylo_ordering_sensitivity": lambda: xylo_ordering_sensitivity.main(["--quick"]),
        "target_push_to_hidden": lambda: target_push_to_hidden.main(["--quick"]),
        "SNNBeamformer.apply_to_template": lambda: snn.apply_to_template(np.zeros((14, 9)), (t, np.sin(t), 0.3), None),
        "SNNBeamformer.apply_to_signal (batch)": lambda: snn.apply_to_signal(np.zeros((14, 9)), (t, np.zeros((2, 4, 7)))),
        **{name: functools.partial(importlib.import_module(f"{EXPERIMENTS}.{name}").main, ["--quick"])
           for name in HARNESSES},
    }
    if entry.startswith("SNNBeamformer.apply"):  # made on the card while there is one, then called without it
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            snn = SNNBeamformer(geo, 10e-3, [1600, 1900], [1e-4, 1e-4], fs=48_000)
        t = np.arange(4) / 48_000
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
