"""The envelope follower and the two DoA trackers on the card,
``envelope`` (``csrc/envelope.cu``), ``track_angles`` and ``track_multi``
(``csrc/tracking.cu``), against their plain loops with ``torch.equal``:

  * the follower at ``Envelope(1e-3, 1e-2, 48 000)`` on one flagship frame
    (12 000, 7) and on 96 frames' microphones as lanes (12 000, 672) in
    float32, and one frame in float64; ``track_angles`` at (240, 96) and
    ``track_multi_angles`` at (240, 96, 2) with 4 tracks
    (``experiments/scan_kernels.py``'s cases);
  * the edges of ``chip_smoke.py`` phase 29 (``ENV_EDGES``, ``TRACK_EDGES``,
    ``MULTI_EDGES``): T = 1 and 2, one lane, lanes no multiple of 32, lanes
    that only fall or rise, NaN and inf, carried states and two halves
    against one pass, the gate's boundary, re-acquisition, all-invalid
    frames, K > M, M > K, the caps, tied costs; for the follower's tiles
    (a consumer and a producer warp over a ring of 4 tiles of 128 steps)
    T = TS - 1, TS, TS + 1 and STAGES·TS + 1 over 31, 32 and 33 lanes,
    16-byte rows, an item a lane and x off its alignment (each held to the
    cut the library reports, ``envelope_kernel.kernel_plan``, and that cut
    to its mirror ``envelope_kernel.plan`` over ``ENV_PLAN_GRID``), NaN,
    inf and zeros across a tile's end and the ring's turn, a state carried
    from the middle of a tile, in float32 and float64;
  * the routes: each entry point launches its kernel once and a numpy
    signal given to ``Envelope.evolve`` without a device lands on the card;
    a dtype or a cap the kernels do not take raises on the card;
  * the moving-target and multi-target harnesses give the same results with
    the kernels and with the plain loops forced;
  * the wrappers' mirrors of the kernels' constants equal the library's;
  * the kernels' wrap (``atan2f`` of ``sincosf``'s pair) and
    ``atan2f(sinf(x), cosf(x))`` against PyTorch's ``atan2(sin x, cos x)``
    at all 2^32 float32 bit patterns, and the latency probe's chain
    against the same chain of PyTorch's ops.

The cases are ``experiments/scan_kernels.py``'s and ``chip_smoke.py`` phase
29's, so every run of that script makes them too.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.cuda
B = 96


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("tests_gpu needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames():
    """bench.py's 96 flagship frames (96, 12 000, 7) on the card."""
    dev = _card()
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
    from haghighatshoarmuir2024_tpu_torch.models.xylo.flagship import flagship_config, flagship_frames

    return flagship_frames(Demo(**flagship_config(dev)), B, seed=cs.SEED)[0]


@pytest.fixture(scope="module")
def track_inputs():
    dev = _card()
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    return tuple(t.to(dev) for t in scan_kernels.track_inputs())


@pytest.mark.parametrize("case", ["one frame", "96 frames", "float64"])
def test_envelope_against_plain(frames, case):
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    inputs = scan_kernels.envelope_inputs(frames)
    name = next(k for k in inputs if (case in k) and (case == "float64" or "float32" in k))
    r = scan_kernels.envelope_against_plain(inputs[name])
    assert r["equal"] and r["launches"] == 1, r


def test_track_angles_against_plain(track_inputs):
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    r = scan_kernels.track_against_plain(track_inputs[0])
    assert r["equal"] and r["launches"] == 1, r


def test_track_multi_against_plain(track_inputs):
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    r = scan_kernels.multi_against_plain(track_inputs[1], track_inputs[2], scan_kernels.MULTI_M)
    assert r["equal"] and r["launches"] == 1 and r["confirmed"] > 0, r


@pytest.mark.parametrize("i", range(len(cs.ENV_EDGES)))
def test_envelope_edges(i):
    r = cs.envelope_edge(torch, _card(), cs.ENV_EDGES[i], cs.SEED + i)
    assert r["equal"] and r["launches"] == 1 and r.get("halves_equal", True) and r["plan_as_expected"], r


def test_envelope_plan_mirror():
    _card()
    assert cs.envelope_plan_mismatches(torch) == []


@pytest.mark.parametrize("i", range(len(cs.TRACK_EDGES)))
def test_track_angles_edges(i):
    r = cs.track_edge(torch, _card(), cs.TRACK_EDGES[i], cs.SEED + i)
    assert r["equal"] and r["launches"] == 1, r


@pytest.mark.parametrize("i", range(len(cs.MULTI_EDGES)))
def test_track_multi_edges(i):
    r = cs.multi_edge(torch, _card(), cs.MULTI_EDGES[i], cs.SEED + i)
    assert r["equal"] and r["launches"] == 1, r


def test_gate_compares_in_float32():
    """PyTorch's CUDA comparison of a float32 tensor with a Python float
    takes the float rounded to float32: float32(25 deg), above the double,
    is within the double gate there (and not in float64), which is why the
    kernel compares with float32(gate)."""
    dev = _card()
    gate = float(np.deg2rad(25.0))
    g32 = torch.tensor([np.float32(gate)], device=dev)
    assert float(g32.item()) > gate
    assert bool((g32.abs() <= gate).item())
    assert not bool((g32.double() <= torch.tensor(gate, dtype=torch.float64, device=dev)).item())


def test_routes_launch_their_kernels(frames, track_inputs):
    """Each entry point launches its kernel once; a numpy frame without a
    device lands on the card; float16, M = 17 and K = 17 raise there."""
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
    from haghighatshoarmuir2024_tpu_torch.ops.envelope import Envelope
    from haghighatshoarmuir2024_tpu_torch.utils import tracking

    env = Envelope(1e-3, 1e-2, 48_000)
    z, zk, valid = track_inputs
    for kernel, fn in (("envelope", lambda: env.evolve(frames[0])),
                       ("envelope", lambda: env.evolve(frames[0].cpu().numpy())),
                       ("track_angles", lambda: tracking.track_angles(z)),
                       ("track_multi", lambda: tracking.track_multi_angles(zk, valid, 4))):
        _build.launch_counts.clear()
        out = fn()
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {kernel: 1}
        assert (out[0] if isinstance(out, tuple) else out).device.type == "cuda"
    with pytest.raises(TypeError):
        env.evolve(frames[0].half())
    with pytest.raises(ValueError, match="track slots"):
        tracking.track_multi_angles(zk, valid, 17)
    with pytest.raises(ValueError, match="measurements"):
        tracking.track_multi_angles(zk[..., :1].expand(-1, -1, 17), valid[..., :1].expand(-1, -1, 17), 4)


def test_harnesses_equal_with_the_plain_loops(monkeypatch):
    """``moving_target`` and ``multi_target_tracking`` at their default
    sizes: every result equal with the kernels and with the plain loops
    forced (``track_angles_plain``, ``track_multi_angles_plain``)."""
    dev = _card()
    from haghighatshoarmuir2024_tpu_torch.experiments import moving_target as mt
    from haghighatshoarmuir2024_tpu_torch.experiments import multi_target_tracking as mtt
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build
    from haghighatshoarmuir2024_tpu_torch.utils import tracking

    demo = mt.build_demo(32 * 7, 0.25, dev)
    _build.launch_counts.clear()
    mt_card = mt.run(4.0, 10.0, 0.25, 32 * 7, dev, demo=demo)
    mtt_card = mtt.run(6.0, 10.0, 0.25, 32 * 7, dev)
    assert _build.launch_counts["track_angles"] == 2 and _build.launch_counts["track_multi"] == 1
    monkeypatch.setattr(mt, "track_angles", tracking.track_angles_plain)
    monkeypatch.setattr(mtt, "track_multi_angles", tracking.track_multi_angles_plain)
    _build.launch_counts.clear()
    mt_plain = mt.run(4.0, 10.0, 0.25, 32 * 7, dev, demo=demo)
    mtt_plain = mtt.run(6.0, 10.0, 0.25, 32 * 7, dev)
    assert "track_angles" not in _build.launch_counts and "track_multi" not in _build.launch_counts
    assert mt_card == mt_plain
    assert mtt_card == mtt_plain


def test_wrappers_constants_equal_the_library():
    _card()
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build, envelope_kernel, track_kernel

    assert envelope_kernel.checked_library() is _build.library()
    assert track_kernel.checked_library() is _build.library()


@pytest.mark.parametrize("form", ["wrap", "atan2f(sinf, cosf)"])
def test_wrap_bits_every_float32(form):
    """The kernels' wrap (``atan2f`` of ``sincosf``'s pair) and the plain
    loops' three functions on the card equal PyTorch's ``atan2(sin x, cos
    x)`` at all 2^32 float32 bit patterns, NaN equal to NaN and the sign of
    every zero the same."""
    _card()
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    r = scan_kernels.wrap_bits(form)
    assert r["checked"] == 1 << 32 and r["differ"] == 0 and r["bits_differ"] == 0, r


@pytest.mark.parametrize("x0,c", [(0.3, 0.7), (0.3, 2.0e5)])
def test_wrap_chain_probe(x0, c):
    """The latency probe's chain ``x = wrap(x + c)`` ends where PyTorch's
    ops on the card end, bit for bit, and counts cycles."""
    dev = _card()
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import track_kernel

    n = 64
    got, cycles = track_kernel.wrap_chain(x0, c, n)
    x = torch.tensor([x0], dtype=torch.float32, device=dev)
    for _ in range(n):
        x = x + c
        x = torch.atan2(torch.sin(x), torch.cos(x))
    assert got == float(x.item()) and cycles > n
