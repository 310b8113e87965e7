"""The port's profiling helpers (``utils/profiling.py``), ``ops.chunked_vmap``
and the live ``Visualizer`` (``io/visualizer.py``) against the JAX
package's on the CPU.

Tolerances: ``StageTimer``'s report keys and call counts equal JAX's on the
same stage sequence (the seconds are wall time, not compared);
``benchmark_fn``'s keys equal; ``chunked_vmap`` equal to JAX's
``chunked_vmap`` exactly, on integer-valued float64 and int64 inputs whose
sums are exact in both; the ring buffer as ``test_io_demos.py`` has it.
"""
import json
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from haghighatshoarmuir2024_tpu.ops.batching import chunked_vmap as jax_chunked_vmap  # noqa: E402
from haghighatshoarmuir2024_tpu.utils import StageTimer as JaxStageTimer  # noqa: E402
from haghighatshoarmuir2024_tpu.utils import benchmark_fn as jax_benchmark_fn  # noqa: E402

from haghighatshoarmuir2024_tpu_torch.io import Visualizer  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.io.visualizer import _plot_loop  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.ops import chunked_vmap  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.utils import StageTimer, benchmark_fn, device_trace  # noqa: E402

STAGES = ["source", "compute", "visualize", "compute", "compute", "source"]


def test_torch_stage_timer_report_matches_jax():
    """The same stage sequence (``stage`` and ``timed``) gives JAX's report
    keys and counts; ``timed`` returns the function's output; ``samples``
    holds each call's seconds and sums to the total."""
    jt, pt = JaxStageTimer(), StageTimer()
    for name in STAGES:
        with jt.stage(name):
            pass
        with pt.stage(name):
            pass
    j_out = jt.timed("step", lambda x: x + 1)(jnp.ones(3))
    p_out = pt.timed("step", lambda x: {"y": x + 1})(torch.ones(3))
    assert np.array_equal(np.asarray(j_out), p_out["y"].numpy())
    jr, pr = jt.report(), pt.report()
    assert list(pr) == list(jr) == ["compute", "source", "step", "visualize"]
    for k in jr:
        assert set(pr[k]) == set(jr[k]) == {"total_s", "calls", "mean_ms"}
        assert pr[k]["calls"] == jr[k]["calls"]
        assert len(pt.samples[k]) == pr[k]["calls"]
        assert abs(sum(pt.samples[k]) - pr[k]["total_s"]) < 1e-12
        assert abs(pr[k]["mean_ms"] - 1e3 * pr[k]["total_s"] / pr[k]["calls"]) < 1e-12


def test_torch_stage_timer_records_a_raising_stage():
    pt = StageTimer()
    with pytest.raises(ZeroDivisionError):
        with pt.stage("bad"):
            1 / 0
    assert pt.report()["bad"]["calls"] == 1


def test_torch_benchmark_fn_keys_match_jax():
    calls = []
    res = benchmark_fn(lambda x: calls.append(1) or x * 2, torch.ones(8), warmup=2, iters=3)
    jres = jax_benchmark_fn(jax.jit(lambda x: x * 2), jnp.ones(8), warmup=2, iters=3)
    assert set(res) == set(jres) == {"mean_s", "mean_ms", "iters"}
    assert res["iters"] == 3 and len(calls) == 5
    assert res["mean_s"] >= 0 and abs(res["mean_ms"] - 1e3 * res["mean_s"]) < 1e-12


def test_torch_device_trace_none_is_a_no_op(tmp_path):
    with device_trace(None) as prof:
        torch.ones(4).sum()
    assert prof is None and list(tmp_path.iterdir()) == []


def test_torch_device_trace_writes_a_trace(tmp_path):
    """``device_trace(dir)`` writes one Chrome/Perfetto trace JSON holding
    the block's operators (on this CPU host, CPU activity only)."""
    x = torch.ones(64, 64)
    with device_trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert prof is not None
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def pytree(G: int, seed: int = 0):
    """A pytree with leading axis G: integer-valued float64 and int64."""
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(-50, 50, (G, 5, 3)).astype(np.float64),
            "b": (rng.integers(-9, 9, (G, 4)).astype(np.int64),)}


def jax_fn(x):
    s = x["a"].sum(axis=-1)
    return s * x["b"][0].sum(), {"max": x["a"].max(), "rows": [s, x["b"][0] * 2]}


def torch_fn(x):
    s = x["a"].sum(dim=-1)
    return s * x["b"][0].sum(), {"max": x["a"].max(), "rows": [s, x["b"][0] * 2]}


@pytest.mark.parametrize("G, chunk", [(449, 64), (7, 3), (5, 5), (3, 100)])
def test_torch_chunked_vmap_matches_jax(G, chunk):
    """G not a multiple of the chunk (449 = 7·64 + 1), a chunk that divides
    G, a chunk larger than G; pytree in (a dict holding a tuple) and out (a
    tuple of a tensor and a dict holding a list): JAX's values exactly, and
    ``torch.func.vmap`` of the whole input."""
    xs = pytree(G)
    want = jax_chunked_vmap(jax_fn, jax.tree_util.tree_map(jnp.asarray, xs), chunk)
    xt = {"a": torch.as_tensor(xs["a"]), "b": (torch.as_tensor(xs["b"][0]),)}
    got = chunked_vmap(torch_fn, xt, chunk)
    whole = torch.func.vmap(torch_fn)(xt)
    flat = lambda t: [t[0], t[1]["max"], *t[1]["rows"]]  # noqa: E731
    for g, w, v in zip(flat(got), flat(want), flat(whole)):
        assert g.shape[0] == G
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, v)


def test_torch_visualizer_headless_ring_buffer():
    """As ``test_io_demos.test_visualizer_headless_ring_buffer``: pushes fill
    the ring from the end, the unfilled slots stay NaN, ``history`` keeps
    every sample, and a headless visualizer starts no process."""
    vz = Visualizer(buffer_size=4, dim_samples=1, headless=True)
    vz.start()
    for v in (1.0, 2.0, 3.0):
        vz.push(v)
    assert vz._proc is None and vz._queue is None
    assert len(vz.history) == 3 and [h[1][0] for h in vz.history] == [1.0, 2.0, 3.0]
    assert vz._vals[-1][0] == 3.0 and vz._vals[-3][0] == 1.0
    assert np.isnan(vz._vals[0][0])  # not yet filled
    for v in (4.0, 5.0):
        vz.push(v)
    assert vz._vals[:, 0].tolist() == [2.0, 3.0, 4.0, 5.0]  # the oldest dropped
    assert np.all(np.diff(vz._time) >= 0)
    vz.stop()


def test_torch_visualizer_plot_loop_draws_and_stops(tmp_path):
    """The plotting loop (in this process, Agg): it draws the latest
    buffer the queue holds and returns when the queue delivers None."""
    pytest.importorskip("matplotlib")
    q = mp.get_context("spawn").Queue()
    vz = Visualizer(buffer_size=4, headless=True)
    vz._queue = q
    for v in (1.0, 2.0):
        vz.push(v)
    q.put(None)
    _plot_loop(q, 0.1, {"title": "DoA", "ylabel": "deg"})  # returns: the None ends it
    assert q.empty()


def test_torch_visualizer_process_stops_in_bounded_time():
    """A started visualizer spawns its plotting process, and ``stop`` ends
    it (told to, else terminated) within its bounded joins."""
    pytest.importorskip("matplotlib")
    vz = Visualizer(buffer_size=4, waiting_time=0.1)
    vz.start(backend="Agg")
    proc = vz._proc
    assert proc is not None and proc.is_alive()
    vz.push(1.0)
    vz.stop()
    proc.join(timeout=5.0)
    assert not proc.is_alive() and vz._proc is None and vz._queue is None
