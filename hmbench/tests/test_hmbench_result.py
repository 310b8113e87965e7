"""A run's result line has the contract's keys and no others, ``checks``
last, and ``correct`` follows the limits."""
import json

import torch

from hmbench import run as R


class _View:
    calls = 1

    def mean_busy_s(self):
        return 0.5

    window_s = 1.0


def _line(monkeypatch, ctx, checks, trace=False):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "a card")
    ctx.trace = trace
    out = R.Outcome(e2e={"audio_s_per_s": 1.0, "setup_s": 2.0}, attempted=4, failed=0, memory_peak_bytes=10,
                    checks=checks, view=None)
    if trace:
        monkeypatch.setattr(R, "load_reader", lambda name: lambda view: 1.0)
        monkeypatch.setattr("hmbench.trace.breakdown", lambda view: {"device_ops": [], "idle_gaps": []})
        out.view = _View()
    return R.result_line(ctx, out, R.manifest())


def test_keys(monkeypatch, cpu_context):
    ctx = cpu_context("flagship.offline-b96")
    line = _line(monkeypatch, ctx, {"rate_gap": 0.0, "score_gap": 0.0, "repeat_diff": 0})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"] is True
    json.dumps(line)


def test_traced_keys(monkeypatch, cpu_context):
    ctx = cpu_context("flagship.offline-b96")
    line = _line(monkeypatch, ctx, {"rate_gap": 0.0, "score_gap": 0.0, "repeat_diff": 0}, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert all(m.endswith(".batch") or m.endswith("_roofline") for m in line["metrics"])


def test_limits_decide(monkeypatch, cpu_context):
    ctx = cpu_context("flagship.offline-b96")
    assert not _line(monkeypatch, ctx, {"rate_gap": 1.0, "score_gap": 0.0, "repeat_diff": 0})["correct"]
    assert not _line(monkeypatch, ctx, {"rate_gap": 0.0, "score_gap": 0.0})["correct"]  # a number missing
    assert not _line(monkeypatch, ctx, {"rate_gap": float("nan"), "score_gap": 0.0, "repeat_diff": 0})["correct"]
