"""``BENCHMARK.json`` and the files it names keep to the benchmark's
contract: names, units and lengths of the allowed characters, the keys of
each entry, a reader for every per-layer metric and a limits file, a
configuration file and a traffic file for every cell."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) for p in MAN["paths"])
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert set(e) - {"workloads"} == KEYS[kind], e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_cells_and_their_files():
    configs = {c["name"]: c for c in MAN["configs"]}
    for c in MAN["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["reduced"] == c["reduced"] == []
        assert (ROOT / "hmbench" / "configs" / spec["design_inputs"]).exists()
    for w in MAN["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and (ROOT / "hmbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "hmbench" / "limits" / f"{w['name']}.json").exists()
        e2e = [m for m in MAN["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        per = [m for m in MAN["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert per and {m["moves"] for m in per} <= {m["name"] for m in e2e}
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


def test_metrics_and_bounds():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "hmbench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_check_budget():
    """A full check of 24 cells fits the contract's 43 200 seconds."""
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
