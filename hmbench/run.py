"""Run one cell of the port's benchmark once and print its result line.

    python3 -m hmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are looked up by
name in ``BENCHMARK.json``; the configuration's file is
``hmbench/configs/<config>.json``, the traffic mix's ``hmbench/traffic/<traffic>.json``
(whose ``driver`` names the module of ``hmbench/drivers/`` that offers it),
the correctness limits ``hmbench/limits/<workload>.json`` and each per-layer
metric's reader ``hmbench/metrics/<metric>.py``.  Nothing here names one of
them.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number compared
beside its limit, which also close standard error.  A run exits non-zero
without a result where no CUDA device is visible, where the cell asks for
more cards than there are, or where JAX, or the JAX package, is loaded once
the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python can take it

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "haghighatshoarmuir2024_tpu")


@dataclasses.dataclass
class Context:
    """One run: the cell, its inputs and its clock."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    cfg: object  # system.Config
    traffic: dict
    devices: list
    t0: float = T0


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics (``setup_s`` among
    them), the requests attempted and failed, the peak device memory, the
    numbers compared for ``correct``, and in a traced run the view."""

    e2e: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict
    view: object = None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(man: dict, workload: str, kind: str) -> list:
    """The manifest's ``kind`` metrics that this cell reports."""
    return [m for m in man[kind] if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"hmbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_context(workload: str, seed: int, seconds: float, trace: bool, devices=None) -> Context:
    from .system import Config

    man = manifest()
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return Context(workload=workload, seed=int(seed), seconds=float(seconds), trace=bool(trace), cell=cell,
                   cfg=Config(cell["config"]), traffic=traffic, devices=devices or [])


def limits(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]


def judge(checks: dict, lim: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every number compared at or
    under its limit, and every limited number present."""
    out = {k: {"value": checks.get(k), "limit": v} for k, v in lim.items()}
    ok = all(c["value"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"] for c in out.values())
    return ok, out


def driver(ctx: Context):
    """The module of ``drivers/`` that the cell's traffic mix names."""
    return importlib.import_module(f"hmbench.drivers.{ctx.traffic['driver']}")


def execute(ctx: Context) -> Outcome:
    t = time.perf_counter()
    mod = driver(ctx)
    print(f"[setup] the harness's imports {time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    return mod.run(ctx)


def result_line(ctx: Context, out: Outcome, man: dict) -> dict:
    import torch

    correct, checks = judge(out.checks, limits(ctx.workload))
    if ctx.trace:
        metrics = {}
        for m in cell_metrics(man, ctx.workload, "per_layer"):
            v = load_reader(m["name"])(out.view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell_metrics(man, ctx.workload, "end_to_end")}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(ctx.devices),
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if ctx.trace:
        from .trace import breakdown

        device["busy_s"] = out.view.mean_busy_s()
        device["window_s"] = out.view.window_s
        line["breakdown"] = breakdown(out.view)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["OMP_NUM_THREADS"] = "1"  # one process, few threads: the host's jitter stays out of the window

    import torch

    torch.set_num_threads(1)

    ctx = make_context(args.workload, args.seed, args.seconds, bool(args.trace))
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device is visible: the benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards; {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    ctx.devices = [torch.device("cuda", i) for i in range(chips)]
    for d in ctx.devices:
        torch.zeros(1, device=d)  # each card's context
    print(f"[setup] python, torch and the cards {time.perf_counter() - T0:.3f} s", file=sys.stderr, flush=True)
    out = execute(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(ctx, out, manifest())
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
