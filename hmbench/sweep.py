"""The knee of ``flagship.stream-open``: one process serves the cell's open
loop at several group counts G in turn (96 streams a group) and prints, for
each, the chunks' lateness and whether the backlog grows.

    python3 -m hmbench.sweep --workload flagship.stream-open --seed 7 --seconds 8 --groups 32 40 48 56 64 72

The knee is the highest G whose backlog does not grow (the chunks waiting
when a step starts, in the window's last quarter against its first) and
whose 95th percentile stays within one chunk period; the cell runs at four
fifths of it, rounded down.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="flagship.stream-open")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--groups", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from .drivers.stream_open import Streams
    from .run import make_context

    if not torch.cuda.is_available():
        print("the sweep measures the card: no CUDA device is visible", file=sys.stderr)
        return 2
    ctx = make_context(args.workload, args.seed, args.seconds, False)
    dev = torch.device("cuda", 0)
    srv = Streams(ctx, dev, max(args.groups))
    period = srv.period
    rows = []
    for g in args.groups:
        srv.regroup(g)
        r = srv.serve(args.seconds, {}, False)
        q = r["queue"]
        quarter = max(len(q) // 4, 1)
        row = dict(groups=g, streams=g * srv.lanes, chunks=int(r["chunks"]),
                   p50_ms=float(np.percentile(r["late"], 50) * 1e3), p95_ms=float(np.percentile(r["late"], 95) * 1e3),
                   max_ms=float(r["late"].max() * 1e3), step_ms_p50=float(np.median(r["step_s"]) * 1e3),
                   queue_first=float(q[:quarter].mean()), queue_last=float(q[-quarter:].mean()))
        row["grows"] = row["queue_last"] > row["queue_first"] + 1.0
        row["sustained"] = (not row["grows"]) and row["p95_ms"] <= period * 1e3
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = [r["groups"] for r in rows if r["sustained"]]
    knee = max(ok) if ok else None
    print(json.dumps({"knee_groups": knee, "cell_groups": None if knee is None else int(knee * 4 // 5),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
