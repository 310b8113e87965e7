"""The control of ``correct``: the plain reference put in the program's place
and computed in the next precision below the configuration's (float32 with
the FIR's operands in TF32, ``check.control_offline``/``control_stream``),
on a cell's own traffic at its own size, judged by the cell's limits against
the float64 reference as a run is judged (``run.judge``).  Each limit lies
between what sound runs of the program read (their result lines' ``checks``)
and what this reads; the control has to come out not correct.

    python3 -m hmbench.control --workload flagship.offline-b96 --seeds 11 12 13

Prints one JSON line a seed: ``correct`` and each number beside its limit.
The control is the reference and repeats no call, so a limit on a number it
does not produce (``repeat_diff``) is not held against it.  The cell's
driver (``drivers/<driver>.py``) makes the inputs, as its runs make them,
and computes the control (its ``control(ctx, device)``).  With ``--fault
<name>`` it runs the program instead, with a fault of ``hmbench/faults.py``
planted, and judges that run.
"""
from __future__ import annotations

import argparse
import json
import sys

from .faults import FAULTS


def inputs(ctx, dev):
    """The cell's checked inputs, made by its driver as its runs make them."""
    from .run import driver

    return driver(ctx).checked_inputs(ctx, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), help="instead: the program's run with this fault planted")
    ap.add_argument("--seconds", type=float, default=1.0, help="the faulty run's window")
    args = ap.parse_args(argv)

    import torch

    from .run import driver, execute, judge, limits, make_context

    if not torch.cuda.is_available():
        print("the control runs on the card: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lim = limits(args.workload)
    for seed in args.seeds:
        ctx = make_context(args.workload, seed, args.seconds, False)
        if args.fault:
            ctx.devices = [torch.device("cuda", i) for i in range(int(ctx.cell["chips"]))]
            with FAULTS[args.fault]():
                got = execute(ctx).checks
        else:
            got = driver(ctx).control(ctx, dev)
        correct, checks = judge(got, {k: v for k, v in lim.items() if args.fault or k in got})
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault, "correct": correct,
                          "checks": checks, "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
