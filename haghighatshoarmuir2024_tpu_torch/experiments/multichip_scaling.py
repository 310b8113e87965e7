"""Data-parallel scaling of the Monte Carlo over a device mesh, the port's
twin of ``experiments/multichip_scaling.py`` at its sizes (a 32-point grid,
0.05 s trials, a 2 ms STHT kernel, 64 trials at 10 dB; ``--quick`` 32).

The sweep splits its trials over the mesh's data axis
(``parallel.monte_carlo_sweep(mesh=)``).  JAX reads its evidence from the
compiled SPMD module; here the same facts are read from the program as it
runs, under JAX's keys where they exist:

* ``per_device_key_block``: the trials each shard's trial function is
  handed, ``num_sims / n``;
* ``bytes_leaving_shard``: the bytes of the tensors the sweep gathers
  from a shard to the host (``parallel.montecarlo.gathered_bytes``): its
  per-trial errors and nothing else;
* ``trials_per_sec_wall``: host clock around the sweep, synchronized, the
  least of three after a warm-up, at 1 and at n shards;
* ``errors_equal``: the n-shard sweep's per-trial errors equal the
  one-shard sweep's, element for element.

The 8 shards go round-robin over the visible cards (every shard on one card
when there is one: the split then costs, it cannot gain), or all on the CPU
with ``--device cpu``.  Each card runs its own copy of the model
(``parallel.replicate_demo``), never a second design.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.multichip_scaling \\
        [--quick] [--device cpu]
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..geometry import CenterCircularArray, resolve_device
from ..models.xylo import Demo
from ..parallel import make_mesh, make_trial_fn, monte_carlo_sweep, montecarlo, replicate_demo
from ..parallel.mesh import canonical_device
from .common import FS, arg_parser, sinusoid_template, sync

SHARDS = 8  # the mesh's data axis, as JAX's harness


def build_demo(device, duration: float = 0.05, num_grid: int = 32) -> Demo:
    return Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[[1600, 1900]],
                doa_list=np.linspace(-np.pi, np.pi, num_grid), recording_duration=duration, kernel_duration=2e-3,
                bipolar_spikes=True, fs=FS, use_cache=False, device=device)


def analyze(demo: Demo, devices: list, num_sims: int = 64, duration: float = 0.05, reps: int = 3) -> dict:
    """The sweep of ``num_sims`` trials at 10 dB over a mesh of ``devices``
    (one shard each): what each shard is handed and returns, trials/sec."""
    mesh = make_mesh(devices=devices)
    replicas = {d: replicate_demo(demo, d) for d in set(mesh.axis_devices("data"))}
    calls = []

    def estimate(frames):
        doa = replicas[canonical_device(frames.device)].forward_batch(frames)[0]
        calls.append(frames.shape[0])
        return doa

    t, sig = sinusoid_template(1750.0, duration)
    trial = make_trial_fn(demo.geometry, t, sig, estimate, FS, device=demo.device)

    def sweep():
        res = monte_carlo_sweep(trial, [10.0], num_sims, seed=0, mesh=mesh)
        for d in replicas:
            sync(d)
        return res

    sweep()  # warm-up
    calls.clear()
    montecarlo.gathered_bytes.clear()
    res = sweep()
    blocks = list(calls)
    leaving = [montecarlo.gathered_bytes[i] for i in range(len(devices))]
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sweep()
        walls.append(time.perf_counter() - t0)
    return {
        "n_devices": len(devices),
        "devices": [str(d) for d in devices],
        "num_sims": num_sims,
        "per_device_key_block": blocks[0] if len(set(blocks)) == 1 else blocks,
        "bytes_leaving_shard": leaving[0] if len(set(leaving)) == 1 else leaving,
        "trials_per_sec_wall": num_sims / min(walls),
        "mae_rad": float(res["mae"][0]),
        "errors": res["errors"],
    }


def main(num_sims: int = 64, device=None) -> dict:
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = make_mesh().axis_devices("data")
        devices = [cards[i % len(cards)] for i in range(SHARDS)]
    else:
        devices = [dev] * SHARDS
    demo = build_demo(devices[0])
    r1 = analyze(demo, devices[:1], num_sims)
    rn = analyze(demo, devices, num_sims)
    errors_equal = bool(np.array_equal(r1.pop("errors"), rn.pop("errors")))
    result = {
        "experiment": "multichip_scaling",
        "host_physical_cores": os.cpu_count(),
        "device": torch.cuda.get_device_name(devices[0]) if dev.type == "cuda" else "cpu",
        "cards": len(set(devices)),
        "mesh1": r1,
        f"mesh{SHARDS}": rn,
        "per_device_work_ratio": r1["per_device_key_block"] / rn["per_device_key_block"],
        f"wall_ratio_{SHARDS}_over_1": rn["trials_per_sec_wall"] / r1["trials_per_sec_wall"],
        "errors_equal": errors_equal,
        "note": "shards on one device run one after another: the per-shard block, not the wall ratio, is what "
                "n cards would each run",
    }
    print(json.dumps(result, indent=2))
    return result


def cli(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)
    return main(32 if args.quick else 64, args.device)


if __name__ == "__main__":
    cli()
