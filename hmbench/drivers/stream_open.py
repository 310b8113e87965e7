"""Live streams in an open loop: S = ``lanes`` × ``groups`` streams, each
sending a chunk of one frame of the configuration once a frame; their phases
spread evenly over the period in ``groups`` groups of ``lanes``, one group
one step of the port's streaming runtime.

Group g sends chunk g mod ``pool_groups`` of a pinned pool (at most
``pool_groups`` × 52 MB at 96 lanes and 0.4 s).  A group's step, when its
chunk is due (the end of its audio): the upload of its float32 chunk from
a pinned host pool, ``StreamingLocalizer.process_chunk`` on the group's
carried state, ``estimate_doa("matched")``, the DoAs to the host.  Due chunks run in due order; the schedule never waits for the card.
Reports ``chunk_p95_ms``: the 95th percentile over every chunk due in the
window of (its DoAs on the host − its due time).
"""
from __future__ import annotations

import math
import time

import numpy as np

from .. import device, signals
from ..run import Outcome
from ..system import build_demo
from ..trace import STEP_MARK, WINDOW_MARK, span, traced
from ..check import draw
from . import streams
from .streams import chunks, shape, verify

# The last SPIN_S before a chunk is due are spun, not slept: on the H100 machines
# measured, a sleep of about a millisecond woke 0.3-2 ms late, which the chunks' lateness
# would count as the system's.
SPIN_S = 2e-3


def checked_inputs(ctx, dev):
    """(S, Tc, M) chunks of the streams whose answers the reference
    recomputes, made as a run makes them."""
    import torch

    tr = ctx.traffic
    gen = signals.generator(ctx.seed, dev)
    pool = [chunks(ctx, int(tr["lanes"]), dev, gen) for _ in range(min(int(tr["groups"]), int(tr["pool_groups"])))]
    return torch.cat([pool[g % len(pool)] for g in draw(ctx, int(tr["groups"]), int(tr["check_groups"]))])


def control(ctx, dev) -> dict:
    """The control's numbers on the streams that a run of this cell checks."""
    return streams.control(ctx, checked_inputs(ctx, dev), dev)


class Streams:
    """The served streams: the port's localizer, each group's carried state
    and pinned chunk, and the upload buffer."""

    def __init__(self, ctx, dev, groups: int, marks=None):
        import torch

        from haghighatshoarmuir2024_tpu_torch.runtime.streaming import StreamingLocalizer

        tr = ctx.traffic
        self.lanes, self.groups, self.period = int(tr["lanes"]), int(groups), float(ctx.cfg.model["frame_s"])
        self.sl = StreamingLocalizer(build_demo(ctx.cfg, dev))
        marks = marks or device.Marks(time.perf_counter())
        marks("the port's import and Demo")
        gen = signals.generator(ctx.seed, dev)
        self.pool = []  # group g sends pool[g % len(pool)]
        for _ in range(min(self.groups, int(tr["pool_groups"]))):
            c = chunks(ctx, self.lanes, dev, gen)
            h = device.host_buffer(tuple(c.shape), torch.float32, dev)
            h.copy_(c)
            self.pool.append(h)
        self.x = torch.empty_like(c)
        marks("pinned pool")
        self.before = int(tr["steps_before_window"])
        self.dev = dev
        self.regroup(self.groups)

    def step(self, state, g: int):
        """One group's step: ``(new state, its DoAs on the host)``."""
        self.x.copy_(self.pool[g % len(self.pool)], non_blocking=True)
        state = self.sl.process_chunk(state, self.x, return_spikes=False)
        return state, self.sl.estimate_doa(state, "matched").cpu()

    def regroup(self, groups: int) -> None:
        """Start ``groups`` groups of streams, each taking its first
        ``before`` steps: the step's shapes, and the memory each group's
        carried state holds, are in place before the window."""
        self.groups = int(groups)
        self.states = [self.sl.init_state(self.lanes) for _ in range(self.groups)]
        for _ in range(self.before):
            for g in range(self.groups):
                self.states[g] = self.step(self.states[g], g)[0]
        device.sync([self.dev])

    def serve(self, seconds: float, keep: dict, mark: bool) -> dict:
        """The open loop over every chunk due in ``seconds``, and on to the
        last step ``keep`` asks for; ``keep`` maps a group to the number of
        its first window steps whose carried counts and DoAs are kept."""
        gap = self.period / self.groups
        n = max([int(math.ceil(seconds / gap))] + [(k - 1) * self.groups + g + 1 for g, k in keep.items()])
        late = np.empty(n)
        step_s = np.empty(n)
        queue = np.empty(n, dtype=np.int64)
        kept = {g: [] for g in keep}
        with span(WINDOW_MARK, mark):
            t0 = time.perf_counter()
            for j in range(n):
                g, k = j % self.groups, j // self.groups
                due = t0 + (j + 1) * gap
                while (now := time.perf_counter()) < due:
                    if due - now > SPIN_S:
                        time.sleep(due - now - SPIN_S)
                queue[j] = int((now - t0) // gap) - j  # chunks due and not yet started, this one among them
                with span(STEP_MARK, mark):
                    self.states[g], doa = self.step(self.states[g], g)
                done = time.perf_counter()
                late[j], step_s[j] = done - due, done - now
                if g in keep and k < keep[g]:
                    kept[g].append((self.states[g].counts.clone(), doa.numpy()))
            wall = time.perf_counter() - t0
        return dict(late=late, step_s=step_s, queue=queue, wall=wall, kept=kept, chunks=n)


def run(ctx) -> Outcome:
    import torch

    dev = ctx.devices[0]
    device.use(dev)
    tr = ctx.traffic
    marks = device.Marks(ctx.t0)
    srv = Streams(ctx, dev, int(tr["groups"]), marks)
    setup_s = marks("streams started")
    steps = int(tr["check_steps"])
    keep = {g: steps for g in draw(ctx, srv.groups, int(tr["check_groups"]))}
    view = None
    if ctx.trace:
        def traced_window():
            srv.regroup(srv.groups)  # streams from their start, should the trace be taken again
            return srv.serve(min(ctx.seconds, float(tr["trace_seconds"])), keep, True)

        res, view = traced(traced_window)
        view.calls, view.step_ms = res["chunks"], list(res["step_s"] * 1e3)
        view.shape = shape(ctx, srv.sl, srv.lanes)
    else:
        res = srv.serve(ctx.seconds, keep, False)
    memory_peak = device.memory_peak([dev])

    groups = sorted(keep)
    prog_counts = np.concatenate([np.stack([c.cpu().numpy() for c, _ in res["kept"][g]]) for g in groups], axis=1)
    prog_doa = np.concatenate([np.stack([d for _, d in res["kept"][g]]) for g in groups], axis=1)
    host_chunks = torch.cat([srv.pool[g % len(srv.pool)] for g in groups])
    del srv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, nnz = verify(ctx, host_chunks, prog_counts, prog_doa, dev, int(tr["steps_before_window"]))
    if view is not None:
        view.nnz = nnz * int(tr["lanes"])
    lanes = int(tr["lanes"])
    e2e = {"chunk_p95_ms": float(np.percentile(res["late"], 95) * 1e3), "setup_s": setup_s}
    return Outcome(e2e=e2e, attempted=res["chunks"] * lanes, failed=0, memory_peak_bytes=memory_peak,
                   checks=checks, view=view)
