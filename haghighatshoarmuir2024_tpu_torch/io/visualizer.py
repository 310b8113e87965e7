"""Live DoA visualizer (counterpart of ``haghighatshoarmuir2024_tpu/io/visualizer.py``;
reference: micloc/visualizer.py).

A ring buffer of (time, value) samples pushed from the compute loop, and a
``multiprocessing`` process (spawned) that redraws them with matplotlib,
fed through a queue (micloc/visualizer.py:24,94-127).  The queue belongs to
the instance, so several visualizers can coexist; ``headless=True`` keeps
the samples in ``history`` and spawns nothing.  This module imports numpy
only: matplotlib is imported inside the plotting process.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import time
from typing import Optional

import numpy as np


def _plot_loop(queue: "mp.Queue", waiting_time: float, plot_kwargs: dict):
    """The plotting process: redraw the latest buffer the queue holds until
    it delivers None."""
    import matplotlib

    matplotlib.use(plot_kwargs.pop("backend", "Agg"))
    import matplotlib.pyplot as plt

    figsize = plot_kwargs.pop("figsize", (12, 8))
    xlabel = plot_kwargs.pop("xlabel", "time")
    ylabel = plot_kwargs.pop("ylabel", "value")
    title = plot_kwargs.pop("title", "")
    grid = plot_kwargs.pop("grid", True)

    fig, ax = plt.subplots(figsize=figsize)
    last_data_time = time.time()
    buffer = None
    while True:
        got = False
        try:
            while True:
                item = queue.get_nowait()
                got = True
                if item is None:
                    plt.close(fig)
                    return
                buffer = item
        except queue_mod.Empty:
            pass
        if got:
            last_data_time = time.time()
            ax.clear()
            t_vec, v = buffer
            ax.plot(t_vec, v, ".-")
            ax.set_xlabel(xlabel)
            ax.set_ylabel(ylabel)
            ax.set_title(title)
            ax.grid(grid)
            fig.canvas.draw_idle()
            plt.pause(0.001)
        elif time.time() - last_data_time > waiting_time:
            ax.set_title(f"{title}  [waiting for data ...]")
            plt.pause(0.01)
        else:
            time.sleep(0.01)


class Visualizer:
    """Ring-buffered live plotter (micloc/visualizer.py:27-186)."""

    def __init__(
        self,
        buffer_size: int = 60,
        dim_samples: int = 1,
        waiting_time: float = 2.0,
        headless: bool = False,
    ):
        self.buffer_size = buffer_size
        self.dim_samples = dim_samples
        self.waiting_time = waiting_time
        self.headless = headless

        self._time = np.zeros(buffer_size)
        self._vals = np.full((buffer_size, dim_samples), np.nan)
        self._t0 = time.time()
        self._queue: Optional[mp.Queue] = None
        self._proc: Optional[mp.Process] = None
        self.history = []  # headless capture

    def start(self, **plot_kwargs):
        if self.headless:
            return
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue()
        self._proc = ctx.Process(target=_plot_loop, args=(self._queue, self.waiting_time, plot_kwargs))
        self._proc.daemon = True
        self._proc.start()

    def push(self, value):
        """Shift the ring buffer and enqueue a copy (micloc/visualizer.py:107-127)."""
        value = np.atleast_1d(np.asarray(value, dtype=np.float64))
        self._time = np.roll(self._time, -1)
        self._vals = np.roll(self._vals, -1, axis=0)
        self._time[-1] = time.time() - self._t0
        self._vals[-1] = value
        self.history.append((self._time[-1], value.copy()))
        if self._queue is not None:
            self._queue.put((self._time.copy(), self._vals.copy()))

    def stop(self):
        """Tell the plotting process to end, wait up to 2 s, then terminate it."""
        if self._queue is not None:
            self._queue.put(None)
        if self._proc is not None:
            self._proc.join(timeout=2.0)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=2.0)
            self._proc = None
        if self._queue is not None:
            # the reader is gone: samples still buffered are dropped, not
            # waited for (a full pipe would block the exit)
            self._queue.cancel_join_thread()
            self._queue.close()
            self._queue = None
