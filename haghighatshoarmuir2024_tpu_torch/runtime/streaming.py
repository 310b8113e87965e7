"""Streaming localization runtime: carried-state chunked processing
(counterpart of ``haghighatshoarmuir2024_tpu/runtime/streaming.py``; the
reference processes independent 0.25 s recordings,
micloc/xylo_snn_localization.py:446-542).

One step advances B concurrent streams by one chunk each, with every filter,
encoder and neuron state carried on the device:

* STHT: the quadrature FIR carries its K−1 samples of history; the in-phase
  branch is a true K/2-sample delay line (``ops/stht.stht_stream``).
* Bandpass + integrator: the stable bandpass as a lifted blocked cumsum with
  the TDF2 state and the running integrator total carried exactly
  (``ops/iir.iir_cumsum_blocked``), the JAX runtime's TPU form
  (``streaming.py:181-209``).  The block size is the first of
  (32, 48, 40, 24, 16, 8) that divides the chunk length; where none does,
  the sequential scan runs, with a warning.
* RZCC: a peak decision needs lookahead, so the last ``pending`` samples of
  each chunk stay undecided until the next chunk arrives, and a ``guard`` of
  decided samples precedes the analysis window so that suppression works
  across the seam.  Kernels K1/K2 run on the (L, B·C) analysis window and
  the decisions over ``[guard, guard + Tc)`` are kept.
* Integer LIF: isyn/vmem/spk carried exactly through kernel K4 from the two
  polarity masks (bipolar model), or through kernel K6 from the positive
  plane as a bool raster (unipolar model; JAX ``streaming.py:264-271,
  316-328``, its TPU form).

Emitted spikes lag the input by ``pending`` samples.  A single stream is a
batch of one.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..geometry import resolve_device
from ..models.xylo.pipeline import STACKED
from ..models.xylo.sim import uniform_rec_coef
from ..ops.cuda.lif_kernel import lif_count_stateful, lif_count_stateful_bipolar
from ..ops.cuda.suppress_kernel import rzcc_encode_bipolar_tm_finish, rzcc_encode_bipolar_tm_launch
from ..ops.iir import iir_cumsum_blocked, iir_scan
from ..ops.stht import stht_stream

BLOCK_SIZES = (32, 48, 40, 24, 16, 8)  # lifted-IIR block sizes, in order of preference

_TIME_MAJOR = ("fir_tail", "delay_line", "pending")
_INT32 = ("isyn", "vmem", "spk", "counts")


@dataclasses.dataclass
class StreamState:
    """The carried state of B streams.  Time-carrying buffers are time-major
    (time, B, ...), as the step consumes them; the rest lead with B."""

    fir_tail: torch.Tensor  # (K-1, B, M) float32: raw-signal history of the quadrature FIR
    delay_line: torch.Tensor  # (K//2, B, M) float32: in-phase delay
    iir_state: torch.Tensor  # (B, C, N_state) float32: TDF2 state of the bandpass
    int_carry: torch.Tensor  # (B, C) float32: running integrator total
    pending: torch.Tensor  # (guard + P, B, C) float32: integrated samples not decided yet
    isyn: torch.Tensor  # (B, N) int32
    vmem: torch.Tensor  # (B, N) int32
    spk: torch.Tensor  # (B, N) int32
    counts: torch.Tensor  # (B, N) int32: accumulated hidden spikes
    steps: torch.Tensor  # (B,) int64: decided samples so far

    @property
    def batch(self) -> int:
        return self.steps.shape[0]

    def _lanes(self, name: str, mask: torch.Tensor) -> torch.Tensor:
        """``mask`` (B,) bool shaped to broadcast over field ``name``."""
        t = getattr(self, name)
        shape = [1] * t.dim()
        shape[1 if name in _TIME_MAJOR else 0] = -1
        return mask.reshape(shape)

    def zero_where(self, mask: torch.Tensor) -> "StreamState":
        """The state with the lanes of ``mask`` (B,) bool reset to zeros, a
        fresh stream's state."""
        return StreamState(**{f.name: getattr(self, f.name).masked_fill(self._lanes(f.name, mask), 0)
                              for f in dataclasses.fields(self)})

    def where(self, mask: torch.Tensor, other: "StreamState") -> "StreamState":
        """This state's lanes where ``mask`` (B,) bool is set, ``other``'s
        elsewhere."""
        return StreamState(**{
            f.name: torch.where(self._lanes(f.name, mask), getattr(self, f.name), getattr(other, f.name))
            for f in dataclasses.fields(self)
        })

    @classmethod
    def cat(cls, states, device="cpu") -> "StreamState":
        """Per-shard states put back together on ``device``, in order."""
        return cls(**{f.name: torch.cat([getattr(s, f.name).to(device) for s in states],
                                        dim=1 if f.name in _TIME_MAJOR else 0)
                      for f in dataclasses.fields(cls)})

    @classmethod
    def from_numpy(cls, arrays, device=None) -> "StreamState":
        """A state from the arrays of a JAX ``StreamState`` (its
        ``_asdict()``, or any mapping of the same names), batched (B, ...)
        or single-stream, on ``device`` (the card unless ``"cpu"`` is asked
        for).  The JAX state leads every field with the stream axis; here the
        time-carrying buffers become time-major."""
        device = resolve_device(device)
        arrays = dict(arrays)
        batched = np.ndim(arrays["isyn"]) == 2
        out = {}
        for f in dataclasses.fields(cls):
            a = np.array(arrays[f.name])  # a copy: JAX hands out read-only buffers
            if not batched:
                a = a[None]
            if f.name in _TIME_MAJOR:
                a = np.swapaxes(a, 0, 1)
            dtype = torch.int32 if f.name in _INT32 else torch.int64 if f.name == "steps" else torch.float32
            out[f.name] = torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
        return cls(**out)


class StreamingLocalizer:
    """Streaming twin of the quantized pipeline (``models.xylo.Demo``), on
    the demo's device.  Uniform ``w_rec`` only."""

    def __init__(self, demo, pending: int | None = None):
        self.demo = demo
        self.device = demo.device
        self.kernel = demo.kernel
        self.K = len(self.kernel)
        self.rw = demo.robust_width
        self.guard = 2 * self.rw
        self.pending = pending if pending is not None else 4 * self.rw
        self.num_mic = len(demo.geometry)
        self._bp = [(np.asarray(b), np.asarray(a)) for b, a in demo.filterbank.ba_list]
        self.C = 2 * self.num_mic * len(self._bp)
        self.N_state = len(self._bp[0][1]) - 1
        cfg = demo.xylo_config
        try:
            uniform_rec_coef(cfg)
        except ValueError:
            raise ValueError("streaming runtime supports uniform w_rec only") from None
        self.n_hidden = cfg.n_hidden
        self.bipolar = demo.bipolar_spikes
        self._lif = demo.lif_params()

    def init_state(self, batch: int | None = None) -> StreamState:
        """Fresh state for ``batch`` concurrent streams (one when None)."""
        B = 1 if batch is None else int(batch)
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=self.device)
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=self.device)
        return StreamState(
            fir_tail=z(self.K - 1, B, self.num_mic),
            delay_line=z(self.K // 2, B, self.num_mic),
            iir_state=z(B, self.C, self.N_state),
            int_carry=z(B, self.C),
            pending=z(self.guard + self.pending, B, self.C),
            isyn=zi(B, self.n_hidden),
            vmem=zi(B, self.n_hidden),
            spk=zi(B, self.n_hidden),
            counts=zi(B, self.n_hidden),
            steps=torch.zeros(B, dtype=torch.int64, device=self.device),
        )

    @staticmethod
    def block_size(Tc: int) -> int | None:
        """The lifted-IIR block size for chunks of ``Tc`` samples: the carried
        state pins it to a divisor of Tc (``streaming.py:187-194``)."""
        return next((s for s in BLOCK_SIZES if Tc % s == 0), None)

    def _encode(self, state: StreamState, x: torch.Tensor):
        """STHT and integrated bandpass of one (Tc, B, M) chunk: the new
        encoder state and the integrated (Tc, B, C) signal."""
        Tc = x.shape[0]
        inphase, quad, fir_tail, delay_line = stht_stream(x, state.fir_tail, state.delay_line, self.kernel)
        sig_real = torch.cat([inphase, quad], dim=-1)  # (Tc, B, 2M)
        sb = self.block_size(Tc)
        if sb is None:
            warnings.warn(
                f"no lifted block size in {BLOCK_SIZES} divides the chunk length {Tc}: "
                "the streaming bandpass runs the sequential scan, one step per sample",
                RuntimeWarning, stacklevel=3,
            )
        ch = 2 * self.num_mic
        outs, states, carries = [], [], []
        for i, (b, a) in enumerate(self._bp):
            zi = state.iir_state[:, i * ch:(i + 1) * ch]
            carry = state.int_carry[:, i * ch:(i + 1) * ch]
            if sb is not None:
                y, zf = iir_cumsum_blocked(b, a, sig_real, zi=torch.cat([zi, carry[..., None]], dim=-1),
                                           return_state=True, sb=sb)
                zf, carry = zf[..., :-1], zf[..., -1]
            else:
                y, zf = iir_scan(b, a, sig_real, zi)
                y = torch.cumsum(y, dim=0) + carry
                carry = y[-1]
            outs.append(y)
            states.append(zf)
            carries.append(carry)
        return fir_tail, delay_line, torch.cat(states, dim=1), torch.cat(carries, dim=1), torch.cat(outs, dim=-1)

    def _step(self, state: StreamState, chunks: torch.Tensor):
        """Advance all B streams by one (B, Tc, M) chunk: the new state and
        the two decided (Tc, B, C) polarity masks; a unipolar model's
        negative mask is None."""
        return self._step_finish(self._step_launch(state, chunks))

    def _step_launch(self, state: StreamState, chunks: torch.Tensor):
        """The first half of :meth:`_step`, up to K2's first round: the
        encode and the RZCC launched, the host not yet waiting on the card."""
        B, Tc, _ = chunks.shape
        fir_tail, delay_line, iir_state, int_carry, integrated = self._encode(state, chunks.transpose(0, 1))
        analysis = torch.cat([state.pending, integrated], dim=0)  # (L, B, C), time-major
        L = analysis.shape[0]
        rzcc = rzcc_encode_bipolar_tm_launch(analysis.reshape(L, B * self.C), self.rw, 2 * self.rw)
        return state, (fir_tail, delay_line, iir_state, int_carry), analysis, rzcc

    def _step_finish(self, launched):
        """The rest of :meth:`_step`: K2's flags read, then the LIF."""
        state, (fir_tail, delay_line, iir_state, int_carry), analysis, rzcc = launched
        B, Tc = state.batch, analysis.shape[0] - state.pending.shape[0]
        kp, kn = rzcc_encode_bipolar_tm_finish(rzcc)
        kp = kp[self.guard:self.guard + Tc].reshape(Tc, B, self.C)
        # spike_bound=1: binary masks from a zero start state, so the
        # no-saturation proof carries across chunks
        if self.bipolar:
            kn = kn[self.guard:self.guard + Tc].reshape(Tc, B, self.C)
            counts, isyn, vmem, spk = lif_count_stateful_bipolar(
                self._lif, kp, kn, state.isyn, state.vmem, state.spk, spike_bound=1)
        else:
            kn = None
            counts, isyn, vmem, spk = lif_count_stateful(
                self._lif, kp, state.isyn, state.vmem, state.spk, spike_bound=1, time_major=True)
        new = StreamState(
            fir_tail=fir_tail, delay_line=delay_line, iir_state=iir_state, int_carry=int_carry,
            pending=analysis[Tc:], isyn=isyn, vmem=vmem, spk=spk,
            counts=state.counts + counts, steps=state.steps + Tc,
        )
        return new, kp, kn

    def process_chunk(self, state: StreamState, chunk, return_spikes: bool = True):
        """One chunk in, ``(new_state, decided input-spike raster)`` out.

        ``chunk`` is (B, Tc, M) for a ``init_state(batch=B)`` state, or
        (Tc, M) for a single stream (a batch of one).  The raster is int8,
        ``[kp & ~kn, kn]`` (2C channels) for a bipolar model and ``kp`` (C)
        for a unipolar one: (Tc, C') for a single stream, time-major
        (Tc, B, C') for a batch.  ``return_spikes=False`` returns the new
        state alone (the serving loop needs only the counts)."""
        x, single = self._as_chunks(state, chunk)
        new, kp, kn = self._step(state, x)
        if not return_spikes:
            return new
        spikes = (kp if kn is None else torch.cat([kp & ~kn, kn], dim=-1)).to(torch.int8)
        return new, spikes[:, 0] if single else spikes

    def _as_chunks(self, state: StreamState, chunk):
        """``chunk`` as a (B, Tc, M) float32 batch on this device for
        ``state``, and whether it was a single stream's (Tc, M)."""
        x = torch.as_tensor(chunk, dtype=torch.float32, device=self.device)
        single = x.dim() == 2
        if single:
            x = x[None]
        if x.dim() != 3 or x.shape[-1] != self.num_mic or x.shape[0] != state.batch:
            raise ValueError(
                f"chunk must be (Tc, {self.num_mic}) or ({state.batch}, Tc, {self.num_mic}) "
                f"for this state; got {tuple(torch.as_tensor(chunk).shape)}"
            )
        return x, single

    def make_sharded_step(self, mesh, axis_name: str = "data"):
        """The data-parallel serving step over a device mesh (JAX
        ``streaming.py:378-405``): ``step(states, chunks) -> new states``
        over per-shard states, B/n streams each on its shard's device (made
        by ``step.init_state(B)``; ``StreamState.cat`` puts them together).
        ``chunks`` is the whole (B, Tc, M) batch, split here on the stream
        axis, or a list of per-shard (B/n, Tc, M) pieces.  Each shard runs
        :meth:`_step` (no spike raster) on a localizer of its device over a
        copy of the demo (``parallel.replicate_demo``; shards on this
        localizer's device share it), and no tensor moves between shards.
        One host thread drives every shard: each shard's step is launched up
        to K2's flag read (:meth:`_step_launch`) before any flag is read, so
        that every card has its work queued while the host waits on one.
        ``step.localizers`` holds each shard's localizer."""
        from ..parallel.mesh import canonical_device, device_scope, replicate_demo, split

        devices = mesh.axis_devices(axis_name)
        n = len(devices)
        by_device = {canonical_device(self.device): self}
        for d in devices:
            if d not in by_device:
                by_device[d] = StreamingLocalizer(replicate_demo(self.demo, d), self.pending)
        localizers = [by_device[d] for d in devices]

        def init_state(batch: int) -> list:
            if batch % n:
                raise ValueError(f"{batch} streams do not divide the {n} shards of {axis_name!r}")
            return [sl.init_state(batch // n) for sl in localizers]

        def step(states, chunks) -> list:
            if len(states) != n:
                raise ValueError(f"{len(states)} states for the {n} shards of {axis_name!r}")
            pieces = list(chunks) if isinstance(chunks, (list, tuple)) else split(chunks, mesh, 0, axis_name)
            launched = []
            for sl, st, x in zip(localizers, states, pieces):
                with device_scope(sl.device):
                    launched.append(sl._step_launch(st, sl._as_chunks(st, x)[0]))
            out = []
            for sl, pending in zip(localizers, launched):
                with device_scope(sl.device):
                    out.append(sl._step_finish(pending)[0])
            return out

        step.init_state = init_state
        step.localizers = localizers
        return step

    def rate(self, state: StreamState, fold: bool = True) -> torch.Tensor:
        """Per-DoA spike rates (B, G) from the accumulated counts
        (``fold=False``: the unfolded (B, F·G) band-major rates)."""
        steps = state.steps.clamp(min=1).to(torch.float32)
        r = state.counts.to(torch.float32) / steps[:, None] * self.demo.fs
        if not fold:
            return r
        return r.reshape(r.shape[0], -1, len(self.demo.doa_list)).mean(dim=1)

    def estimate_doa(self, state: StreamState, method: str = "peak") -> torch.Tensor:
        """(B,) DoAs from the accumulated counts by any estimator of
        ``demo.estimate_doa_from_rate``: the folded rates, the unfolded ones
        for ``"matched_stacked"`` and ``"matched_auto"`` (JAX
        ``streaming.py:418-425``)."""
        return self.demo.estimate_doa_from_rate(self.rate(state, fold=method not in STACKED), method)
