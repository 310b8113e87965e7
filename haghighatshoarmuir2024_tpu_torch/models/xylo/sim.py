"""Integer LIF simulator, plain PyTorch (counterpart of
``haghighatshoarmuir2024_tpu/models/xylo/sim.py``; reference: rockpool
``XyloSim`` as used at micloc/xylo_snn_localization.py:286-377).

Per step, per hidden neuron, all int32, in the default convention
(``ordering="decay_first"``, ``reset="subtract"``):

    isyn ← sat(isyn − (isyn >> dash_syn) + inp + rec)
    vmem ← sat(vmem − (vmem >> dash_mem) + isyn)
    spk  ← vmem ≥ threshold;  vmem ← vmem − spk·threshold

with ``>>`` arithmetic, ``sat`` the 16-bit state range and ``rec`` the
previous step's spikes through ``w_rec``: ``c·Σ spk`` for a uniform
``w_rec = c·ones``, ``spk @ w_rec`` for a dense one.  ``integrate_first``
adds the input before the decay (``x = sat(isyn + inp + rec)``,
``isyn = sat(x − (x >> dash_syn))``, likewise ``vmem`` from
``y = sat(vmem + isyn)``); ``reset="zero"`` sets a spiking membrane to 0.
JAX's ``_sim_hidden`` (``sim.py:61-123``) keeps the four conventions behind
static flags to bound the simulator's one open assumption
(experiments/xylo_ordering_sensitivity.py).

The plain scan (:func:`scan_hidden_plain`) is a Python loop of tensor
ops, one step at a time: the CPU's route.  On the card :func:`scan_hidden`
runs the hand kernel ``csrc/xylo_sim.cu`` instead, all T steps in one
launch, bit for bit the same integers (JAX runs the scan as one
``lax.scan``).  Products with ``w_in``, ``w_rec`` and ``w_out`` run in
float64, exact for the integer operands (JAX's float32 products are exact
below 2^24, ``sim.py:14-17``), so the integers equal JAX's.  The plain loop
is also the plain version of kernels K3-K6 (``ops/cuda/lif_kernel.py``,
through :func:`sim_hidden`), which implement the default convention with a
uniform ``w_rec`` only.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...geometry import resolve_device
from .quantize import XyloConfig

STATE_MIN = -(2**15)
STATE_MAX = 2**15 - 1
ORDERINGS = ("decay_first", "integrate_first")
RESETS = ("subtract", "zero")


def recurrence(w_rec):
    """``(rec_coef, dense w_rec or None)`` of a recurrent matrix, the
    uniform test of JAX ``XyloSim`` (``sim.py:159-161``): a uniform (or
    empty) matrix becomes its scalar, any other stays dense."""
    wr = np.asarray(w_rec)
    if not wr.size:
        return 0, None
    if np.all(wr == wr.flat[0]):
        return int(wr.flat[0]), None
    return 0, wr


def uniform_rec_coef(config: XyloConfig) -> int:
    """The scalar c of a uniform ``w_rec = c·ones`` (0 for an empty one);
    raises for a non-uniform recurrence, which only the dense scan
    (:func:`scan_hidden`) handles: K3-K6 take the scalar."""
    coef, dense = recurrence(config.w_rec)
    if dense is not None:
        raise ValueError("the integer LIF here requires a uniform w_rec")
    return coef


def int_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` of integer operands as int32 (float64 products, exact for
    integer operands below 2^53), on ``x``'s device."""
    w = torch.as_tensor(np.asarray(w), device=x.device).to(torch.float64)
    return torch.matmul(x.to(torch.float64), w).to(torch.int32)


def project_input(config: XyloConfig, spikes: torch.Tensor) -> torch.Tensor:
    """Input current ``spikes @ w_in`` as int32."""
    return int_matmul(spikes, config.w_in)


def held_recurrence(w_rec):
    """:func:`recurrence` for a model that keeps its weights: a dense matrix
    as a ``sim_kernel.DenseRec``, whose array for the card is built at its
    first call there and kept."""
    from ...ops.cuda import sim_kernel

    coef, dense = recurrence(w_rec)
    return coef, None if dense is None else sim_kernel.DenseRec(dense)


def _int32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, device=dev).to(torch.int32)


def scan_hidden(inp: torch.Tensor, dash_syn, dash_mem, threshold, state0=None, *, rec_coef: int = 0,
                w_rec=None, ordering: str = "decay_first", reset: str = "subtract", record: bool = True,
                record_state: bool = False, count: bool = False):
    """Scan the hidden-layer integer LIF over time: on a CPU tensor
    :func:`scan_hidden_plain` (arguments and returns there), on any other
    the hand kernel ``csrc/xylo_sim.cu`` (``ops/cuda/sim_kernel.py``: one
    launch for all T steps, the same integers bit for bit), which raises
    off the card."""
    from ...ops.cuda import sim_kernel

    return sim_kernel.scan_hidden(inp, dash_syn, dash_mem, threshold, state0, rec_coef=rec_coef, w_rec=w_rec,
                                  ordering=ordering, reset=reset, record=record, record_state=record_state,
                                  count=count)


def scan_hidden_plain(inp: torch.Tensor, dash_syn, dash_mem, threshold, state0=None, *, rec_coef: int = 0,
                      w_rec=None, ordering: str = "decay_first", reset: str = "subtract", record: bool = True,
                      record_state: bool = False, count: bool = False):
    """Scan the hidden-layer integer LIF over time, a step of tensor ops at
    a time: the CPU's route, the plain version the kernel is held to on the
    card, and (through :func:`sim_hidden`) the twin of K3-K6.

    Args:
        inp: (T, ..., N) int32 input current per step (time leading, any
            batch dims between).
        dash_syn, dash_mem, threshold: (N,) integers (arrays or tensors).
        state0: initial ``(isyn, vmem, spk)``, each broadcastable to
            (..., N); zeros when None.
        rec_coef: uniform recurrence (``c·Σ_n spk`` over the N neurons of
            the same batch row); ignored when ``w_rec`` is given.
        w_rec: dense (N, N) recurrent weights (``spk @ w_rec`` every step).
        ordering, reset: the step convention (module docstring).
        record: return the (T, ..., N) int32 spike raster.
        record_state: also return ``Isyn`` and ``Vmem`` after each step.
        count: return the (..., N) int32 spike counts.

    Returns:
        ``(spikes or None, counts or None, (isyn, vmem, spk), rec)`` with
        ``rec`` the dict ``{"Isyn", "Vmem"}`` (empty without
        ``record_state``).  The records are allocated once, (T, ..., N)
        each.  With T = 0 the final state is ``state0``.
    """
    if ordering not in ORDERINGS:
        raise ValueError(f"unknown ordering {ordering!r}")
    if reset not in RESETS:
        raise ValueError(f"unknown reset {reset!r}")
    dev = inp.device
    ds, dm, th = (_int32(a, dev) for a in (dash_syn, dash_mem, threshold))
    shape = inp.shape[1:]
    if state0 is None:
        isyn, vmem, spk = (torch.zeros(shape, dtype=torch.int32, device=dev) for _ in range(3))
    else:
        isyn, vmem, spk = (_int32(s, dev).expand(shape).clone() for s in state0)
    wr = None if w_rec is None else torch.as_tensor(np.asarray(w_rec), device=dev).to(torch.float64)
    T = inp.shape[0]
    new = lambda: torch.empty((T,) + tuple(shape), dtype=torch.int32, device=dev)  # noqa: E731
    spikes = new() if record else None
    isyn_rec, vmem_rec = (new(), new()) if record_state else (None, None)
    counts = torch.zeros(shape, dtype=torch.int32, device=dev) if count else None
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def sat(x, out=None):
        return torch.clamp(x, STATE_MIN, STATE_MAX, out=out)

    # each step writes its state straight into its record rows (``out=``)
    # and its spikes into the raster: the same arithmetic in fewer launches
    for t in range(T):
        cur = inp[t]
        if wr is not None:
            cur = cur + torch.matmul(spk.to(torch.float64), wr).to(torch.int32)
        elif rec_coef:
            cur = cur + rec_coef * spk.sum(dim=-1, keepdim=True, dtype=torch.int32)
        isyn_out = isyn_rec[t] if record_state else None
        vmem_out = vmem_rec[t] if record_state else None
        if ordering == "decay_first":
            isyn = sat(isyn - (isyn >> ds) + cur, isyn_out)
            vmem = sat(vmem - (vmem >> dm) + isyn)
        else:
            x = sat(isyn + cur)
            isyn = sat(x - (x >> ds), isyn_out)
            y = sat(vmem + isyn)
            vmem = sat(y - (y >> dm))
        fire = vmem >= th
        spk = spikes[t].copy_(fire) if record else fire.to(torch.int32)
        if reset == "subtract":
            vmem = torch.addcmul(vmem, spk, th, value=-1, out=vmem_out)
        else:
            vmem = torch.where(fire, zero, vmem, out=vmem_out)
        if count:
            counts += spk
    if T and (record or record_state):  # the final state must not hold the records alive
        isyn, vmem, spk = isyn.clone(), vmem.clone(), spk.clone()
    rec = {"Isyn": isyn_rec, "Vmem": vmem_rec} if record_state else {}
    return spikes, counts, (isyn, vmem, spk), rec


def sim_hidden(inp: torch.Tensor, dash_syn, dash_mem, threshold, rec_coef: int = 0,
               record: bool = True, state0=None):
    """The default convention with a uniform recurrence, with counts: the
    plain version of K3-K6.  Returns ``(spikes or None, counts, (isyn,
    vmem, spk))`` (see :func:`scan_hidden`)."""
    spikes, counts, state, _ = scan_hidden_plain(inp, dash_syn, dash_mem, threshold, state0, rec_coef=rec_coef,
                                                 record=record, count=True)
    return spikes, counts, state


def _zero_state(n: int, device) -> tuple:
    return tuple(torch.zeros(n, dtype=torch.int32, device=device) for _ in range(3))


def _time_major(x: torch.Tensor):
    """``(x time-major, back)``: (T, N) stays, (B, T, N) becomes (T, B, N);
    ``back`` turns a time-major output into the input's layout."""
    if x.dim() == 3:
        return x.transpose(0, 1), lambda r: r.transpose(0, 1)
    return x, lambda r: r


class XyloSim:
    """Software twin of the Xylo-A2 chip for the quantized localization SNN
    (JAX ``XyloSim``, ``sim.py:126-257``): ``sim.reset_state(); out, state,
    rec = sim(spikes, record=True)`` with the hidden raster in
    ``rec["Spikes"]`` (micloc/xylo_snn_localization.py:358-377).

    Inputs are (T, N_in) as in JAX, or a batch (B, T, N_in) whose rows run
    side by side (the state then becomes (B, N)); the rasters come back in
    the input's layout.  The integers live on ``device`` (the card unless
    the caller asks for the CPU); inputs are moved there.
    """

    def __init__(self, config: XyloConfig, output_mode: str = "Spike", ordering: str = "decay_first",
                 reset: str = "subtract", device=None):
        if ordering not in ORDERINGS:
            raise ValueError(f"unknown ordering {ordering!r}")
        if reset not in RESETS:
            raise ValueError(f"unknown reset {reset!r}")
        self.config = config
        self.output_mode = output_mode
        self.ordering = ordering
        self.reset = reset
        self.dt = config.dt
        self.device = resolve_device(device)
        self._rec_coef, self._w_rec = held_recurrence(config.w_rec)
        self.reset_state()

    @classmethod
    def from_config(cls, config: XyloConfig, output_mode: str = "Spike", dt: Optional[float] = None,
                    device=None) -> "XyloSim":
        sim = cls(config, output_mode=output_mode, device=device)
        if dt is not None:
            sim.dt = dt
        return sim

    def reset_state(self) -> None:
        self._state = _zero_state(self.config.n_hidden, self.device)
        self._state_out = _zero_state(self.config.n_out, self.device)

    def _hidden(self, inp: torch.Tensor, record: bool, ordering: str, reset: str):
        spikes, _, self._state, rec = scan_hidden(
            inp, self.config.dash_syn, self.config.dash_mem, self.config.threshold, self._state,
            rec_coef=self._rec_coef, w_rec=self._w_rec, ordering=ordering, reset=reset, record_state=record)
        return spikes, rec

    def __call__(self, spikes_in, record: bool = False, record_power: bool = False):
        """Evolve the full network: ``(out, state, rec)`` with the hidden
        raster in ``rec["Spikes"]``, with ``record`` also ``rec["Isyn"]``
        and ``rec["Vmem"]``, with ``record_power`` the hidden synaptic
        input per step ``rec["synops"]`` (``Σ_n |inp|``); ``out`` is the
        readout layer's raster, through ``w_out`` with its own dashes and
        threshold and no recurrence (JAX ``sim.py:189-237``)."""
        x, back = _time_major(torch.as_tensor(spikes_in, device=self.device))
        inp = project_input(self.config, x)  # (T, [B,] N)
        spikes, rec_h = self._hidden(inp, record, self.ordering, self.reset)
        cfg = self.config
        out, _, self._state_out, _ = scan_hidden(
            int_matmul(spikes, cfg.w_out), cfg.dash_syn_out, cfg.dash_mem_out, cfg.threshold_out,
            self._state_out, ordering=self.ordering, reset=self.reset)
        rec: Dict[str, torch.Tensor] = {"Spikes": back(spikes)}
        rec.update({k: back(v) for k, v in rec_h.items()})
        if record_power:
            rec["synops"] = back(inp.abs().sum(dim=-1, dtype=torch.int32))
        return back(out), {"hidden": self._state, "out": self._state_out}, rec

    def evolve_to_hidden(self, spikes_hidden_in, record: bool = False):
        """Push currents straight into the hidden layer, bypassing ``w_in``
        (micloc/xylo_snn_localization_push_to_hidden.py:379).  Runs the
        default convention whatever the instance's ``ordering``/``reset``,
        as JAX's does (``sim.py:239-257``)."""
        x, back = _time_major(torch.as_tensor(spikes_hidden_in, device=self.device))
        spikes, rec_h = self._hidden(x.to(torch.int32), record, "decay_first", "subtract")
        rec = {"Spikes": back(spikes)}
        rec.update({k: back(v) for k, v in rec_h.items()})
        return rec["Spikes"], {"hidden": self._state}, rec


class XyloSimPushToHidden:
    """Two-population hidden simulator for the push-to-hidden deployment
    (JAX ``XyloSimPushToHidden``, ``sim.py:260-362``;
    micloc/xylo_snn_localization_push_to_hidden.py:221-273, 379).

    On the chip both LIF populations live in one hidden array with the
    block recurrent matrix ``[[0, W], [0, w_rec]]``; here stage 1 is scanned
    alone (no recurrent input reaches it), its spikes are delayed one step
    (the recurrent fabric acts on the previous step's spikes; the first
    step of a call uses the previous call's last stage-1 spikes, carried in
    the stage-1 state), projected through ``W = config.w_in`` in one
    product, and stage 2 scans with its own recurrence.  Input spikes enter
    stage 1 with the integer gain ``injection_weight``.
    """

    def __init__(self, config: XyloConfig, injection_weight: int, dash_syn_in, dash_mem_in, threshold_in,
                 device=None):
        self.config = config
        self.dt = config.dt
        self.n_stage1 = config.n_in
        self.n_stage2 = config.n_hidden
        self.device = resolve_device(device)
        self.injection_weight = int(injection_weight)
        self.dash_syn_in = np.asarray(dash_syn_in, np.int32)
        self.dash_mem_in = np.asarray(dash_mem_in, np.int32)
        self.threshold_in = np.asarray(threshold_in, np.int32)
        self._rec_coef, self._w_rec = held_recurrence(config.w_rec)
        self.reset_state()

    def block_config(self) -> XyloConfig:
        """The network as the chip holds it, one hidden layer of
        ``n_stage1 + n_stage2`` neurons: input through ``w_in = [g·I, 0]``
        (g the injection gain), the recurrence ``[[0, W], [0, w_rec]]``, the
        readout from stage 2.  A :class:`XyloSim` of it gives the raster of
        :meth:`evolve_to_hidden`."""
        cfg = self.config
        n1, n2 = self.n_stage1, self.n_stage2
        w_in = np.zeros((n1, n1 + n2), np.int32)
        w_in[:, :n1] = self.injection_weight * np.eye(n1, dtype=np.int32)
        w_rec = np.zeros((n1 + n2, n1 + n2), np.int32)
        w_rec[:n1, n1:] = cfg.w_in
        w_rec[n1:, n1:] = cfg.w_rec
        w_out = np.concatenate([np.zeros((n1, cfg.n_out), np.int32), np.asarray(cfg.w_out, np.int32)])
        cat = lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]).astype(np.int32)  # noqa: E731
        return XyloConfig(w_in=w_in, w_rec=w_rec, w_out=w_out, dash_syn=cat(self.dash_syn_in, cfg.dash_syn),
                          dash_mem=cat(self.dash_mem_in, cfg.dash_mem), dash_syn_out=cfg.dash_syn_out,
                          dash_mem_out=cfg.dash_mem_out, threshold=cat(self.threshold_in, cfg.threshold),
                          threshold_out=cfg.threshold_out, dt=cfg.dt, weight_scale=cfg.weight_scale)

    def reset_state(self) -> None:
        self._state1 = _zero_state(self.n_stage1, self.device)
        self._state2 = _zero_state(self.n_stage2, self.device)

    def evolve_to_hidden(self, spikes_in, record: bool = False):
        """Input raster (T, n_stage1), or a batch (B, T, n_stage1), → the
        full hidden raster (T, n_stage1 + n_stage2) in ``rec["Spikes"]``
        (and, with ``record``, ``Isyn``/``Vmem`` of both stages)."""
        x, back = _time_major(torch.as_tensor(spikes_in, device=self.device))
        inp1 = x.to(torch.int32) * self.injection_weight
        last_spk1 = self._state1[2]
        spk1, _, self._state1, rec1 = scan_hidden(
            inp1, self.dash_syn_in, self.dash_mem_in, self.threshold_in, self._state1, record_state=record)
        prev = torch.cat([last_spk1.expand(spk1.shape[1:])[None], spk1[:-1]])
        cfg = self.config
        spk2, _, self._state2, rec2 = scan_hidden(
            int_matmul(prev, cfg.w_in), cfg.dash_syn, cfg.dash_mem, cfg.threshold, self._state2,
            rec_coef=self._rec_coef, w_rec=self._w_rec, record_state=record)
        spikes = back(torch.cat([spk1, spk2], dim=-1))
        rec = {"Spikes": spikes}
        for k in rec1:
            rec[k] = back(torch.cat([rec1[k], rec2[k]], dim=-1))
        return spikes, {"stage1": self._state1, "stage2": self._state2}, rec


def sim_hidden_batch(config: XyloConfig, spikes_in_batch, ordering: str = "decay_first",
                     reset: str = "subtract", device=None) -> torch.Tensor:
    """Stateless batched evolve: (B, T, N_in) → hidden spikes (B, T, N_hid)
    int32 in the convention asked for (JAX ``sim_hidden_batch``,
    ``sim.py:365-401``): every row from a zero state, all rows in one scan,
    on ``device`` (the card unless the caller asks for the CPU); the raster
    is moved there."""
    x = torch.as_tensor(spikes_in_batch, device=resolve_device(device))
    rec_coef, w_rec = recurrence(config.w_rec)
    spikes, _, _, _ = scan_hidden(project_input(config, x.transpose(0, 1)), config.dash_syn, config.dash_mem,
                                  config.threshold, rec_coef=rec_coef, w_rec=w_rec, ordering=ordering, reset=reset)
    return spikes.transpose(0, 1)
