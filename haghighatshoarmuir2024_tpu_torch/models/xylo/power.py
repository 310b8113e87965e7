"""Neuromorphic energy estimate (counterpart of
``haghighatshoarmuir2024_tpu/models/xylo/power.py``), in place of the
reference's board measurement ``run_power_measurement``
(micloc/xylo_snn_localization.py:544-682): an operation census (synaptic
events, neuron updates, spike events) times per-event energies, plus a
static floor.  The defaults follow the published Xylo-A2 characterization
(Bos & Muir 2022: an idle floor of about 220 µW at 6.25 MHz).

The census counts integers on the rasters' device in int64 and returns
Python floats, as JAX's numpy sums do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-event energy coefficients (Joules) and static power (Watts)."""

    e_synop: float = 8.0e-12  # per synaptic event (weight add into isyn)
    e_neuron_update: float = 2.0e-12  # per neuron per timestep (decay + compare)
    e_spike: float = 5.0e-12  # per emitted spike (reset + routing)
    p_static: float = 220e-6  # idle power floor of the core


def _fan_out(w, device) -> torch.Tensor:
    return torch.as_tensor(np.count_nonzero(np.asarray(w), axis=1), dtype=torch.int64, device=device)


def count_operations(config, spikes_in, hidden_spikes) -> Dict[str, float]:
    """Operation census of one inference, (T, n_in) input and (T, n_hidden)
    hidden rasters (JAX ``count_operations``): each input spike activates
    the nonzero fan-out of its channel, each hidden spike the nonzero
    recurrent and readout fan-out of its neuron."""
    s_in = torch.as_tensor(spikes_in)
    hidden = torch.as_tensor(hidden_spikes, device=s_in.device)
    dev = s_in.device
    in_per_ch = s_in.to(torch.int64).abs().sum(dim=0)
    hid_per_n = hidden.to(torch.int64).abs().sum(dim=0)
    synops_in = float((in_per_ch * _fan_out(config.w_in, dev)).sum())
    synops_rec = float((hid_per_n * _fan_out(config.w_rec, dev)).sum())
    synops_out = float((hid_per_n * _fan_out(config.w_out, dev)).sum())
    T = s_in.shape[0]
    return {
        "timesteps": float(T),
        "synops_in": synops_in,
        "synops_rec": synops_rec,
        "synops_out": synops_out,
        "synops_total": synops_in + synops_rec + synops_out,
        "neuron_updates": float(T * (config.n_hidden + config.n_out)),
        "spike_events": float(hid_per_n.sum()),
    }


def estimate_power(config, spikes_in, hidden_spikes, audio_duration: float,
                   model: EnergyModel = EnergyModel()) -> Dict[str, float]:
    """Energy and average power of one inference over ``audio_duration``
    seconds at real time: the census, the dynamic energy by kind (J) and
    the average power (W, µW) (JAX ``estimate_power``; the reference's
    per-rail µW report, micloc/xylo_snn_localization.py:671-682)."""
    ops = count_operations(config, spikes_in, hidden_spikes)
    e_syn = ops["synops_total"] * model.e_synop
    e_neu = ops["neuron_updates"] * model.e_neuron_update
    e_spk = ops["spike_events"] * model.e_spike
    e_dyn = e_syn + e_neu + e_spk
    p_avg = e_dyn / audio_duration + model.p_static
    return {
        **ops,
        "energy_synaptic_J": e_syn,
        "energy_neuron_J": e_neu,
        "energy_spike_J": e_spk,
        "energy_dynamic_J": e_dyn,
        "power_avg_W": p_avg,
        "power_avg_uW": p_avg * 1e6,
    }
