"""Network specification + mapper for Xylo™-class deployment.

The reference builds a rockpool ``Sequential(LinearTorch → LIFTorch(has_rec)
→ LinearTorch → LIFTorch)`` network, maps it with ``mapper`` and quantizes with
``global_quantize`` (micloc/xylo_snn_localization.py:239-284).  Since this
framework is torch/rockpool-free, the network is described directly by a float
``XyloSpec`` (the information content of rockpool's mapped specification dict)
and built by :func:`build_localization_spec` from the per-band beamforming
matrices — block-diagonal input weights, ±stacking for bipolar spikes, uniform
negative recurrence, all-ones readout (micloc/xylo_snn_localization.py:195-266).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class XyloSpec:
    """Float-level network spec (pre-quantization).

    Weight layout: ``w_in (N_in, N_hid)``, ``w_rec (N_hid, N_hid)``,
    ``w_out (N_hid, N_out)``.  Taus are per hidden neuron; the output layer
    reuses the first hidden tau (micloc/xylo_snn_localization.py:259-265).
    """

    w_in: np.ndarray
    w_rec: np.ndarray
    w_out: np.ndarray
    tau_syn: np.ndarray
    tau_mem: np.ndarray
    threshold: np.ndarray  # per hidden neuron
    threshold_out: np.ndarray  # per output neuron
    tau_syn_out: np.ndarray
    tau_mem_out: np.ndarray
    dt: float

    @property
    def n_in(self) -> int:
        return self.w_in.shape[0]

    @property
    def n_hidden(self) -> int:
        return self.w_in.shape[1]

    @property
    def n_out(self) -> int:
        return self.w_out.shape[1]


def build_localization_spec(
    bf_mats: Sequence[np.ndarray],
    tau_vecs: Sequence[Tuple[float, float]],
    fs: float,
    target_dt: float = 1e-3,
    bipolar_spikes: bool = True,
    threshold: float = 1.0,
    w_rec_coef: Optional[float] = None,
) -> XyloSpec:
    """Assemble the 2-layer localization SNN from per-band beamforming matrices.

    Mirrors ``Demo._initialize_snn_module`` (micloc/xylo_snn_localization.py:173-266):

    * taus are rescaled by ``fs / (1/target_dt)`` (:183-188) — the spike trains
      sampled at ``fs`` are fed to the SNN core as if one sample per ``dt``;
    * the input weight is block-diagonal over frequency bands with the per-band
      ``bf_mat`` blocks (:195-208);
    * bipolar spikes double the input channels with ``[W; -W]`` (:210-216);
    * hidden recurrence is the uniform DC-cancelling matrix
      ``-0.1/num_ch_out · ones`` (:230-232);
    * readout is all-ones into one output LIF neuron (:254-265).
    """
    bf_mats = [np.asarray(m, dtype=np.float64) for m in bf_mats]
    num_freq_chan = len(bf_mats)
    spike_dim_in_chan, spike_dim_out_chan = bf_mats[0].shape

    num_ch_in = num_freq_chan * spike_dim_in_chan
    num_ch_out = num_freq_chan * spike_dim_out_chan

    weight = np.zeros((num_ch_in, num_ch_out))
    for ch in range(num_freq_chan):
        weight[
            ch * spike_dim_in_chan : (ch + 1) * spike_dim_in_chan,
            ch * spike_dim_out_chan : (ch + 1) * spike_dim_out_chan,
        ] = bf_mats[ch]

    if bipolar_spikes:
        weight = np.vstack([weight, -weight])

    # rescale taus to the SNN core clock (micloc/xylo_snn_localization.py:183-188)
    target_fs = 1.0 / target_dt
    scale = fs / target_fs
    tau_syn = np.concatenate(
        [np.full(spike_dim_out_chan, ts * scale) for ts, _ in tau_vecs]
    )
    tau_mem = np.concatenate(
        [np.full(spike_dim_out_chan, tm * scale) for _, tm in tau_vecs]
    )

    if w_rec_coef is None:
        w_rec_coef = -0.1 / num_ch_out
    w_rec = w_rec_coef * np.ones((num_ch_out, num_ch_out))

    w_out = np.ones((num_ch_out, 1))

    return XyloSpec(
        w_in=weight,
        w_rec=w_rec,
        w_out=w_out,
        tau_syn=tau_syn,
        tau_mem=tau_mem,
        threshold=np.full(num_ch_out, threshold),
        threshold_out=np.full(1, float(threshold)),
        tau_syn_out=tau_syn[:1].copy(),
        tau_mem_out=tau_mem[:1].copy(),
        dt=target_dt,
    )


def truncate_fan_out(weight: np.ndarray, max_fan_out: int = 63) -> np.ndarray:
    """Per-row fan-out truncation, bug-compatible with the reference.

    The push-to-hidden variant zeroes every weight with ``|w| <= thre`` where
    ``thre`` is the ``max_fan_out``-th largest |w| of the row
    (micloc/xylo_snn_localization_push_to_hidden.py:184-187 for w_in,
    :213-218 for w_rec).  Quirks reproduced exactly:

    * the threshold entry itself is zeroed (``<=``), so a row with distinct
      magnitudes keeps only ``max_fan_out - 1`` entries;
    * ties at the threshold are all zeroed — a row whose magnitudes are all
      equal (e.g. the uniform DC-cancelling ``w_rec``) is zeroed ENTIRELY.

    Rows narrower than ``max_fan_out`` already satisfy the hardware limit and
    are returned unchanged (the reference would index out of bounds there; it
    never hits that case).
    """
    weight = np.array(weight, dtype=np.float64, copy=True)
    n_rows, n_cols = weight.shape
    if n_cols < max_fan_out:
        return weight
    thre = np.sort(np.abs(weight), axis=1)[:, -max_fan_out].reshape(-1, 1)
    weight[np.abs(weight) <= thre] = 0.0
    return weight
