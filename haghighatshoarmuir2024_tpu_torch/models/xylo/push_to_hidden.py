"""Push-to-hidden deployment (counterpart of
``haghighatshoarmuir2024_tpu/models/xylo/push_to_hidden.py``; reference:
micloc/xylo_snn_localization_push_to_hidden.py).

The reference works around Xylo-A2's 16-input-channel limit by deploying the
encoder's spike channels as hidden neurons,

    Linear(1→n_in, dummy zeros) → LIF(n_in) → Linear(weight) →
    LIF(n_out, rec=w_rec) → Linear(ones) → LIF(1)

(reference :221-273), and pushes the input spikes straight into the hidden
layer (``_evolve_to_hidden``, :379).  Against :class:`~.pipeline.Demo`:

* an input-side LIF stage filters the raw RZCC spikes before the
  beamforming projection, with the first band's taus (reference :231-233);
* under hardware constraints both ``weight`` (:181-187) and ``w_rec``
  (:213-218) are fan-out-truncated with the reference's ``<= thre`` rule,
  which zeroes the uniform DC-cancelling ``w_rec`` entirely
  (:func:`..spec.truncate_fan_out`);
* the injection gain and the stage-1 threshold are one quantized unit of
  the global scale (the hardware's injection weight is not documented);
* :meth:`DemoPushToHidden.xylo_process` returns the stage-2 (DoA-grid)
  slice, the columns ``extract_rate`` is defined over.
"""
from __future__ import annotations

import numpy as np
import torch

from .pipeline import Demo
from .quantize import global_quantize, tau_to_dash, validate_config
from .sim import XyloSimPushToHidden
from .spec import build_localization_spec, truncate_fan_out


class DemoPushToHidden(Demo):
    """Demo whose spikes enter the chip through an input-side LIF stage."""

    MAX_FAN_OUT = 63

    def __init__(self, *args, hardware_constraints: bool = True, **kwargs):
        # ``not xylosim_version`` in the reference: run_demo deploys with the
        # truncation active (micloc/xylo_snn_localization_push_to_hidden.py:678)
        self.hardware_constraints = hardware_constraints
        super().__init__(*args, **kwargs)

    def _initialize_snn_module(self, target_dt: float) -> None:
        self.spec = build_localization_spec(
            bf_mats=self.bf_mats,
            tau_vecs=[tuple(tv) for tv in self.tau_vecs],
            fs=self.fs,
            target_dt=target_dt,
            bipolar_spikes=self.bipolar_spikes,
            threshold=1.0,
        )
        if self.hardware_constraints:
            self.spec.w_in = truncate_fan_out(self.spec.w_in, self.MAX_FAN_OUT)
            self.spec.w_rec = truncate_fan_out(self.spec.w_rec, self.MAX_FAN_OUT)
        self.xylo_config = global_quantize(self.spec)
        problems = validate_config(self.xylo_config, enforce_fan_out=self.hardware_constraints)
        if problems:
            raise ValueError("invalid push-to-hidden configuration: " + "; ".join(problems))

        n_in = self.xylo_config.n_in
        unit = max(int(round(1.0 * self.xylo_config.weight_scale)), 1)
        self.xylo = XyloSimPushToHidden(
            self.xylo_config,
            injection_weight=unit,
            dash_syn_in=tau_to_dash(np.full(n_in, self.spec.tau_syn[0]), target_dt),
            dash_mem_in=tau_to_dash(np.full(n_in, self.spec.tau_mem[0]), target_dt),
            threshold_in=np.full(n_in, unit, np.int32),
            device=self.device,
        )

    def xylo_process(self, spikes_in) -> torch.Tensor:
        """Input raster (T, n_in), or (B, T, n_in), → the stage-2 hidden
        raster (T, n_hidden) (or batched) from a reset simulator
        (micloc/xylo_snn_localization_push_to_hidden.py:364-384)."""
        self.xylo.reset_state()
        spikes, _, _ = self.xylo.evolve_to_hidden(spikes_in)
        return spikes[..., self.xylo.n_stage1:]
