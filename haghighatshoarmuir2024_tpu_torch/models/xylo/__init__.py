"""Quantized Xylo-class SNN localizer (counterpart of
haghighatshoarmuir2024_tpu/models/xylo): the float network spec, global
quantization, Xylo-A2 constraint checks, the integer simulator, the
standard and push-to-hidden deployments and the energy estimate."""
from .pipeline import Demo
from .power import EnergyModel, count_operations, estimate_power
from .push_to_hidden import DemoPushToHidden
from .quantize import XyloConfig, dash_to_tau, global_quantize, tau_to_dash, validate_config
from .sim import XyloSim, sim_hidden_batch
from .spec import XyloSpec, build_localization_spec, truncate_fan_out

XyloLocalizer = Demo  # the JAX package's descriptive alias

__all__ = [
    "Demo", "DemoPushToHidden", "EnergyModel", "XyloConfig", "XyloLocalizer", "XyloSim", "XyloSpec",
    "build_localization_spec", "count_operations", "dash_to_tau", "estimate_power", "global_quantize",
    "sim_hidden_batch", "tau_to_dash", "truncate_fan_out", "validate_config",
]
