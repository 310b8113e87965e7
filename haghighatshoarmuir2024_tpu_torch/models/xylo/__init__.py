"""Quantized Xylo-class SNN localizer (counterpart of
haghighatshoarmuir2024_tpu/models/xylo)."""
from .pipeline import Demo
from .quantize import XyloConfig, global_quantize, tau_to_dash, validate_config
from .spec import XyloSpec, build_localization_spec

__all__ = [
    "Demo", "XyloConfig", "XyloSpec", "build_localization_spec", "global_quantize",
    "tau_to_dash", "validate_config",
]
