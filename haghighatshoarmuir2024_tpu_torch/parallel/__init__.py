"""The Monte-Carlo accuracy harness on one GPU (counterpart of
haghighatshoarmuir2024_tpu/parallel; the mesh and sharding are not ported)."""
from .montecarlo import (folded_angle_error, make_trial_fn, monte_carlo_sweep, snr_with_bandwidth_correction,
                         synthesize_batch)

__all__ = ["folded_angle_error", "make_trial_fn", "monte_carlo_sweep", "snr_with_bandwidth_correction",
           "synthesize_batch"]
