"""Device meshes and the Monte-Carlo accuracy harness (counterpart of
haghighatshoarmuir2024_tpu/parallel): data parallelism over the shards of a
mesh, one card, several cards, or one device named more than once."""
from .mesh import Mesh, device_scope, gather, make_mesh, pad_to_multiple, replicate_demo, split
from .montecarlo import (folded_angle_error, make_trial_fn, monte_carlo_sweep, snr_with_bandwidth_correction,
                         synthesize_batch)

__all__ = ["Mesh", "device_scope", "make_mesh", "split", "gather", "pad_to_multiple", "replicate_demo",
           "folded_angle_error", "make_trial_fn", "monte_carlo_sweep", "snr_with_bandwidth_correction",
           "synthesize_batch"]
