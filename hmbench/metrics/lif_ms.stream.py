"""Device ms a stream step in the LIF (the pack pass and K4)."""
from hmbench.layers import per_call_ms

# the LIF: the pack pass and K3 (a batch) or K4 (a stream step), csrc/lif.cu
PATTERN = r"lif_pack_bipolar_kernel|lif_count_bipolar_kernel|lif_count_stateful_bipolar_kernel"


def read(view):
    return per_call_ms(view, PATTERN)
