"""Device ms a batch in the estimate."""
from hmbench.layers import per_call_ms

PATTERN = r"matched_kernel|ArgMax"  # the matched scores (csrc/matched.cu) and the argmax


def read(view):
    return per_call_ms(view, PATTERN)
