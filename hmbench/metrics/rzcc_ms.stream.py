"""Device ms a stream step in RZCC (K1, K2 on the seam's window)."""
from hmbench.layers import per_call_ms

PATTERN = r"rzcc_k1_kernel|rzcc_k2_kernel"  # RZCC: K1 and every K2 round (csrc/suppress.cu)


def read(view):
    return per_call_ms(view, PATTERN)
