"""Device ms a stream step in the encode."""
from hmbench.layers import per_call_ms

# the encode: the STHT FIR's GEMMs (cuBLAS) and the lifted IIR's kernels (csrc/iir_lifted.cu)
PATTERN = r"gemm|xmma|cutlass|superblock_kernel|increments_kernel|recurrence_kernel|assemble_kernel"


def read(view):
    return per_call_ms(view, PATTERN)
