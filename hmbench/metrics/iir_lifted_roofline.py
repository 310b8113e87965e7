"""``iir_lifted``'s share (%) of its bytes bound: x in and the integrated z
out, 8 bytes a sample and channel, for each band."""
from hmbench import roofline
from hmbench.layers import roofline_pct

PATTERN = r"superblock_kernel|increments_kernel|recurrence_kernel|assemble_kernel"


def read(view):
    s = view.shape
    ops, nbytes = roofline.iir_lifted_work(s["T"], s["B"], 2 * s["M"])
    return roofline_pct(view, PATTERN, s["F"] * roofline.bound_s(ops, "fp32_flops_per_s", nbytes))
