"""K3's share (%) of its bound: 10 int32 operations a neuron and step and
one a set input bit and neuron (the set bits counted by the reference from
the same inputs, the pool's mean a call) over P1's int32 peak, or its bytes
over the memory rate where that is larger."""
from hmbench import roofline
from hmbench.layers import roofline_pct

PATTERN = r"lif_count_bipolar_kernel"


def read(view):
    if view.nnz is None:
        return None
    s = view.shape
    ops, nbytes = roofline.lif_work(view.nnz, s["T"], s["B"], s["N"], 2 * s["C"])
    return roofline_pct(view, PATTERN, roofline.bound_s(ops, "int32_ops_per_s", nbytes))
