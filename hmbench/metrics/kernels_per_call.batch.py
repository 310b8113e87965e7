"""CUPTI kernel records a call of ``Demo.forward_batch``: the launches the
entry makes (hand kernels and PyTorch's own), which the host's launch work
scales with."""


def read(view):
    return view.kernel_count() / view.calls if view.calls else None
