"""Device ms a step of host-to-device copies: the chunk's upload."""


def read(view):
    us = sum(d for _, n, _, d in view.copies if "HtoD" in n)
    return us / 1e3 / view.calls / view.devices if view.calls and us else None
