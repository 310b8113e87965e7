"""K2 rounds a batch, from the port's launch counter
(``ops/cuda/_build.launch_counts``): each round after the first is one more
host read of K2's flags."""


def read(view):
    n = view.launches.get("rzcc_k2", 0)
    return n / view.calls if view.calls and n else None
