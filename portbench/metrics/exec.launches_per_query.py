"""Kernel launches (``ops/kernels.LAUNCHES``, every kernel) in the window
per query answered."""


def read(w):
    n = w.answered
    return sum(w.launches.values()) / n if n else None
