"""Stacks the executor built again in the window (its ``stack_rebuilds``
counter): a stack rebuilt while serving is a field evicted or patched."""


def read(w):
    return w.counters.get("stack_rebuilds")
