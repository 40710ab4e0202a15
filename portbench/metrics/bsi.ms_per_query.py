"""Milliseconds of the executor's ``executor.batchBSI`` spans in the
window per request that holds a Sum."""


def read(w):
    n = w.requests_holding("Sum(")
    return 1e3 * sum(w.durations("executor.batchBSI")) / n if n else None
