"""Milliseconds of the GroupBy engine's ``executor.groupByBatch`` and
``executor.groupByKLevel`` spans in the window per request that holds a
GroupBy."""


def read(w):
    n = w.requests_holding("GroupBy(")
    return 1e3 * sum(w.durations("executor.groupByBatch", "executor.groupByKLevel")) / n if n else None
