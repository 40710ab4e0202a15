"""Milliseconds of the executor's ``executor.Execute`` and
``executor.ExecuteBatch`` spans in the window (one inside another counted
once) per query answered."""


def read(w):
    n = w.answered
    return 1e3 * w.outermost_seconds("executor.Execute", "executor.ExecuteBatch") / n if n else None
