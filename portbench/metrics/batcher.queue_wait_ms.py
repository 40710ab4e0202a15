"""Mean milliseconds a query waited in the batcher's queue in the window,
from enqueue to its flight's dispatch (the flight slots' ``queue_wait``,
the time the ``batcher.queueWait`` annotation reports)."""


def read(w):
    waits = [q for _, ws in w.flights for q in ws]
    return 1e3 * sum(waits) / len(waits) if waits else None
