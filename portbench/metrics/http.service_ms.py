"""Median milliseconds of the node's ``http.query`` spans in the window:
the HTTP layer's service time, from parse to the answer written."""

import statistics


def read(w):
    d = w.durations("http.query")
    return statistics.median(d) * 1e3 if d else None
