"""Queries a flight of the batcher carried in the window: the members of
each dispatch, read from the flight slots, over the dispatches."""


def read(w):
    if not w.flights:
        return None
    return sum(n for n, _ in w.flights) / len(w.flights)
