"""Percent of its roofline the ``bsi_range`` kernel reached in the window:
the least time of its launches (the bytes of their operands at the
card's peak, ``roofline.py``) over its device time in the trace."""


def read(w):
    return w.roofline("bsi_range")
