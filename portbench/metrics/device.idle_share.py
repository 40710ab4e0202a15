"""Percent of the traced window in which no kernel ran on the device: one
less the union of the trace's kernel intervals over the seconds traced.
Copies and fills (``Memcpy``, ``Memset``) are not kernels and count as
idle here; the run's ``busy_s`` and ``breakdown`` hold them."""


def read(w):
    if not w.kernel_busy_s or not w.traced_s:
        return None
    return 100.0 * (1.0 - w.kernel_busy_s / w.traced_s)
