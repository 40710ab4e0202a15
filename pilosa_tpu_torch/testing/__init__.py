"""In-process test harness (counterpart of ``pilosa_tpu/testing``): the
deterministic fault registry (``testing.faults``) and ``InProcessCluster``.

``InProcessCluster`` is exported lazily: the client and the fragment
files import ``testing.faults`` for their hook points, and an eager
import here would cycle back through ``server/node.py`` into the client.
"""

__all__ = ["InProcessCluster"]


def __getattr__(name):
    if name == "InProcessCluster":
        from pilosa_tpu_torch.testing.cluster import InProcessCluster

        return InProcessCluster
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
