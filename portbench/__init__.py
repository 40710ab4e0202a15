"""The benchmark of ``pilosa_tpu_torch``: ``python3 -m portbench.run``
(see README.md). It imports neither JAX nor ``pilosa_tpu``."""
