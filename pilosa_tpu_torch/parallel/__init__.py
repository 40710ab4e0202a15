"""Process-level placement of the port's nodes (counterpart of
``pilosa_tpu/parallel``): ``meshplace`` only."""
