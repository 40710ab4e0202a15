"""Node runtime on one node: the programmatic API (reference api.go), the
HTTP transport (reference http/handler.go) and the node's composition
root (reference server.go); counterpart of ``pilosa_tpu/server``."""
