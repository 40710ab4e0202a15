"""Observability: stats, events, jobs, tracing, the trace store, SLOs,
query profiles, the device cost ledger and system facts (counterpart of
``pilosa_tpu/obs``; reference: stats/, tracing/, prometheus/, statsd/,
gopsutil/)."""
