"""Seeded, deterministic open-loop load generation (counterpart of
``pilosa_tpu/loadgen``; the SLO plane's workload half — see obs/slo.py for
the measurement half and ``python -m pilosa_tpu_torch.loadgen`` for the
command line)."""

from pilosa_tpu_torch.loadgen.harness import (
    LoadHarness,
    StageSpec,
    prepare_schema,
    preload,
    run_harness,
)
from pilosa_tpu_torch.loadgen.report import (
    SCHEMA,
    build_report,
    next_report_path,
    validate_report,
)
from pilosa_tpu_torch.loadgen.workload import (
    DEFAULT_MIX,
    OP_CLASS,
    Op,
    WorkloadConfig,
    WorkloadGenerator,
    Zipf,
    fingerprint,
)

__all__ = [
    "DEFAULT_MIX",
    "LoadHarness",
    "OP_CLASS",
    "Op",
    "SCHEMA",
    "StageSpec",
    "WorkloadConfig",
    "WorkloadGenerator",
    "Zipf",
    "build_report",
    "fingerprint",
    "next_report_path",
    "prepare_schema",
    "preload",
    "run_harness",
    "validate_report",
]
