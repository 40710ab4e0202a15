"""Device-resident ingest pipeline (counterpart of ``pilosa_tpu/ingest``).

Replaces the lock-step import path (decode -> apply -> device sync,
serialized per batch) with a staged pipeline in the tf.data shape —
overlap the transfer with the compute so neither side ever waits for
the whole of the other:

  decode (zero-copy native Roaring -> reusable staging buffer)
    -> coalesced fragment apply (bounded import pool, same-fragment
       jobs group-committed into one merged apply)
    -> double-buffered host->device upload on the uploader's own CUDA
       stream through pinned slots (batch N+1's upload overlaps batch
       N's apply)

Every stage is bounded, so backpressure propagates stage-by-stage back
to the HTTP client instead of queueing unboundedly.
"""

from pilosa_tpu_torch.ingest.pipeline import DeviceUploader, IngestPipeline
from pilosa_tpu_torch.ingest.staging import StagingBuffer, StagingPool

__all__ = [
    "DeviceUploader",
    "IngestPipeline",
    "StagingBuffer",
    "StagingPool",
]
