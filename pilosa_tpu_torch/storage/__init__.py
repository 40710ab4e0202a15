"""Host-side storage (counterpart of ``pilosa_tpu/storage``): the roaring
codec, the per-fragment snapshot and op-log files, the key-translation
log and the on-disk holder directory tree (reference: roaring
serialization roaring/roaring.go:1044-1126 and op log :4415-4610,
fragment persistence fragment.go:311-456, holder tree holder.go:134-198).

Storage never touches the device: fragments snapshot from their host
mirrors, and a reopened fragment's file is decoded into its host mirror,
which syncs to the card at the first read."""
