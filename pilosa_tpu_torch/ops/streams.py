"""Side-stream uploads: pinned bounce buffers, and the ordering a tensor
made on one CUDA stream needs before another stream reads it.

The ingest uploader and the residency prefetcher (``ingest/pipeline.py``,
``server/prefetch.py``) copy host words to the card on a stream of their
own, so a copy overlaps the kernels the query dispatcher launches on the
device's default stream (the one stream every other thread of the process
runs on). Three hazards come with that, and this module holds the answer
to each:

* **Readers wait.** Work queued on a side stream is unordered with the
  default stream. Whoever publishes a tensor made there also publishes
  :func:`ready_event` (an event after its copy), and every reader calls
  :func:`use_here` first: the reader's stream waits for the event, and
  ``record_stream`` tells the caching allocator that the tensor's memory
  is in use on that stream too, so it is not handed out again while a
  kernel there may still read it. A side stream that reads a tensor made
  on the default stream marks it the same way, and orders itself after
  the default stream's queued work first (:func:`after_default`).
* **A pinned slot is refilled only after its copy.** :class:`PinnedStager`
  copies through a few pinned host buffers in turn, each chunk's copy
  followed by an event, and waits for a slot's event before it writes the
  slot again: a host memcpy into a slot whose DMA still runs would change
  bytes on their way to the card.
* **A stream belongs to a thread.** ``torch.cuda.stream(...)`` on the
  uploader thread changes that thread's current stream only; nothing
  orders work across threads but the events above.

:func:`staging` installs a stager for the calling thread:
``bitops.to_device`` then copies through it (:func:`current_stager`).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

# bytes a pinned slot holds; a larger copy goes through the slots in turn,
# the host fill of one chunk overlapping the DMA of the one before
SLOT_BYTES = 64 << 20

_tls = threading.local()


def current_stager():
    """The calling thread's :class:`PinnedStager`, or None."""
    return getattr(_tls, "stager", None)


@contextlib.contextmanager
def staging(stager):
    """Run the block on ``stager``'s side stream, with ``bitops.to_device``
    copying through its pinned slots (None: a no-op)."""
    if stager is None:
        yield None
        return
    prev = current_stager()
    _tls.stager = stager
    try:
        with torch.cuda.stream(stager.stream):
            after_default(stager.device)
            yield stager
    finally:
        _tls.stager = prev


def card(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _on_side_stream(dev: torch.device) -> bool:
    return torch.cuda.current_stream(dev) != torch.cuda.default_stream(dev)


def on_side_stream(device) -> bool:
    """Whether the calling thread's current stream on ``device`` is a side
    stream (False off the card)."""
    dev = torch.device(device)
    return dev.type == "cuda" and _on_side_stream(dev)


def ready_event(device):
    """An event after the work queued so far on the current stream when
    that is a side stream (what readers of a tensor made here must wait
    for); None on the default stream or off the card."""
    dev = torch.device(device)
    if dev.type != "cuda" or not _on_side_stream(dev):
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def use_here(t: torch.Tensor, ev=None) -> None:
    """Make ``t`` safe to read on the current stream: wait for ``ev`` (the
    event its side-stream copy published, if any) and mark the memory as
    in use on this stream for the caching allocator. On a side stream,
    also wait for the work queued so far on the default stream: it may
    have made ``t`` or written it in place since this stream last waited
    (a dispatcher's patch of a fragment's rows), and the caller holds the
    lock that orders that write before this read. A tensor made on the
    default stream and read there needs none of it. A stack laid over a
    serving mesh (``parallel/sharded.py``) is made safe slice by slice."""
    slices = getattr(t, "slices", None)
    if slices is not None:
        for part in slices:
            use_here(part, ev)
        return
    if t.device.type != "cuda":
        return
    cur = torch.cuda.current_stream(t.device)
    if ev is not None:
        cur.wait_event(ev)
    if cur != torch.cuda.default_stream(t.device):
        cur.wait_stream(torch.cuda.default_stream(t.device))
        t.record_stream(cur)
    elif ev is not None:
        t.record_stream(cur)


def after_default(device) -> None:
    """Order the current side stream after the work already queued on the
    device's default stream (tensors it writes may be read here)."""
    dev = torch.device(device)
    if dev.type == "cuda" and _on_side_stream(dev):
        torch.cuda.current_stream(dev).wait_stream(torch.cuda.default_stream(dev))


class PinnedStager:
    """A side stream and ``slots`` pinned bounce buffers of ``slot_bytes``
    each, for one uploader thread (not thread-safe: one thread uses it).

    :meth:`upload` copies host words to a new tensor on the card through
    the slots in turn: chunk ``k`` is written into its slot on the host
    (after that slot's previous copy finished) and copied with
    ``non_blocking=True`` on the side stream, an event after it. The caller
    publishes :func:`ready_event` with the tensor."""

    def __init__(self, device, slots: int = 2, slot_bytes: int = SLOT_BYTES):
        self.device = card(device)
        if self.device.type != "cuda":
            raise ValueError(f"PinnedStager: a CUDA device is needed, not {self.device}")
        self.stream = torch.cuda.Stream(self.device)
        self.slot_bytes = max(1, int(slot_bytes))
        self._bufs: list = [None] * max(1, int(slots))
        self._events: list = [None] * len(self._bufs)
        self._next = 0
        self.chunks = 0
        self.bytes = 0
        # chunks that found their slot's previous copy still running
        self.slot_waits = 0

    @property
    def slots(self) -> int:
        return len(self._bufs)

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """``int32`` host words -> a new ``int32`` tensor of the same shape
        on the card, copied on the side stream (the current stream must be
        ``self.stream``)."""
        arr = np.ascontiguousarray(arr, dtype=np.int32)
        out = torch.empty(arr.shape, dtype=torch.int32, device=self.device)
        flat = arr.reshape(-1).view(np.uint8)
        n = flat.size
        if n == 0:
            return out
        dst = out.view(-1).view(torch.uint8)
        stream = torch.cuda.current_stream(self.device)
        off = 0
        while off < n:
            k = min(self.slot_bytes, n - off)
            i = self._next
            self._next = (i + 1) % len(self._bufs)
            ev = self._events[i]
            if ev is not None and not ev.query():
                self.slot_waits += 1
                ev.synchronize()  # the slot's previous DMA has read it all
            buf = self._bufs[i]
            if buf is None:
                buf = self._bufs[i] = torch.empty(
                    self.slot_bytes, dtype=torch.uint8, pin_memory=True
                )
            buf.numpy()[:k] = flat[off : off + k]
            dst[off : off + k].copy_(buf[:k], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
            self._events[i] = ev
            self.chunks += 1
            self.bytes += k
            off += k
        return out

    def snapshot(self) -> dict:
        return {
            "slots": self.slots,
            "slotBytes": self.slot_bytes,
            "chunks": self.chunks,
            "bytes": self.bytes,
            "slotWaits": self.slot_waits,
        }
