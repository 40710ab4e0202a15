"""Wire encoding of query results for node-to-node fan-out
(counterpart of ``pilosa_tpu/cluster/wire.py``; reference:
encoding/proto/proto.go QueryResult union, internal/public.proto:72-82).

The reference tags each result with a type id and protobuf-encodes it;
this build tags each result with a type string and JSON-encodes it. Row
bitmaps travel as raw little-endian uint32 words per shard segment
(base64), which keeps the coordinator's reduce step a pure bitwise merge;
ids materialize only at the API edge, like the reference. The port's
``Row`` segments are host numpy words (an ``int32`` view of a fragment's
words included); they travel as their ``uint32`` bytes, the same bytes a
JAX node sends, and decode to host ``uint32`` numpy segments.
"""

from __future__ import annotations

import base64
from typing import Any

import numpy as np

from pilosa_tpu_torch.exec.result import (
    FieldRow,
    GroupCount,
    Pair,
    Row,
    RowIdentifiers,
    ValCount,
)


def u32_words(seg) -> np.ndarray:
    """A row segment as ``uint32`` words: an ``int32`` view is
    reinterpreted bit for bit, never converted by value."""
    a = np.asarray(seg)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a.astype(np.uint32, copy=False)


def encode_result(result: Any) -> Any:
    if isinstance(result, Row):
        return {
            "type": "row",
            "segments": {
                str(shard): base64.b64encode(u32_words(seg).tobytes()).decode()
                for shard, seg in result.segments.items()
            },
        }
    if isinstance(result, ValCount):
        return {"type": "valcount", "value": result.value, "count": result.count}
    if isinstance(result, Pair):
        return {"type": "pair", "id": result.id, "key": result.key, "count": result.count}
    if isinstance(result, RowIdentifiers):
        return {"type": "rowids", "rows": result.rows, "keys": result.keys}
    if isinstance(result, GroupCount):
        return {
            "type": "groupcount",
            "group": [
                {"field": g.field, "rowID": g.row_id, "rowKey": g.row_key}
                for g in result.group
            ],
            "count": result.count,
        }
    if isinstance(result, list):
        return {"type": "list", "items": [encode_result(r) for r in result]}
    if isinstance(result, (bool, int, str)) or result is None:
        return {"type": "scalar", "value": result}
    if isinstance(result, np.integer):
        return {"type": "scalar", "value": int(result)}
    raise TypeError(f"unencodable wire result: {type(result)!r}")


def decode_result(obj: Any) -> Any:
    t = obj["type"]
    if t == "row":
        segments = {}
        for shard, b in obj["segments"].items():
            words = np.frombuffer(base64.b64decode(b), dtype=np.uint32)
            segments[int(shard)] = words.copy()  # writable, as a local row's
        return Row(segments)
    if t == "valcount":
        return ValCount(value=obj["value"], count=obj["count"])
    if t == "pair":
        return Pair(id=obj.get("id") or 0, key=obj.get("key"), count=obj["count"])
    if t == "rowids":
        return RowIdentifiers(rows=obj.get("rows") or [], keys=obj.get("keys"))
    if t == "groupcount":
        return GroupCount(
            group=[
                FieldRow(
                    field=g["field"],
                    row_id=g.get("rowID") or 0,
                    row_key=g.get("rowKey"),
                )
                for g in obj["group"]
            ],
            count=obj["count"],
        )
    if t == "list":
        return [decode_result(r) for r in obj["items"]]
    if t == "scalar":
        return obj["value"]
    raise TypeError(f"unknown wire result type: {t!r}")


def encode_results(results: list[Any]) -> list[Any]:
    return [encode_result(r) for r in results]


def decode_results(results: list[Any]) -> list[Any]:
    return [decode_result(r) for r in results]


# ---------------------------------------------------------------------------
# Binary import payloads (node->node forwarded slices)
# ---------------------------------------------------------------------------
#
# The reference protobuf-encodes every import (encoding/proto/proto.go,
# internal/public.proto:72-82 ImportRequest); JSON int lists are ~15-20
# bytes per value. Here a translated bit-import slice rides as per-shard
# roaring blobs of row*width+offset positions (the fragment's own
# position arithmetic, reference fragment.go:3077-3080) behind a small
# JSON header, and a value-import slice as raw little-endian column and
# value arrays. Key-carrying or timestamped requests stay JSON — they
# are control-plane-sized.

IMPORT_MAGIC = b"PTI1"

# rows whose positions would overflow u64 position arithmetic fall back
# to JSON (the roaring position space is row*width + offset)
_MAX_POS = 2**63


def encode_import(req: dict, width: int | None = None) -> bytes | None:
    """Binary body for a translated import request, or None when the
    request is not binary-eligible (keys, timestamps, missing width)."""
    import json as _json

    from pilosa_tpu_torch.storage import roaring

    if req.get("timestamps") is not None:
        return None
    if "rowKeys" in req or "columnKeys" in req:
        return None
    width = width or req.get("_width")
    cols = req.get("columnIDs")
    if cols is None:
        return None
    cols = np.asarray(cols, dtype=np.uint64)
    clear = bool(req.get("clear"))

    remote = bool(req.get("remote"))
    values = req.get("values")
    if values is not None:
        values = np.asarray(values, dtype=np.int64)
        header = {
            "kind": "values", "clear": clear, "remote": remote,
            "n": int(len(cols)),
        }
        hjson = _json.dumps(header).encode()
        return b"".join(
            [
                IMPORT_MAGIC,
                len(hjson).to_bytes(4, "little"),
                hjson,
                cols.astype("<u8").tobytes(),
                values.astype("<i8").tobytes(),
            ]
        )

    rows = req.get("rowIDs")
    if rows is None or width is None:
        return None
    rows = np.asarray(rows, dtype=np.uint64)
    if len(rows) and int(rows.max()) >= _MAX_POS // width:
        return None  # position arithmetic would overflow; JSON fallback
    offs = cols % np.uint64(width)
    shards = cols // np.uint64(width)
    blobs: list[bytes] = []
    shard_meta: list[dict] = []
    for s in np.unique(shards):
        m = shards == s
        positions = np.unique(rows[m] * np.uint64(width) + offs[m])
        blob = roaring.serialize(positions)
        shard_meta.append({"s": int(s), "len": len(blob)})
        blobs.append(blob)
    header = {
        "kind": "bits",
        "clear": clear,
        "remote": remote,
        "width": int(width),
        "shards": shard_meta,
    }
    hjson = _json.dumps(header).encode()
    return b"".join(
        [IMPORT_MAGIC, len(hjson).to_bytes(4, "little"), hjson] + blobs
    )


# ---------------------------------------------------------------------------
# Migration frames (online resize: snapshot chunks + op-log deltas)
# ---------------------------------------------------------------------------
#
# Same shape as the import payload: magic + 4-byte LE header length +
# JSON header + raw blob.  The blob is either a slice of a serialized
# roaring snapshot (chunk) or concatenated op-log records (delta) —
# both already self-framing, so the header only carries bookkeeping
# (offset / op counts) the receiver needs without parsing the blob.

MIGRATE_MAGIC = b"PTM1"


def encode_migrate_frame(header: dict, blob: bytes = b"") -> bytes:
    import json as _json

    hjson = _json.dumps(header).encode()
    return b"".join(
        [MIGRATE_MAGIC, len(hjson).to_bytes(4, "little"), hjson, blob]
    )


def decode_migrate_frame(body: bytes) -> tuple[dict, bytes]:
    import json as _json

    if body[:4] != MIGRATE_MAGIC:
        raise ValueError("bad migrate frame magic")
    hlen = int.from_bytes(body[4:8], "little")
    header = _json.loads(body[8 : 8 + hlen].decode())
    return header, body[8 + hlen :]


def decode_import(body: bytes) -> dict:
    """Binary import body -> the same request dict shape the JSON path
    produces (numpy arrays instead of lists; always marked remote)."""
    import json as _json

    from pilosa_tpu_torch.storage import roaring

    if body[:4] != IMPORT_MAGIC:
        raise ValueError("bad import payload magic")
    hlen = int.from_bytes(body[4:8], "little")
    header = _json.loads(body[8 : 8 + hlen].decode())
    off = 8 + hlen
    clear = bool(header.get("clear"))
    # the remote marker comes from the SENDER (a forwarding node sets
    # it); a public binary ingest without it still goes through cluster
    # shard routing like the JSON path
    remote = bool(header.get("remote"))
    if header["kind"] == "values":
        n = header["n"]
        cols = np.frombuffer(body, dtype="<u8", count=n, offset=off)
        values = np.frombuffer(
            body, dtype="<i8", count=n, offset=off + 8 * n
        )
        return {
            "columnIDs": cols.astype(np.uint64),
            "values": values.astype(np.int64),
            "clear": clear,
            "remote": remote,
        }
    width = np.uint64(header["width"])
    all_rows: list[np.ndarray] = []
    all_cols: list[np.ndarray] = []
    segments: list[tuple] = []
    for meta in header["shards"]:
        blob = body[off : off + meta["len"]]
        off += meta["len"]
        positions = roaring.deserialize(blob)
        seg_rows = positions // width
        seg_offs = positions % width
        all_rows.append(seg_rows)
        all_cols.append(np.uint64(meta["s"]) * width + seg_offs)
        segments.append((int(meta["s"]), seg_rows, seg_offs))
    rows = np.concatenate(all_rows) if all_rows else np.zeros(0, np.uint64)
    cols = np.concatenate(all_cols) if all_cols else np.zeros(0, np.uint64)
    return {
        "rowIDs": rows,
        "columnIDs": cols,
        "clear": clear,
        "remote": remote,
        # The wire format is already split per shard — hand the split to
        # field.import_bits so the pipeline can skip re-deriving it.
        "_segments": segments,
    }
