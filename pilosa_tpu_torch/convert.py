"""Carry index state into the port from plain arrays.

:func:`holder_from_arrays` builds a :class:`~pilosa_tpu_torch.core.holder.Holder`
from a schema and per-fragment row matrices, the shapes the JAX package
exports (``Holder.schema()`` and ``Fragment.rows_matrix_host()``), so two
holders can hold the same data. It takes numpy arrays only.
"""

from __future__ import annotations

from typing import Mapping

import torch

from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.shardwidth import SHARD_WORDS


def holder_from_arrays(
    schema: list[dict],
    fragments: Mapping[tuple[str, str, str, int], tuple],
    device: str | torch.device | None = None,
    n_words: int = SHARD_WORDS,
) -> Holder:
    """A holder on ``device`` with ``schema``'s indexes and fields, and one
    fragment per ``(index, field, view, shard)`` key of ``fragments``,
    each loaded from its ``(row_ids, uint32[len(row_ids), W])`` pair."""
    holder = Holder(n_words=n_words, device=device)
    holder.apply_schema(schema)
    for (index, field, view, shard), (row_ids, words) in fragments.items():
        f = holder.field(index, field)
        if f is None:
            raise KeyError(f"fragment of unknown field {index}/{field}")
        frag = f.create_view_if_not_exists(view).create_fragment_if_not_exists(
            int(shard)
        )
        frag.load_rows_matrix(list(row_ids), words)
    return holder
