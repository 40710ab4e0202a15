"""Carry index state into the port from plain arrays.

:func:`holder_from_arrays` builds a :class:`~pilosa_tpu_torch.core.holder.Holder`
from a schema and per-fragment row matrices, the shapes the JAX package
exports (``Holder.schema()`` and ``Fragment.rows_matrix_host()``), so two
holders can hold the same data. It takes numpy arrays only.

An int field carries its options (``min``/``max``, hence its base) and its
``bsig_<field>`` fragments. The schema holds no bit depth, so the field
derives it from its options as the JAX ``Field`` does, and grows it to
cover the planes its fragments carry (rows 2.., reference
fragment.go:90-96), as the JAX field grew it when they were written.
"""

from __future__ import annotations

from typing import Mapping

import torch

from pilosa_tpu_torch.core.fragment import BSI_OFFSET_BIT
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
    load_arrays(holder, schema, fragments)
    return holder


def load_arrays(
    holder: Holder,
    schema: list[dict],
    fragments: Mapping[tuple[str, str, str, int], tuple],
) -> None:
    """Load ``schema`` and ``fragments`` (as :func:`holder_from_arrays`
    takes them) into an existing ``holder``: one bound to a data directory
    (``storage.disk.HolderStore``) gets a file for each new fragment, which
    its next snapshot fills."""
    holder.apply_schema(schema)
    for (index, field, view, shard), (row_ids, words) in fragments.items():
        f = holder.field(index, field)
        if f is None:
            raise KeyError(f"fragment of unknown field {index}/{field}")
        frag = f.create_view_if_not_exists(view).create_fragment_if_not_exists(
            int(shard)
        )
        frag.load_rows_matrix(list(row_ids), words)
        if view == f.bsi_view_name() and len(row_ids):
            if not f.is_bsi():
                raise ValueError(f"BSI view {view!r} of non-int field {index}/{field}")
            f.grow_bit_depth(int(max(row_ids)) - BSI_OFFSET_BIT + 1)
