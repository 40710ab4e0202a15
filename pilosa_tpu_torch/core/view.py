"""View: a named sub-bitmap of a field (counterpart of
``pilosa_tpu/core/view.py``; reference view.go).

View names: ``"standard"`` for a field's bitmap, ``bsig_<field>`` for the
bit-sliced values of an int field (reference view.go:33-38). A view owns
one fragment per shard (reference view.go:41 ``fragments`` map), all on the
view's device.
"""

from __future__ import annotations

import threading

import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.shardwidth import SHARD_WORDS

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"


def view_name_bsi(field_name: str) -> str:
    return VIEW_BSI_PREFIX + field_name


class View:
    def __init__(
        self,
        index: str,
        field: str,
        name: str,
        n_words: int = SHARD_WORDS,
        device: str | torch.device | None = None,
    ):
        self.index = index
        self.field = field
        self.name = name
        self.n_words = n_words
        self.device = device_mod.resolve(device)
        self._lock = threading.RLock()
        self.fragments: dict[int, Fragment] = {}
        # called with (view, shard) for each new fragment (reference
        # view.go:239-261; the storage layer attaches its file)
        self.on_create_fragment = None

    def fragment(self, shard: int) -> Fragment | None:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        """reference view.go:223 CreateFragmentIfNotExists."""
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                frag = Fragment(
                    self.index, self.field, self.name, shard, self.n_words,
                    device=self.device,
                )
                self.fragments[shard] = frag
                if self.on_create_fragment is not None:
                    self.on_create_fragment(self, shard)
            return frag

    def available_shards(self) -> set[int]:
        return set(self.fragments)

    # -- column-addressed ops (abs column -> shard + offset) ---------------

    def _split(self, col: int) -> tuple[int, int]:
        width = self.n_words * 32
        return col // width, col % width

    def set_bit(self, row: int, col: int) -> bool:
        shard, off = self._split(col)
        return self.create_fragment_if_not_exists(shard).set_bit(row, off)

    def clear_bit(self, row: int, col: int) -> bool:
        shard, off = self._split(col)
        frag = self.fragment(shard)
        return frag.clear_bit(row, off) if frag is not None else False

    def get_bit(self, row: int, col: int) -> bool:
        shard, off = self._split(col)
        frag = self.fragment(shard)
        return frag.get_bit(row, off) if frag is not None else False

    def set_mutex(self, row: int, col: int) -> bool:
        shard, off = self._split(col)
        return self.create_fragment_if_not_exists(shard).set_mutex(row, off)

    def set_value(self, col: int, bit_depth: int, value: int) -> bool:
        shard, off = self._split(col)
        return self.create_fragment_if_not_exists(shard).set_value(off, bit_depth, value)

    def value(self, col: int, bit_depth: int) -> tuple[int, bool]:
        shard, off = self._split(col)
        frag = self.fragment(shard)
        return frag.value(off, bit_depth) if frag is not None else (0, False)

    def clear_value(self, col: int) -> bool:
        shard, off = self._split(col)
        frag = self.fragment(shard)
        return frag.clear_value(off) if frag is not None else False
