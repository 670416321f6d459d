"""Paged KV-cache management: the port of :mod:`tpusystem.serve.kvcache`.

:class:`PagedKVCache` is the host-side authority over the paged pool (free
list, block tables, refcounts, the radix prefix index) and is numpy only: it
is copied from the reference unchanged. The two device-side edits the engine
makes at admission and eviction are torch functions here:

* :func:`adopt_prefill` scatters a prefilled contiguous KV strip into a
  row's blocks and sets the row's cursors;
* :func:`write_tables` installs the host's block tables in every layer.

Physical block 0 is the reserved **trash block**: unmapped table entries
point there, so a retired row's dead writes land in trash instead of a live
row's blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusystem_torch.train.cursors import read_cursor, rewind

TRASH_BLOCK = 0


class PagedKVCache:
    """Host-side free-list + block-table authority for the paged pool.

    Pure bookkeeping (numpy only — unit-testable without a device):
    ``admit`` allocates the blocks covering a sequence's whole token
    budget up front (prompt + generation, so decode never stalls on a
    mid-stream allocation), ``evict`` returns them to the free list and
    resets the row's table to trash. The device copies of the tables are
    refreshed from :attr:`table` via :func:`write_tables`.

    ``share_prefix=True`` enables the refcounted radix index (module
    docstring): ``admit`` then takes the row's prompt tokens, reuses
    every cached whole-block prefix match by reference, and
    :meth:`shared_tokens` tells the engine how many leading positions
    arrived pre-filled (so it can skip recomputing them and must NOT
    scatter over them). Default off — the unshared accounting below is a
    pinned contract of its own.
    """

    def __init__(self, rows: int, blocks: int, block_size: int,
                 max_seq: int, share_prefix: bool = False) -> None:
        if max_seq % block_size:
            raise ValueError(f'max_seq ({max_seq}) must be a multiple of '
                             f'block_size ({block_size})')
        if blocks < 2:
            raise ValueError('need at least 2 blocks (block 0 is the '
                             'reserved trash block)')
        self.rows, self.blocks, self.block_size = rows, blocks, block_size
        self.max_blocks = max_seq // block_size
        self.max_seq = max_seq
        self.share_prefix = share_prefix
        # LIFO free list over blocks 1..blocks-1 (0 is trash)
        self._free = list(range(blocks - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}
        self.table = np.full((rows, self.max_blocks), TRASH_BLOCK, np.int32)
        # --- sharing state (unused when share_prefix is False) ---
        self._refs: dict[int, int] = {}        # live block -> refcount >= 1
        self._cached: dict[int, tuple] = {}    # zero-ref warm block -> key
        #                                        (insertion order = LRU)
        self._keys: dict[tuple, int] = {}      # prefix tokens -> block
        self._block_key: dict[int, tuple] = {} # block -> its registered key
        self._shared_len: dict[int, int] = {}  # row -> adopted prefix tokens

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: the free list plus (under sharing) warm
        zero-ref prefix blocks, which are reclaimed on demand."""
        return len(self._free) + len(self._cached)

    @property
    def live_blocks(self) -> int:
        """Blocks currently referenced by at least one seated row."""
        if self.share_prefix:
            return len(self._refs)
        return sum(len(ids) for ids in self._owned.values())

    def blocks_for(self, tokens: int) -> int:
        """Physical blocks covering ``tokens`` cache slots."""
        return -(-tokens // self.block_size)

    def can_admit(self, tokens: int, prompt=None) -> bool:
        needed = self.blocks_for(tokens)
        if needed > self.max_blocks:
            return False
        if self.share_prefix and prompt is not None:
            cached, _ = self.adoptable_prefix(prompt)
            needed -= cached // self.block_size
        return needed <= self.free_blocks

    # ------------------------------------------------------- radix index

    def match_prefix(self, prompt) -> tuple[int, list[int]]:
        """Longest cached whole-block prefix of ``prompt``:
        ``(cached_tokens, block_ids)``. A block matches only when the
        index holds its EXACT token prefix (the radix key is the tokens
        themselves — no hash collisions, no partial blocks), so two rows
        can alias a block only through identical prompt prefixes."""
        if not self.share_prefix:
            return 0, []
        prompt = [int(t) for t in prompt]
        ids = []
        for k in range(min(len(prompt) // self.block_size, self.max_blocks)):
            key = tuple(prompt[:(k + 1) * self.block_size])
            block = self._keys.get(key)
            if block is None:
                break
            ids.append(block)
        return len(ids) * self.block_size, ids

    def adoptable_prefix(self, prompt) -> tuple[int, list[int]]:
        """:meth:`match_prefix` capped so at least ONE prompt token stays
        uncached: admission always prefills a non-empty suffix (its
        last-token logits are the request's first emitted token, and that
        token's KV write must land in a private block, never a shared
        one), so the match runs against ``prompt[:-1]``."""
        prompt = list(prompt)
        if len(prompt) < 2:
            return 0, []
        return self.match_prefix(prompt[:len(prompt) - 1])

    def shared_tokens(self, row: int) -> int:
        """How many leading positions of ``row`` were adopted from the
        radix index at admission (0 without sharing)."""
        return self._shared_len.get(row, 0)

    def _allocate(self) -> int:
        """One fresh block: the free list first, else reclaim the
        least-recently-parked warm prefix block (its content — and its
        radix key — are dropped; refcounted LIVE blocks are never
        touched)."""
        if self._free:
            return self._free.pop()
        block, key = next(iter(self._cached.items()))
        del self._cached[block]
        del self._keys[key]
        del self._block_key[block]
        return block

    def _acquire(self, block: int) -> None:
        """Take one reference on a matched block (reviving it from the
        warm cache if it sat at refcount zero)."""
        if block in self._cached:
            del self._cached[block]
        self._refs[block] = self._refs.get(block, 0) + 1

    def _register(self, ids: list, prompt) -> None:
        """Index every block whose span the prompt fully covers. Those
        blocks are write-once by construction: decode writes start at
        ``len(prompt)``, which lies past every fully-covered block. A
        chunk whose key is already indexed keeps the existing holder
        (one canonical copy per prefix)."""
        prompt = [int(t) for t in prompt]
        for k, block in enumerate(ids):
            if (k + 1) * self.block_size > len(prompt):
                break
            key = tuple(prompt[:(k + 1) * self.block_size])
            if key not in self._keys and block not in self._block_key:
                self._keys[key] = block
                self._block_key[block] = key

    # --------------------------------------------------------- admission

    def admit(self, row: int, tokens: int, prompt=None) -> np.ndarray:
        """Allocate ``tokens`` worth of blocks to ``row`` and return the
        ``[max_seq]`` physical token-slot map of the row (positions past
        the allocation map to trash) — the scatter index
        :func:`adopt_prefill` writes the prefilled KV through.

        With ``share_prefix`` and a ``prompt``, the leading blocks come
        from the radix index where it matches (refcount increment — the
        caller must then mask its adoption scatter below
        :meth:`shared_tokens` so shared blocks stay write-once) and the
        prompt's own fully-covered blocks are registered for future
        admissions."""
        if row in self._owned:
            raise ValueError(f'row {row} already owns blocks — evict first')
        needed = self.blocks_for(tokens)
        if needed > self.max_blocks:
            raise ValueError(f'{tokens} tokens need {needed} blocks, over '
                             f'the per-row table width {self.max_blocks}')
        shared_ids: list[int] = []
        if self.share_prefix and prompt is not None:
            _, shared_ids = self.adoptable_prefix(prompt)
            shared_ids = shared_ids[:needed]
        if needed - len(shared_ids) > self.free_blocks:
            raise ValueError(
                f'{needed - len(shared_ids)} blocks needed, '
                f'{self.free_blocks} free — admission must wait (queue, '
                f'do not crash)')
        for block in shared_ids:
            self._acquire(block)
        fresh = [self._allocate() for _ in range(needed - len(shared_ids))]
        if self.share_prefix:
            for block in fresh:
                self._refs[block] = 1
        ids = shared_ids + fresh
        self._owned[row] = ids
        self.table[row, :needed] = ids
        self.table[row, needed:] = TRASH_BLOCK
        if self.share_prefix and prompt is not None:
            self._shared_len[row] = len(shared_ids) * self.block_size
            self._register(ids, prompt)
        return self.slots(row)

    def slots(self, row: int) -> np.ndarray:
        """``[max_seq]`` physical token slot of each logical position of
        ``row`` under its current table (trash wherever unmapped)."""
        positions = np.arange(self.max_seq)
        physical = self.table[row, positions // self.block_size]
        return (physical * self.block_size
                + positions % self.block_size).astype(np.int32)

    def adoption_slots(self, row: int) -> np.ndarray:
        """:meth:`slots` with the shared prefix redirected to trash: the
        adoption scatter's index for a row admitted through the radix
        index. Shared blocks already hold the prefix KV and are
        write-once, so the positions they cache must scatter their
        (identical, or resume-zeroed) strip values into the trash block
        instead."""
        slots = self.slots(row)
        shared = self.shared_tokens(row)
        if shared:
            positions = np.arange(self.max_seq)
            slots = np.where(
                positions < shared,
                (positions % self.block_size).astype(np.int32), slots)
        return slots

    def evict(self, row: int) -> int:
        """Retire ``row``: every owned block drops one reference, and a
        block leaves the live set only at refcount zero — then to the
        warm cache if it still holds registered prefix content, else to
        the free list. Returns how many blocks the row released."""
        freed = self._owned.pop(row, [])
        self._shared_len.pop(row, None)
        if not self.share_prefix:
            self._free.extend(reversed(freed))
        else:
            for block in reversed(freed):
                self._refs[block] -= 1
                if self._refs[block]:
                    continue
                del self._refs[block]
                key = self._block_key.get(block)
                if key is not None:
                    self._cached[block] = key      # warm, LRU-ordered
                else:
                    self._free.append(block)
        self.table[row] = TRASH_BLOCK
        return len(freed)

    def audit(self) -> dict:
        """Invariant check for the churn tests: every non-trash block is
        in exactly one of {free, warm-cached, live}; refcounts equal the
        number of owning rows; tables agree with ownership; the radix
        index is consistent. Returns summary counts."""
        if self.share_prefix:
            owners: dict[int, int] = {}
            for ids in self._owned.values():
                for block in ids:
                    owners[block] = owners.get(block, 0) + 1
            assert owners == self._refs, (owners, self._refs)
            states = [set(self._free), set(self._cached), set(self._refs)]
            everything: set[int] = set()
            for state in states:
                assert not (state & everything), 'block in two states'
                everything |= state
            assert everything == set(range(1, self.blocks))
            assert set(self._keys.values()) == set(self._block_key)
            for block, key in self._block_key.items():
                assert self._keys[key] == block
        else:
            live = [b for ids in self._owned.values() for b in ids]
            assert len(live) == len(set(live)), 'unshared pool aliased a block'
            assert sorted(live + self._free) == list(range(1, self.blocks))
        for row in range(self.rows):
            ids = self._owned.get(row, [])
            mapped = [int(b) for b in self.table[row] if b != TRASH_BLOCK]
            assert mapped == ids, (row, mapped, ids)
        return {'free': len(self._free), 'cached': len(self._cached),
                'live': self.live_blocks}


def _is_kv(path: str) -> bool:
    return path.rsplit('/', 1)[-1] in ('key', 'value')


def adopt_prefill(cache: dict, prefill_cache: dict, slots, row: int,
                  length: int) -> dict:
    """Admit a prefilled sequence into ``row`` of the paged cache.

    ``prefill_cache`` is the contiguous cache a plain decode-mode prefill
    left behind (per-layer KV strips ``[1, max_seq, heads, head_dim]``);
    ``slots`` is the row's ``[max_seq]`` physical token-slot map
    (:meth:`PagedKVCache.slots`, trash past the allocation, so pad junk
    beyond the prompt lands in trash or in positions the decode writes
    overwrite before the mask exposes them). The pool is written in place;
    the row's cursors are set to ``length``. Tables are
    :func:`write_tables`' business."""
    index = None
    for path, pool in cache.items():
        if not _is_kv(path):
            continue
        if index is None:
            index = torch.as_tensor(np.asarray(slots), device=pool.device)
            index = index.long()
        pool[index] = prefill_cache[path][0].to(pool.dtype)
    cursor = read_cursor(cache).clone()
    cursor[row] = length
    return rewind(cache, cursor)


def write_tables(cache: dict, tables) -> dict:
    """Every layer's ``table`` leaf replaced by the host authority's
    ``[rows, max_blocks]`` map (one tensor shared by the layers)."""
    out, shared = dict(cache), None
    for path, leaf in cache.items():
        if path.rsplit('/', 1)[-1] != 'table':
            continue
        if shared is None:
            shared = torch.as_tensor(np.asarray(tables), dtype=leaf.dtype,
                                     device=leaf.device)
        out[path] = shared
    return out
