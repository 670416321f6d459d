"""Continuous-batching decode engine: the port of
:mod:`tpusystem.serve.engine`.

The engine runs a fixed-shape ``[rows, 1]`` token step over the paged KV
pool while batch membership changes between steps:

* **admit** — the prompt prefills through the module's contiguous decode
  mode, padded to a power-of-2 bucket (:func:`prefill_bucket`; buckets of
  512 tokens or more take the flash kernel); the KV strip scatters into the
  row's free-list blocks (:func:`tpusystem_torch.serve.kvcache.adopt_prefill`)
  and the row's table and cursor are set. The prefill logits' argmax is the
  request's first token.
* **step** — every row advances one token; retired rows idle at the trash
  block behind an active mask, their cursors rewound to 0.
* **evict** — blocks return to the free list and the row's table resets to
  trash.

``decode_impl='fused'`` runs the step through
:func:`tpusystem_torch.train.decode_fused.build_fused_paged_step`, whose
products are the hand-written decode kernels; ``'flax'`` through the
module's paged decode mode. Greedy outputs are token-exact against the JAX
package's engine and against standalone ``generate`` in window-invariant
arithmetic (float32 on the CPU).

The host keeps a mirror of every row's cursor, so each step's read window
is chosen without waiting on the device; the only per-step device-to-host
copy is the emitted tokens. Not ported yet, each raising
``NotImplementedError`` naming its ROADMAP item: sampled rows
(``temperature > 0``), ``share_prefix``, speculative rows
(``draft_module``), tensor parallelism (``mesh``, ``schedule``) and the
disaggregated prefill hand-off.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.func import functional_call

from tpusystem_torch.device import resolve_device
from tpusystem_torch.serve.kvcache import (PagedKVCache, adopt_prefill,
                                           write_tables)
from tpusystem_torch.train.cursors import rewind
from tpusystem_torch.train.decode_fused import (build_fused_paged_step,
                                                fused_paged_reason)
from tpusystem_torch.train.generate import (_decoder, _resolve_impl,
                                            _stream_params, param_dict)


class Saturated(RuntimeError):
    """No free row or not enough free blocks — the request must stay
    queued (the scheduler's job), never crash the engine."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode-sampling controls (the reference's fields). The
    port serves greedy requests only: ``temperature > 0`` is refused at
    admission until the threefry sampler is ported."""
    seed: int | None = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    mask_fn: object = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f'temperature must be >= 0, got {self.temperature}')
        if self.top_k < 0:
            raise ValueError(f'top_k must be >= 0, got {self.top_k}')
        if not 0 < self.top_p <= 1:
            raise ValueError(f'top_p must be in (0, 1], got {self.top_p}')

    @property
    def sampled(self) -> bool:
        """True when this request actually samples (``temperature > 0``)."""
        return self.temperature > 0


def engine_unsupported_reason(module) -> str | None:
    """None when the paged engine can serve this module, else why not."""
    for field in ('decode', 'max_seq', 'per_row_decode', 'decode_pages'):
        if not hasattr(module, field):
            return (f'module {type(module).__name__} has no {field!r} '
                    'field — the engine needs the family decode conventions')
    if getattr(module, 'scan_layers', False):
        return ('scan_layers stacks the per-layer caches at a leading layer '
                'dim; the engine admission writes are unrolled-layout only')
    return None


def prefill_bucket(length: int, block_size: int, max_seq: int) -> int:
    """Pad-to-bucket width for a prompt: the smallest power of 2 at least
    ``max(length, block_size)``, capped at ``max_seq``."""
    bucket = max(length, block_size)
    bucket = 1 << (bucket - 1).bit_length()
    return min(bucket, max_seq)


@dataclasses.dataclass
class Admission:
    """What :meth:`Engine.admit` hands back: the request's row, its first
    token, and whether that token already completed it."""
    row: int
    token: int
    finished: bool
    reason: str | None = None       # 'length' | 'stop' when finished


@dataclasses.dataclass
class StepReport:
    """One engine step: ``emitted`` maps row -> the list of new tokens of
    every active row, ``finished`` lists ``(row, reason, tokens)`` of the
    rows retired (already evicted) this step."""
    emitted: dict
    finished: list


@dataclasses.dataclass
class _RowState:
    tokens: list
    max_new: int
    stop: int | None


def _not_ported(what: str, item: str):
    return NotImplementedError(f'{what} is not ported to tpusystem_torch yet '
                               f'(ROADMAP queue 1: {item})')


class Engine:
    """The continuous-batching engine over one model's parameters.

    Args:
        module: a GPT-2 module (:func:`engine_unsupported_reason` is the
            scope gate).
        params: state dict of weights, or ``None`` for the module's own.
        rows: fixed decode batch width.
        block_size: tokens per KV block.
        blocks: physical blocks in the pool, trash block 0 included.
            Default: every row backed at full ``max_seq`` depth.
        stream_dtype: ``'auto'`` | ``'bfloat16'`` | ``'float32'``.
        decode_impl: ``'flax'`` | ``'fused'`` | ``'auto'`` (fused on the card
            for bfloat16 modules, flax elsewhere).
        device: where to serve; ``None`` is the card.

    ``timings`` accumulates host seconds of prefill, admission writes and
    decode steps; ``last_step_seconds`` is the most recent step's.
    """

    def __init__(self, module, params=None, *, rows: int = 4,
                 block_size: int = 16, blocks: int | None = None,
                 stream_dtype: str = 'auto', decode_impl: str = 'auto',
                 share_prefix: bool = False, draft_module=None, mesh=None,
                 schedule=None, device=None) -> None:
        reason = engine_unsupported_reason(module)
        if reason is not None:
            raise ValueError(f'the serving engine cannot run this module: '
                             f'{reason}')
        if share_prefix:
            raise _not_ported('share_prefix', 'prefix sharing and resume '
                              'prefill')
        if draft_module is not None:
            raise _not_ported('speculative rows (draft_module)',
                              'speculative rows')
        if mesh is not None or schedule is not None:
            raise _not_ported('tensor-parallel serving (mesh, schedule)',
                              'tensor parallelism')
        self.device = resolve_device(device)
        self.rows, self.block_size = rows, block_size
        self.max_seq = module.max_seq
        if blocks is None:
            blocks = rows * (self.max_seq // block_size) + 1
        self._prefiller = _decoder(module)     # contiguous, shared cursor
        self._decoder = _decoder(module, per_row=True).replace(
            decode_pages=(blocks, block_size))
        self._params = _stream_params(
            self._decoder, param_dict(module, params, self.device),
            stream_dtype)
        reason = fused_paged_reason(self._decoder)
        self.decode_impl = _resolve_impl(decode_impl, reason, self._decoder,
                                         self.device)
        self._fused = (build_fused_paged_step(self._decoder)
                       if reason is None else None)
        self.pool = PagedKVCache(rows, blocks, block_size, self.max_seq)
        self._cache = self._decoder.init_cache(rows, self.device)
        self._free_rows = list(range(rows - 1, -1, -1))
        # host mirrors; the device tokens feed back into the next step
        self._active = np.zeros(rows, bool)
        self._cursor = np.zeros(rows, np.int64)
        self._tokens_dev = torch.zeros(rows, dtype=torch.long,
                                       device=self.device)
        self._rowstate: dict[int, _RowState] = {}
        self.timings = {'prefill': 0.0, 'admit': 0.0, 'step': 0.0}
        self.last_step_seconds = 0.0

    # ------------------------------------------------------------ admission

    @property
    def free_rows(self) -> int:
        return len(self._free_rows)

    @property
    def active_rows(self) -> int:
        return int(self._active.sum())

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """Whether an admission of this shape would seat right now."""
        if not self._free_rows:
            return False
        needed = self.pool.blocks_for(prompt_len + max_new)
        if needed > self.pool.max_blocks:
            return False
        return needed <= self.pool.free_blocks

    def bucket(self, prompt_len: int) -> int:
        return prefill_bucket(prompt_len, self.block_size, self.max_seq)

    def _validate(self, prompt, max_new: int, sampling) -> None:
        if prompt.size < 1:
            raise ValueError('empty prompt')
        if max_new < 1:
            raise ValueError(f'max_new must be >= 1, got {max_new}')
        if prompt.size + max_new > self.max_seq:
            raise ValueError(
                f'prompt ({prompt.size}) + max_new ({max_new}) exceeds the '
                f'cache capacity max_seq={self.max_seq}')
        if sampling is not None and (sampling.sampled
                                     or sampling.mask_fn is not None):
            raise _not_ported('sampled and grammar-masked requests',
                              'sampling with the threefry port')

    def _seat(self, prompt, max_new: int) -> int:
        if not self._free_rows:
            raise Saturated('no free row')
        if not self.can_admit(prompt.size, max_new):
            raise Saturated(
                f'{self.pool.blocks_for(prompt.size + max_new)} blocks '
                f'needed, {self.pool.free_blocks} free')
        row = self._free_rows.pop()
        self.pool.admit(row, prompt.size + max_new)
        return row

    @torch.no_grad()
    def _prefill(self, prompt):
        """First token and contiguous KV strips of one padded prompt."""
        bucket = self.bucket(prompt.size)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :prompt.size] = prompt
        logits, cache = functional_call(
            self._prefiller, self._params,
            (torch.as_tensor(padded, device=self.device),), {'cache': None})
        return int(logits[0, prompt.size - 1].argmax()), cache

    @torch.no_grad()
    def admit(self, prompt, max_new: int, *, stop_token: int | None = None,
              sampling=None) -> Admission:
        """Prefill ``prompt`` and seat it in a free row. Raises
        :class:`Saturated` when no row or not enough blocks are free (the
        caller queues), ``ValueError`` on requests that could never fit."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        self._validate(prompt, max_new, sampling)
        row = self._seat(prompt, max_new)

        started = time.perf_counter()
        first, prefill_cache = self._prefill(prompt)
        self.timings['prefill'] += time.perf_counter() - started

        started = time.perf_counter()
        self._cache = adopt_prefill(self._cache, prefill_cache,
                                    self.pool.slots(row), row, prompt.size)
        self._cache = write_tables(self._cache, self.pool.table)
        self.timings['admit'] += time.perf_counter() - started

        self._active[row] = True
        self._cursor[row] = prompt.size
        self._tokens_dev[row] = first
        self._rowstate[row] = _RowState(tokens=[first], max_new=max_new,
                                        stop=stop_token)
        reason = self._finish_reason(row)
        if reason is not None:
            self.evict(row)
            return Admission(row, first, True, reason)
        return Admission(row, first, False)

    def _finish_reason(self, row: int) -> str | None:
        state = self._rowstate[row]
        if state.stop is not None and state.tokens[-1] == state.stop:
            return 'stop'
        if len(state.tokens) >= state.max_new:
            return 'length'
        return None

    # ------------------------------------------------------------- decoding

    @torch.no_grad()
    def _decode(self, decode_impl: str, cache: dict):
        """One token step of every row over ``cache`` (written in place):
        ``(logits [rows, vocab], cache)``."""
        depth = int(self._cursor.max())
        if decode_impl == 'fused':
            return self._fused(self._params, cache, self._tokens_dev, depth)
        logits, cache = functional_call(
            self._decoder, self._params, (self._tokens_dev[:, None],),
            {'cache': cache, 'depth': depth})
        return logits[:, -1], cache

    def next_logits(self, decode_impl: str | None = None):
        """The float32 logits ``[rows, vocab]`` the next step would take
        its tokens from, through ``decode_impl`` (``'fused'`` or
        ``'flax'``; default the engine's own), computed on a copy of the
        cache: nothing advances. The probe that holds the fused step
        against the module path on the same state."""
        decode_impl = decode_impl or self.decode_impl
        if decode_impl == 'fused' and self._fused is None:
            raise ValueError('this engine has no fused step')
        cache = {path: leaf.clone() for path, leaf in self._cache.items()}
        return self._decode(decode_impl, cache)[0]

    def step(self) -> StepReport:
        """Advance every active row one token (one fixed-shape step) and
        retire the rows that hit their length or stop token."""
        if not self._active.any():
            return StepReport({}, [])
        started = time.perf_counter()
        logits, cache = self._decode(self.decode_impl, self._cache)
        token_dev = logits.argmax(-1)
        # active rows advance; retired rows park at cursor 0 so their dead
        # writes stay in the trash block's first slots
        self._cursor = np.where(self._active, self._cursor + 1, 0)
        self._cache = rewind(cache, torch.as_tensor(self._cursor,
                                                    device=self.device))
        self._tokens_dev = token_dev
        token = token_dev.cpu().numpy()
        self.last_step_seconds = time.perf_counter() - started
        self.timings['step'] += self.last_step_seconds
        emitted, finished = {}, []
        for row in np.flatnonzero(self._active):
            row = int(row)
            emitted[row] = [int(token[row])]
            state = self._rowstate[row]
            state.tokens.append(int(token[row]))
            reason = self._finish_reason(row)
            if reason is not None:
                state = self.evict(row)
                finished.append((row, reason, list(state.tokens)))
        return StepReport(emitted, finished)

    # ------------------------------------------------------------- eviction

    def evict(self, row: int) -> _RowState:
        """Retire ``row`` (finished or cancelled): its blocks return to the
        free list and its table resets to trash."""
        if row not in self._rowstate:
            raise ValueError(f'row {row} is not seated')
        self.pool.evict(row)
        self._active[row] = False
        self._cache = write_tables(self._cache, self.pool.table)
        self._free_rows.append(row)
        return self._rowstate.pop(row)

    def tokens(self, row: int) -> list:
        """Tokens emitted so far for a seated row."""
        return list(self._rowstate[row].tokens)
