"""Continuous-batching decode engine: the port of
:mod:`tpusystem.serve.engine`.

The engine runs a fixed-shape ``[rows, 1]`` token step over the paged KV
pool while batch membership changes between steps:

* **admit** — the prompt prefills through the module's contiguous decode
  mode, padded to a power-of-2 bucket (:func:`prefill_bucket`; buckets of
  512 tokens or more take the flash kernel); the KV strip scatters into the
  row's free-list blocks (:func:`tpusystem_torch.serve.kvcache.adopt_prefill`)
  and the row's table and cursor are set. The request's first token comes
  from the prefill logits (its argmax, or its sample).
* **step** — every row advances one token; retired rows idle at the trash
  block behind an active mask, their cursors rewound to 0.
* **evict** — blocks return to the free list and the row's table resets to
  trash.

``decode_impl='fused'`` runs the step through
:func:`tpusystem_torch.train.decode_fused.build_fused_paged_step`, whose
products are the hand-written decode kernels; ``'flax'`` through the
module's paged decode mode. ``stream_dtype='int8'`` or ``'fp8'`` keeps the
streamed matrices quantized: the fused step's kernels read them narrow, the
prefill and the module path run on their dequantized view, as the
reference's do (``engine.py:207,569``). Greedy outputs are token-exact
against the JAX package's engine and against standalone ``generate`` in
window-invariant arithmetic (float32 on the CPU).

``sampling=`` on admission makes a row sampled or grammar-masked
(:class:`SamplingParams`): its temperature, top-k, top-p and ``[vocab]``
mask live in fixed-shape ``[rows]`` / ``[rows, vocab]`` device tensors the
step reads, and every sampled token's threefry key is a pure function of
``(seed, position)`` (:func:`tpusystem_torch.train.generate.sampling_key`),
derived on the host from its mirrors of each row's seed and stream position,
so a replay that passes the emitted prefix (``emitted=``) reproduces the
stream bitwise on any engine. While no seated row samples or masks, the step
takes the plain argmax, bitwise the greedy branch of
:func:`~tpusystem_torch.train.generate.sample_token`; otherwise every row
goes through it (greedy rows take its argmax branch), the draw's uniforms one
kernel on the card (:func:`tpusystem_torch.ops.cuda.threefry.row_uniforms`).

``share_prefix=True`` turns on the radix prefix index of
:class:`~tpusystem_torch.serve.kvcache.PagedKVCache`: an admission whose
prompt starts with an already-cached block-aligned prefix adopts those
blocks by reference and prefills only the uncached suffix (the **resume
prefill**, :meth:`Engine._resume`: a contiguous cache seeded from the pool
through the row's slots, its cursors at the cached depth, then the padded
suffix down the decode path, whose masked read equals the full causal
prefill in window-invariant arithmetic). A prompt whose full prefill would
take the flash kernel (512 tokens or more) mixes flash-era prefix KV with
the masked read, exact only up to a near-tie of the argmax.

``draft_module`` switches the step to **speculative rows** (the
reference's ``engine.py:627-735``): each request owns ``tree_fanout``
adjacent branch rows of the same pool; the draft, a per-row contiguous
decode cache of its own, runs ``speculate + 1`` greedy steps (fanning the
branches over its top tokens at the first), then one module-path paged
verify over every branch's ``[speculate + 1]`` window samples each window
slot ``j`` at its own ``(seed, position + j)``, so the accepted prefix plus
one correction is exactly the sequential stream, greedy or sampled. Each
group's longest accepted branch wins, its window is copied over its
siblings' inside the pool, and both caches rewind to the accepted depth.
A step emits 1 to ``speculate + 1`` tokens a request. A grammar
``mask_fn`` does not compose with it (refused at admission), nor does the
fused step (``decode_impl='auto'`` resolves to the module path). The draft
steps and the verify run inside ``record_function`` ranges
(``speculative.draft``, ``speculative.verify``), so a trace splits the
step's device time between them.

The host keeps a mirror of every row's cursor, so each step's read window
is chosen without waiting on the device; the only per-step device-to-host
copy is the emitted tokens (with speculative rows, the ``[groups,
speculate + 1]`` window and the accepted counts, read together). An MoE
GPT-2 serves through the module paged step: its experts dispatch at full
capacity, so a row's tokens never depend on its neighbours. Not ported yet,
raising ``NotImplementedError`` naming its ROADMAP item: tensor parallelism
(``mesh``, ``schedule``).

**Disaggregated prefill**: :meth:`Engine.export_prefill` runs a request's
prefill on one engine and returns its first token and host-side KV strips
without seating a row; :meth:`Engine.admit_prefilled` seats such strips on
another engine through the same ``adopt_prefill``/``write_tables`` seam
:meth:`Engine.admit` uses, with no prefill program
(:mod:`tpusystem_torch.serve.disagg` ships them).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.func import functional_call
from torch.profiler import record_function

from tpusystem_torch.device import resolve_device
from tpusystem_torch.ops.attention import contiguous_window
from tpusystem_torch.serve.kvcache import (PagedKVCache, _is_kv,
                                           adopt_prefill, write_tables)
from tpusystem_torch.train.cursors import (gather_rows, is_cursor,
                                          read_cursor, rewind)
from tpusystem_torch.train.decode_fused import (build_fused_paged_step,
                                                fused_paged_reason)
from tpusystem_torch.train.generate import (_decoder, _dequant,
                                            _resolve_impl, _stream_params,
                                            draft_tree, param_dict,
                                            pick_winners, sample_rows,
                                            sample_token, sampling_keys)


class Saturated(RuntimeError):
    """No free row or not enough free blocks — the request must stay
    queued (the scheduler's job), never crash the engine."""


class UnseededSampling(ValueError):
    """A ``temperature > 0`` request with no seed: its stream would not be
    reproducible, so replay could not keep its token-exact contract. Refused
    at admission; a ``ValueError``, as every caller error."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode-sampling controls, journal-replayable: a seeded
    request's token at stream position ``p`` is a pure function of ``(seed,
    p)``, the logits and the emitted prefix.

    Attributes:
        seed: threefry counter seed, required when ``temperature > 0``
            (:class:`UnseededSampling` otherwise); ignored at 0.
        temperature: 0 (default) is the greedy argmax; > 0 scales the
            logits before sampling.
        top_k: keep only the k highest logits (0: no top-k filter).
        top_p: keep the smallest sorted prefix whose mass before each token
            stays under ``top_p`` (1.0: no filter).
        mask_fn: the structured-output hook, a module-level callable
            ``(emitted: list[int]) -> bool[vocab]`` evaluated on the host
            before every position; ``False`` tokens are excluded before
            temperature, top-k and top-p. It must allow at least one token.
            Composes with greedy rows too (masked argmax).
    """
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
    every active row (one on the plain step, up to ``speculate + 1`` on a
    speculative one), ``finished`` lists ``(row, reason, tokens)`` of the
    rows retired (already evicted) this step."""
    emitted: dict
    finished: list


@dataclasses.dataclass
class _RowState:
    tokens: list
    max_new: int
    stop: int | None
    tag: object = None               # opaque caller handle (request id)
    sampling: object = None          # SamplingParams | None (greedy)
    prior: tuple = ()                # tokens emitted in a previous life:
    #                                  positions and mask_fn see prior + tokens


@dataclasses.dataclass(frozen=True)
class _Ops:
    """One request's sampling operands for a token: ``mask`` a bool
    ``[vocab]`` array, or ``None`` for all allowed."""
    seed: int
    position: int
    temperature: float
    top_k: int
    top_p: float
    mask: np.ndarray | None

    @property
    def greedy(self) -> bool:
        return self.temperature == 0 and self.mask is None


def _not_ported(what: str, item: str):
    return NotImplementedError(f'{what} is not ported to tpusystem_torch yet '
                               f'(ROADMAP queue 1: {item})')


def _adopt_draft_rows(dcache: dict, prefill_cache: dict, rows, length: int):
    """Seat one draft prefill strip in ``rows`` of the contiguous per-row
    draft cache (every branch row of a group gets the same prompt KV):
    KV rows overwritten in place, the rows' cursors set to ``length``
    (``engine.py:270``)."""
    index = torch.as_tensor(rows, device=read_cursor(dcache).device)
    for path, leaf in dcache.items():
        if _is_kv(path):
            leaf[index] = prefill_cache[path].to(leaf.dtype)
    cursor = read_cursor(dcache).clone()
    cursor[index] = length
    return rewind(dcache, cursor)


def _copy_winner_windows(cache: dict, rowmap, cursor, speculate: int,
                         block: int, max_blocks: int) -> None:
    """Token-tree verify's winner copy in the pool (``engine.py:290``):
    every branch row's verify window (positions ``cursor .. cursor +
    speculate``, past its shared prompt blocks) is overwritten in place
    from its group winner's (``rowmap``), through each row's own table, so
    block membership never changes. Positions past an allocation map to
    trash on both sides."""
    positions = (cursor[:, None].long()
                 + torch.arange(speculate + 1, device=cursor.device)[None])
    logical = torch.clamp(positions // block, max=max_blocks - 1)
    offsets = positions % block
    # every layer's table leaf is the one host map (write_tables)
    table = next(leaf for path, leaf in cache.items()
                 if path.endswith('/table')).long()
    dst = (table.gather(1, logical) * block + offsets).reshape(-1)
    src = (table[rowmap].gather(1, logical) * block + offsets).reshape(-1)
    for path, pool in cache.items():
        if _is_kv(path):
            pool[dst] = pool[src]


class Engine:
    """The continuous-batching engine over one model's parameters.

    Args:
        module: a GPT-2 or Llama module (:func:`engine_unsupported_reason`
            is the scope gate).
        params: state dict of weights, or ``None`` for the module's own.
        rows: fixed decode batch width.
        block_size: tokens per KV block.
        blocks: physical blocks in the pool, trash block 0 included.
            Default: every row backed at full ``max_seq`` depth.
        stream_dtype: ``'auto'`` | ``'bfloat16'`` | ``'float32'`` |
            ``'int8'`` | ``'fp8'`` (:func:`tpusystem_torch.train.generate`'s
            weight-streaming levers).
        decode_impl: ``'flax'`` | ``'fused'`` | ``'auto'`` (fused on the card
            for bfloat16 modules, flax elsewhere).
        share_prefix: enable the radix prefix index: requests sharing a
            block-aligned prompt prefix share its KV blocks and prefill only
            their uncached suffix.
        device: where to serve; ``None`` is the card.

    Entry points: :meth:`admit` (prefill and seat), :meth:`step`,
    :meth:`evict`; and the disaggregated pair, :meth:`export_prefill` (a
    prefill engine's half: the first token and host-side KV strips, no row
    seated) and :meth:`admit_prefilled` (a decode engine's half: the strips
    seated without a prefill).

    ``timings`` accumulates host seconds of prefill (:meth:`admit`'s and
    :meth:`export_prefill`'s), admission writes (:meth:`admit`'s and
    :meth:`admit_prefilled`'s) and decode steps; ``last_step_seconds`` is
    the most recent step's;
    ``sharing`` counts admissions, prefix hits, prompt and shared tokens and
    resumed prefills.
    """

    def __init__(self, module, params=None, *, rows: int = 4,
                 block_size: int = 16, blocks: int | None = None,
                 stream_dtype: str = 'auto', decode_impl: str = 'auto',
                 share_prefix: bool = False, draft_module=None,
                 draft_params=None, speculate: int = 4,
                 tree_fanout: int = 1, mesh=None, schedule=None,
                 device=None) -> None:
        reason = engine_unsupported_reason(module)
        if reason is not None:
            raise ValueError(f'the serving engine cannot run this module: '
                             f'{reason}')
        if mesh is not None or schedule is not None:
            raise _not_ported('tensor-parallel serving (mesh, schedule)',
                              'tensor parallelism')
        self._spec = draft_module is not None
        if self._spec:
            if speculate < 1:
                raise ValueError(f'speculate must be >= 1, got {speculate}')
            if tree_fanout < 1:
                raise ValueError(
                    f'tree_fanout must be >= 1, got {tree_fanout}')
            if tree_fanout > draft_module.vocab_size:
                raise ValueError(f'tree_fanout ({tree_fanout}) exceeds the '
                                 f'draft vocab ({draft_module.vocab_size})')
            if rows % tree_fanout:
                raise ValueError(f'rows ({rows}) must be a multiple of '
                                 f'tree_fanout ({tree_fanout}) — each '
                                 'request owns fanout adjacent branch rows')
            if decode_impl == 'fused':
                raise ValueError(
                    "decode_impl='fused' does not compose with speculative "
                    'rows — the verify forward is the module paged step')
        self.device = resolve_device(device)
        self.rows, self.block_size = rows, block_size
        self.max_seq = module.max_seq
        self.share_prefix = share_prefix
        self.speculate, self.tree_fanout = speculate, tree_fanout
        if blocks is None:
            blocks = rows * (self.max_seq // block_size) + 1
        self._prefiller = _decoder(module)     # contiguous, shared cursor
        self._decoder = _decoder(module, per_row=True).replace(
            decode_pages=(blocks, block_size))
        self._params = _stream_params(
            self._decoder, param_dict(module, params, self.device),
            stream_dtype)
        reason = fused_paged_reason(self._decoder)
        self.decode_impl = ('flax' if self._spec else _resolve_impl(
            decode_impl, reason, self._decoder, self.device))
        self._fused = (build_fused_paged_step(self._decoder)
                       if reason is None else None)
        self.pool = PagedKVCache(rows, blocks, block_size, self.max_seq,
                                 share_prefix=share_prefix)
        self._cache = self._decoder.init_cache(rows, self.device)
        # free seats: representative rows, every row when linear, the first
        # row of each fanout-wide adjacent group when speculative
        self._stride = tree_fanout if self._spec else 1
        self._free_rows = list(range(rows - self._stride, -1, -self._stride))
        # host mirrors; the device tokens feed back into the next step
        self._active = np.zeros(rows, bool)
        self._cursor = np.zeros(rows, np.int64)
        self._tokens_dev = torch.zeros(rows, dtype=torch.long,
                                       device=self.device)
        # per-row sampling state: the step reads temperature, top-k, top-p
        # and the mask on the device; each row's key is derived on the host
        # from its seed and stream position, so no step waits on the card
        # for it. Greedy defaults (temperature 0, all-True mask) keep an idle
        # or unsampled row on the argmax branch.
        self.vocab = module.vocab_size
        self._seed = np.zeros(rows, np.int64)
        self._position = np.zeros(rows, np.int64)
        self._sampled = np.zeros(rows, bool)       # temperature > 0
        self._masked = np.zeros(rows, bool)        # has a mask_fn
        # the step's keys: hashed on the host in one call, staged in pinned
        # memory and uploaded without blocking (the previous step's token
        # read has already waited for the last upload)
        self._keys_host = torch.zeros(
            (rows, 2), dtype=torch.int64,
            pin_memory=self.device.type == 'cuda')
        self._keys_dev = torch.zeros((rows, 2), dtype=torch.int64,
                                     device=self.device)
        self._temp_dev = torch.zeros(rows, device=self.device)
        self._topk_dev = torch.zeros(rows, dtype=torch.long,
                                     device=self.device)
        self._topp_dev = torch.ones(rows, device=self.device)
        self._mask_dev = torch.ones((rows, self.vocab), dtype=torch.bool,
                                    device=self.device)
        self._rowstate: dict[int, _RowState] = {}
        self.timings = {'prefill': 0.0, 'admit': 0.0, 'step': 0.0}
        self.sharing = {'admissions': 0, 'prefix_hits': 0,
                        'prompt_tokens': 0, 'shared_tokens': 0,
                        'resumed_prefills': 0}
        self.last_step_seconds = 0.0
        if self._spec:
            self._init_draft(draft_module, draft_params, stream_dtype)

    def _init_draft(self, draft_module, draft_params, stream_dtype: str):
        """The draft's state (``engine.py:531-545``): a per-row decoder, a
        contiguous prefiller, its streamed params, a per-row contiguous
        cache, and the pinned and device buffers of a verify window's
        ``[rows * (speculate + 1), 2]`` sampling keys."""
        self._drafter = _decoder(draft_module, per_row=True)
        self._draft_prefiller = _decoder(draft_module)
        self._dparams = _stream_params(
            self._drafter, param_dict(draft_module, draft_params,
                                      self.device), stream_dtype)
        self._dcache = self._drafter.init_cache(self.rows, self.device)
        width = self.rows * (self.speculate + 1)
        self._wkeys_host = torch.zeros(
            (width, 2), dtype=torch.int64,
            pin_memory=self.device.type == 'cuda')
        self._wkeys_dev = torch.zeros((width, 2), dtype=torch.int64,
                                      device=self.device)
        self._parked = False        # an eviction left stale cursors behind
        # speculative steps, the requests they stepped (``groups``) and the
        # drafts those requests accepted
        self.speculation = {'steps': 0, 'accepted': 0, 'groups': 0}

    # ------------------------------------------------------------ admission

    @property
    def free_rows(self) -> int:
        return len(self._free_rows)

    @property
    def active_rows(self) -> int:
        return int(self._active.sum())

    @property
    def sampled_rows(self) -> int:
        """Seated requests decoding with ``temperature > 0``."""
        return sum(1 for state in self._rowstate.values()
                   if state.sampling is not None and state.sampling.sampled)

    def can_admit(self, prompt_len: int, max_new: int, prompt=None) -> bool:
        """Whether an admission of this shape would seat right now (a
        speculative request seats ``tree_fanout`` rows). Pass the prompt
        tokens to count prefix sharing (matched blocks need no allocation);
        without them the estimate is conservative."""
        if not self._free_rows:
            return False
        needed = self.pool.blocks_for(prompt_len + max_new)
        if needed > self.pool.max_blocks:
            return False
        fanout = self._stride
        if self.share_prefix and prompt is not None:
            matched = (self.pool.adoptable_prefix(prompt)[0]
                       // self.block_size)
            # later branches also match the blocks the first branch
            # registers (every block the prompt covers fully)
            sibling = max(matched, (prompt_len - 1) // self.block_size)
            total = (needed - matched) + (fanout - 1) * (needed - sibling)
        else:
            total = fanout * needed
        return total <= self.pool.free_blocks

    def bucket(self, prompt_len: int) -> int:
        return prefill_bucket(prompt_len, self.block_size, self.max_seq)

    def prefix_cached_len(self, prompt) -> int:
        """How many leading prompt tokens the radix index would serve from
        cache if this prompt were admitted now (0 without sharing)."""
        if not self.share_prefix:
            return 0
        return self.pool.adoptable_prefix(prompt)[0]

    def admit_cost(self, prompt) -> int:
        """Prefill pad-bucket cost of admitting ``prompt``: the bucket of its
        uncached suffix under prefix sharing, of the whole prompt otherwise
        (at least one token always prefills)."""
        suffix = max(len(prompt) - self.prefix_cached_len(prompt), 1)
        return self.bucket(suffix)

    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the radix index
        (0.0 before any admission)."""
        total = self.sharing['prompt_tokens']
        return self.sharing['shared_tokens'] / total if total else 0.0

    def _greedy_ops(self, position: int = 0) -> _Ops:
        """The greedy-default operands: the first token is the argmax."""
        return _Ops(0, position, 0.0, 0, 1.0, None)

    def _grammar_mask(self, sampling, stream: list) -> np.ndarray | None:
        """``mask_fn`` over the stream so far, validated (bool ``[vocab]``,
        at least one token allowed); ``None`` when the request has none."""
        if sampling is None or sampling.mask_fn is None:
            return None
        mask = np.asarray(sampling.mask_fn(list(stream)), bool).reshape(-1)
        if mask.shape[0] != self.vocab:
            raise ValueError(
                f'mask_fn returned {mask.shape[0]} entries, the vocab is '
                f'{self.vocab}')
        if not mask.any():
            raise ValueError(
                f'mask_fn allowed no token after {len(stream)} emitted — a '
                'grammar must always leave an escape hatch (e.g. its stop '
                'token)')
        return mask

    def _sampling_ops(self, sampling, emitted) -> _Ops:
        """The request's operands for its first token, at stream position
        ``len(emitted)`` (the slots a previous life already emitted)."""
        if sampling is None:
            return self._greedy_ops(len(emitted))
        return _Ops(sampling.seed or 0, len(emitted), sampling.temperature,
                    sampling.top_k, sampling.top_p,
                    self._grammar_mask(sampling, list(emitted)))

    def _first_token(self, logits, ops: _Ops) -> int:
        """The request's first token from its prefill logits row."""
        if ops.greedy:
            return int(logits.argmax())
        mask = (torch.ones(self.vocab, dtype=torch.bool, device=self.device)
                if ops.mask is None
                else torch.as_tensor(ops.mask, device=self.device))
        return int(sample_token(logits, ops.seed, ops.position,
                                ops.temperature, ops.top_k, ops.top_p, mask))

    def _validate(self, prompt, max_new: int, sampling=None) -> None:
        if prompt.size < 1:
            raise ValueError('empty prompt')
        if max_new < 1:
            raise ValueError(f'max_new must be >= 1, got {max_new}')
        if prompt.size + max_new > self.max_seq:
            raise ValueError(
                f'prompt ({prompt.size}) + max_new ({max_new}) exceeds the '
                f'cache capacity max_seq={self.max_seq}')
        self._validate_sampling(sampling)
        if self._spec:
            needed = prompt.size + max_new + self.speculate + 1
            if needed > self._drafter.max_seq:
                raise ValueError(
                    f'prompt + max_new + speculate + 1 = {needed} exceeds '
                    f'the draft cache capacity max_seq='
                    f'{self._drafter.max_seq} (the draft overshoots by up '
                    'to speculate tokens before rewinding)')

    def _validate_sampling(self, sampling) -> None:
        """The sampling refusals (``engine.py:900``), also the scheduler's
        check at submission: :class:`UnseededSampling`, and a ``mask_fn``
        on a speculative engine."""
        if sampling is None:
            return
        if sampling.sampled and sampling.seed is None:
            raise UnseededSampling(
                f'temperature {sampling.temperature} with no seed: the '
                'stream would not be reproducible, so journal replay, '
                'reroute, and hedging could not keep their token-exact '
                'contract — pass SamplingParams(seed=...)')
        if self._spec and sampling.mask_fn is not None:
            raise ValueError(
                'mask_fn does not compose with speculative rows — a '
                'grammar mask cannot update inside a multi-token verify '
                'window; serve structured requests on the plain engine')

    def _seat(self, prompt, max_new: int) -> list[int]:
        """Claim a free row (a free group of ``tree_fanout`` adjacent rows
        when speculative, its first row the representative) and seat it in
        the pool, rolled back whole on a block shortfall. Returns the
        rows."""
        if not self._free_rows:
            raise Saturated('no free row')
        tokens = prompt.size + max_new
        if not self.can_admit(prompt.size, max_new, prompt=prompt):
            raise Saturated(f'{self.pool.blocks_for(tokens)} blocks needed '
                            f'per row, {self.pool.free_blocks} free')
        rep = self._free_rows.pop()
        rows, seated = list(range(rep, rep + self._stride)), []
        try:
            for row in rows:
                self.pool.admit(row, tokens,
                                prompt=prompt if self.share_prefix else None)
                seated.append(row)
        except ValueError:
            for row in seated:
                self.pool.evict(row)
            self._free_rows.append(rep)
            raise Saturated(f'{self.pool.blocks_for(tokens)} blocks needed '
                            f'per row, {self.pool.free_blocks} free') from None
        return rows

    def _padded(self, tokens) -> torch.Tensor:
        padded = np.zeros((1, self.bucket(tokens.size)), np.int64)
        padded[0, :tokens.size] = tokens
        return torch.as_tensor(padded, device=self.device)

    @torch.no_grad()
    def _prefill(self, prompt):
        """The float32 logits ``[vocab]`` at the prompt's last position and
        the contiguous KV strips of one padded prompt."""
        logits, cache = functional_call(
            self._prefiller, _dequant(self._params, self._prefiller),
            (self._padded(prompt),), {'cache': None})
        # a copy of the row, so the [1, bucket, vocab] logits free now
        return logits[0, prompt.size - 1].clone(), cache

    @torch.no_grad()
    def _resume(self, prompt, slots, shared: int):
        """The resume prefill (the reference's ``_build_resume``): the
        prefiller's contiguous cache for one row, then only the padded
        suffix applied. The cache is as long as the window the suffix's
        masked read takes (so it holds every position the read sees, and no
        more), each KV leaf one gather from the pool through the row's
        ``slots``, zeroed at and past ``shared``, and its cursors at
        ``shared``. Returns what :meth:`_prefill` returns, with KV strips of
        that window's length."""
        suffix = self._padded(prompt[shared:])
        width = contiguous_window(self.max_seq, shared + suffix.shape[1])
        index = torch.as_tensor(np.asarray(slots[:width], np.int64),
                                device=self.device)
        cursor = torch.full((1,), shared, dtype=torch.int32,
                            device=self.device)
        cache = {}
        for path, leaf in self._cache.items():
            if _is_kv(path):
                strip = leaf.index_select(0, index)
                strip[shared:] = 0
                cache[path] = strip[None]
            elif is_cursor(path):
                cache[path] = cursor
        logits, cache = functional_call(
            self._prefiller, _dequant(self._params, self._prefiller),
            (suffix,), {'cache': cache, 'depth': shared})
        return logits[0, prompt.size - shared - 1].clone(), cache

    def _prefill_rows(self, prompt, row: int):
        """The prefill of an admission already seated in the pool: the
        resume over the uncached suffix when the row adopted a shared prefix
        and the suffix's bucket fits behind it, the full prompt otherwise."""
        shared = self.pool.shared_tokens(row)
        if shared and shared + self.bucket(prompt.size - shared) \
                <= self.max_seq:
            self.sharing['resumed_prefills'] += 1
            return self._resume(prompt, self.pool.slots(row), shared)
        return self._prefill(prompt)

    def _register(self, rows: list[int], prompt, first: int, max_new: int,
                  stop_token: int | None, tag, sampling=None,
                  emitted=()) -> Admission:
        """The host-side admission tail of a request seated in ``rows`` (its
        representative first): sharing counters, row state, sampling state,
        token and active mirrors, and the admitted-already-finished
        check."""
        rep = rows[0]
        shared = sum(self.pool.shared_tokens(row) for row in rows)
        self.sharing['admissions'] += 1
        self.sharing['prompt_tokens'] += int(prompt.size) * len(rows)
        self.sharing['shared_tokens'] += shared
        self.sharing['prefix_hits'] += bool(shared)
        index = slice(rep, rep + len(rows))
        # the next token's stream position: `first` landed at len(emitted)
        self._position[index] = len(emitted) + 1
        if sampling is not None:
            self._seed[index] = sampling.seed or 0
            self._sampled[index] = sampling.sampled
            self._masked[index] = sampling.mask_fn is not None
            self._temp_dev[index] = sampling.temperature
            self._topk_dev[index] = sampling.top_k
            self._topp_dev[index] = sampling.top_p
        self._active[index] = True
        self._tokens_dev[index] = first
        self._rowstate[rep] = _RowState(tokens=[first], max_new=max_new,
                                        stop=stop_token, tag=tag,
                                        sampling=sampling,
                                        prior=tuple(emitted))
        reason = self._finish_reason(rep)
        if reason is not None:
            self.evict(rep)
            return Admission(rep, first, True, reason)
        mask = self._grammar_mask(sampling, list(emitted) + [first])
        if mask is not None:
            self._mask_dev[rep] = torch.as_tensor(mask, device=self.device)
        return Admission(rep, first, False)

    @torch.no_grad()
    def admit(self, prompt, max_new: int, *, stop_token: int | None = None,
              tag=None, sampling=None, emitted=()) -> Admission:
        """Prefill ``prompt`` and seat it in a free row. Raises
        :class:`Saturated` when no row or not enough blocks are free (the
        caller queues), ``ValueError`` on requests that could never fit,
        :class:`UnseededSampling` among them.

        ``sampling`` is the request's :class:`SamplingParams` (``None``:
        greedy); ``emitted`` the tokens a previous life already emitted for
        this request (a replay passes its prefix, which the prompt already
        includes, so sampling positions continue where the stream left
        off). A speculative engine seats a group of ``tree_fanout`` rows and
        returns its first row, and prefills the draft too."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        self._validate(prompt, max_new, sampling)
        ops = self._sampling_ops(sampling, emitted)
        rows = self._seat(prompt, max_new)

        started = time.perf_counter()
        logits, prefill_cache = self._prefill_rows(prompt, rows[0])
        first = self._first_token(logits, ops)
        self.timings['prefill'] += time.perf_counter() - started

        started = time.perf_counter()
        # a resumed prefill's strips are shorter than max_seq: its slots too
        strip = next(leaf for path, leaf in prefill_cache.items()
                     if _is_kv(path)).shape[1]
        for row in rows:
            self._cache = adopt_prefill(self._cache, prefill_cache,
                                        self.pool.adoption_slots(row)[:strip],
                                        row, prompt.size)
        self._cache = write_tables(self._cache, self.pool.table)
        self._cursor[rows] = prompt.size
        if self._spec:
            self._prefill_draft(prompt, rows)
        self.timings['admit'] += time.perf_counter() - started
        return self._register(rows, prompt, first, max_new, stop_token, tag,
                              sampling, emitted)

    # ------------------------------------------------- disaggregated prefill

    @torch.no_grad()
    def export_prefill(self, prompt, *, sampling=None,
                       emitted=()) -> tuple[int, dict]:
        """Run the admission prefill without seating a row: the prefill
        half of disaggregated serving (``engine.py:1038``). Returns
        ``(first, kv)``: the prompt's first token, chosen at the request's
        ``(seed, len(emitted))`` counter as :meth:`admit` would choose it,
        and every KV leaf's contiguous strip (cache path -> ``[1, max_seq,
        heads, head_dim]``), copied to the host so the blob plane can ship
        it. The pool, the rows and the radix index are untouched; a
        decode engine seats the strips with :meth:`admit_prefilled`."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError('empty prompt')
        if prompt.size >= self.max_seq:
            raise ValueError(
                f'prompt ({prompt.size}) leaves no decode room under '
                f'max_seq={self.max_seq}')
        self._validate_sampling(sampling)
        ops = self._sampling_ops(sampling, emitted)
        started = time.perf_counter()
        logits, cache = self._prefill(prompt)
        first = self._first_token(logits, ops)
        self.timings['prefill'] += time.perf_counter() - started
        return first, {path: leaf.cpu() for path, leaf in cache.items()
                       if _is_kv(path)}

    def _strip_cache(self, kv: dict) -> dict:
        """The contiguous prefill cache rebuilt from exported strips, on this
        engine's device and in its cache's dtype: the receiving half of
        :meth:`export_prefill`. The expected shapes come from the
        prefiller's cache geometry on the ``meta`` device, so no prefill
        runs and nothing is allocated for them. A missing or misshapen
        strip raises ``ValueError`` (prefill and decode engines must serve
        the same module)."""
        prefill_cache = {}
        for path, leaf in self._prefiller.init_cache(1, 'meta').items():
            if not _is_kv(path):
                continue
            if path not in kv:
                raise ValueError(
                    f'handoff strip missing KV leaf {path} — prefill and '
                    'decode replicas must serve the same module')
            strip = kv[path]
            if tuple(strip.shape) != tuple(leaf.shape):
                raise ValueError(
                    f'handoff strip {path} is {tuple(strip.shape)}, this '
                    f'engine expects {tuple(leaf.shape)} — prefill and '
                    'decode replicas must serve the same module geometry')
            prefill_cache[path] = strip.to(self.device, leaf.dtype)
        return prefill_cache

    @torch.no_grad()
    def admit_prefilled(self, prompt, max_new: int, first: int, kv: dict,
                        *, stop_token: int | None = None, tag=None,
                        sampling=None, emitted=()) -> Admission:
        """Seat a request whose prefill ran on another engine
        (:meth:`export_prefill`'s strips, shipped over the blob plane). The
        contract of :meth:`admit` (:class:`Saturated` when nothing is free,
        ``ValueError`` on a request that could never fit), but no prefill
        runs here: the strips are checked before any row is seated, then
        scattered into the row's blocks by :func:`adopt_prefill`. A
        speculative engine refuses it: its draft cache has no strip."""
        if self._spec:
            raise ValueError(
                'admit_prefilled does not compose with speculative rows — '
                'the draft cache has no handoff strip; disaggregate the '
                'plain engine')
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        self._validate(prompt, max_new, sampling)
        prefill_cache = self._strip_cache(kv)     # validated before seating
        rows = self._seat(prompt, max_new)

        started = time.perf_counter()
        for row in rows:
            self._cache = adopt_prefill(self._cache, prefill_cache,
                                        self.pool.adoption_slots(row), row,
                                        prompt.size)
        self._cache = write_tables(self._cache, self.pool.table)
        # the host mirror of the cursor (the reference keeps it in the cache)
        self._cursor[rows] = prompt.size
        self.timings['admit'] += time.perf_counter() - started
        return self._register(rows, prompt, int(first), max_new, stop_token,
                              tag, sampling, emitted)

    @torch.no_grad()
    def _prefill_draft(self, prompt, rows: list[int]) -> None:
        """The draft's prefill on admission (``engine.py:1021-1030``): the
        padded prompt through the contiguous draft prefiller, its strip
        seated in every row of the group."""
        padded = np.zeros((1, prefill_bucket(prompt.size, self.block_size,
                                             self._drafter.max_seq)),
                          np.int64)
        padded[0, :prompt.size] = prompt
        _, draft_cache = functional_call(
            self._draft_prefiller,
            _dequant(self._dparams, self._draft_prefiller),
            (torch.as_tensor(padded, device=self.device),), {'cache': None})
        self._dcache = _adopt_draft_rows(self._dcache, draft_cache, rows,
                                         prompt.size)

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
            self._decoder, _dequant(self._params, self._decoder),
            (self._tokens_dev[:, None],), {'cache': cache, 'depth': depth})
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

    def _step_keys(self):
        """The step's ``[rows, 2]`` keys on the device, each row's
        ``sampling_key(seed, position)`` from the host mirrors (a row that
        does not sample draws nothing that counts), or ``None`` while no
        seated row samples or masks: that step takes the plain argmax."""
        if not (self._sampled | self._masked).any():
            return None
        self._keys_host.copy_(torch.from_numpy(
            sampling_keys(self._seed, self._position)))
        return self._keys_dev.copy_(self._keys_host, non_blocking=True)

    @torch.no_grad()
    def step(self) -> StepReport:
        """Advance every active row one token (one fixed-shape step; up to
        ``speculate + 1`` a request on the speculative step) and retire the
        rows that hit their length or stop token."""
        if not self._active.any():
            return StepReport({}, [])
        if self._spec:
            return self._spec_tick()
        started = time.perf_counter()
        # uploaded before the step's launches: the copy waits on no kernel
        keys = self._step_keys()
        logits, cache = self._decode(self.decode_impl, self._cache)
        if keys is None:
            token_dev = logits.argmax(-1)
        else:
            token_dev = sample_rows(logits, keys, self._temp_dev,
                                    self._topk_dev, self._topp_dev,
                                    self._mask_dev)
        # active rows advance; retired rows park at cursor 0 so their dead
        # writes stay in the trash block's first slots
        self._cursor = np.where(self._active, self._cursor + 1, 0)
        self._position = np.where(self._active, self._position + 1,
                                  self._position)
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
                continue
            # the grammar hook: the mask over the whole stream, for the
            # next position
            mask = self._grammar_mask(state.sampling,
                                      list(state.prior) + state.tokens)
            if mask is not None:
                self._mask_dev[row] = torch.as_tensor(mask,
                                                      device=self.device)
        return StepReport(emitted, finished)

    # ---------------------------------------------------------- speculative

    def _window_candidates(self, vlogits):
        """The target's choice at every verify window slot, ``[rows,
        speculate + 1]``: slot ``j`` of a row sampled at its own ``(seed,
        position + j)`` key through :func:`sample_rows` (so the accepted
        prefix plus the correction is the sequential sampled stream), or the
        plain argmax while no seated row samples."""
        if not self._sampled.any():
            return vlogits.argmax(-1)
        rows, width, vocab = vlogits.shape
        self._wkeys_host.copy_(torch.from_numpy(sampling_keys(
            np.repeat(self._seed, width),
            (self._position[:, None] + np.arange(width)[None]).reshape(-1))))
        keys = self._wkeys_dev.copy_(self._wkeys_host, non_blocking=True)
        return sample_rows(
            vlogits.reshape(rows * width, vocab), keys,
            self._temp_dev.repeat_interleave(width),
            self._topk_dev.repeat_interleave(width),
            self._topp_dev.repeat_interleave(width),
            self._mask_dev.repeat_interleave(width, 0)).reshape(rows, width)

    def _spec_step(self):
        """The device half of a speculative step (``engine.py:627-735``):
        ``speculate + 1`` greedy draft steps on the per-row draft cache
        (the first fanning each group's branches over the draft's top
        tokens), one module-path paged verify of every branch's window,
        the window's candidates, the per-group winner, its window copied
        over its siblings' in the pool, and both caches rewound to the
        accepted depth (retired rows to 0). Returns ``[groups, speculate +
        2]``: the emitted window, then the accepted count, still on the
        device."""
        K, F = self.speculate, self.tree_fanout
        if self._parked:
            # an eviction left its rows' old cursors behind: park them at 0
            # before the draft's contiguous writes run past its strips
            self._cursor = np.where(self._active, self._cursor, 0)
            at = torch.as_tensor(self._cursor, device=self.device)
            self._cache = rewind(self._cache, at)
            self._dcache = rewind(self._dcache, at)
            self._parked = False
        depth = int(self._cursor.max())
        cursor0 = torch.as_tensor(self._cursor, device=self.device)
        tokens = self._tokens_dev
        with record_function('speculative.draft'):
            drafts, dcache = draft_tree(
                self._drafter, _dequant(self._dparams, self._drafter),
                self._dcache, tokens, depth, K, F)
        window = torch.cat([tokens[:, None], drafts], 1)
        with record_function('speculative.verify'):
            vlogits, cache = functional_call(
                self._decoder, _dequant(self._params, self._decoder),
                (window,), {'cache': self._cache, 'depth': depth})
            candidates = self._window_candidates(vlogits)
        accepted_w, win_rows, emitted = pick_winners(drafts, candidates, F)
        active = torch.as_tensor(self._active, device=self.device)
        advance = (accepted_w + 1).repeat_interleave(F)
        cursor = torch.where(active, cursor0 + advance,
                             torch.zeros_like(cursor0))
        if F > 1:
            rowmap = win_rows.repeat_interleave(F)
            _copy_winner_windows(cache, rowmap, cursor0, K, self.block_size,
                                 self.max_seq // self.block_size)
            dcache = gather_rows(dcache, rowmap)
        self._cache, self._dcache = rewind(cache, cursor), rewind(dcache,
                                                                  cursor)
        self._tokens_dev = emitted.gather(
            1, accepted_w[:, None])[:, 0].repeat_interleave(F)
        return torch.cat([emitted, accepted_w[:, None]], 1)

    def _spec_tick(self) -> StepReport:
        """One speculative step: the device half, then its one copy to the
        host (the window and the accepted counts together), from which the
        cursor and position mirrors advance; each request takes its
        accepted prefix and correction, truncated at its budget or stop
        token (``engine.py:1188-1223``)."""
        started = time.perf_counter()
        read = self._spec_step().cpu().numpy()              # [groups, K+2]
        window, accepted = read[:, :-1], read[:, -1]
        advance = np.repeat(accepted + 1, self.tree_fanout)
        self._cursor = np.where(self._active, self._cursor + advance, 0)
        self._position = np.where(self._active, self._position + advance,
                                  self._position)
        self.last_step_seconds = time.perf_counter() - started
        self.timings['step'] += self.last_step_seconds
        self.speculation['steps'] += 1
        emitted, finished = {}, []
        for rep in sorted(self._rowstate):
            if not self._active[rep]:
                continue
            state = self._rowstate[rep]
            group = rep // self.tree_fanout
            self.speculation['groups'] += 1
            self.speculation['accepted'] += int(accepted[group])
            tokens = [int(t) for t in window[group, :accepted[group] + 1]]
            # truncated only at a finish, so the device cursors' extra
            # advance dies with the eviction
            tokens = tokens[:state.max_new - len(state.tokens)]
            if state.stop is not None and state.stop in tokens:
                tokens = tokens[:tokens.index(state.stop) + 1]
            state.tokens.extend(tokens)
            emitted[rep] = tokens
            reason = self._finish_reason(rep)
            if reason is not None:
                state = self.evict(rep)
                finished.append((rep, reason, list(state.tokens)))
        return StepReport(emitted, finished)

    # ------------------------------------------------------------- eviction

    def evict(self, row: int) -> _RowState:
        """Retire ``row`` (finished or cancelled; a speculative request's
        representative row retires its whole group): its blocks return to
        the free list (or, shared, drop one reference) and its table resets
        to trash; a sampled or masked row's state returns to the greedy
        defaults."""
        if row not in self._rowstate:
            raise ValueError(f'row {row} is not seated')
        state = self._rowstate[row]
        members = slice(row, row + self._stride)
        for member in range(row, row + self._stride):
            self.pool.evict(member)
        self._active[members] = False
        if state.sampling is not None:
            self._temp_dev[members] = 0.0
            self._sampled[members] = self._masked[members] = False
            if state.sampling.mask_fn is not None:
                self._mask_dev[members] = True
        self._cache = write_tables(self._cache, self.pool.table)
        if self._spec:
            self._parked = True
        self._free_rows.append(row)
        return self._rowstate.pop(row)

    def tokens(self, row: int) -> list:
        """Tokens emitted so far for a seated row."""
        return list(self._rowstate[row].tokens)
