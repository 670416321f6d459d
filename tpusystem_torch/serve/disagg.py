"""Disaggregated prefill/decode: the port of :mod:`tpusystem.serve.disagg`,
KV hand-offs over the blob plane.

A prefill-role replica runs only the admission prefill and exports every
layer's contiguous KV strip
(:meth:`~tpusystem_torch.serve.Engine.export_prefill`); the strips travel
to a decode-role replica over the blob plane (``send_blob``/``fetch_blob``,
the one-process :class:`~tpusystem_torch.parallel.multihost.Loopback` in
the port) under the ``kv:{request}`` namespace, the naming discipline of
:func:`~tpusystem_torch.serve.failover.journal_identity`. The decode replica
seats them through ``adopt_prefill``/``write_tables``
(:meth:`~tpusystem_torch.serve.Engine.admit_prefilled`), the admission seam
all along: disaggregation only moves where the strip comes from.

The payload is a :class:`KVHandoff`: the :class:`Request` itself (its
``trace`` context rides along), the replayed prefix if any (journal
recovery composes), the prefill's first token, and the strips.
:func:`pack_handoff` prefixes a BLAKE2b digest so the transfer is verified
end to end even on a transport that does not verify chunks;
:exc:`HandoffCorrupt` is the typed failure.

Copied from the reference but for the strips, which are CPU
``torch.Tensor`` objects here (see :class:`KVHandoff`).
"""

from __future__ import annotations

import dataclasses
import pickle

from tpusystem_torch.parallel.multihost import _blob_digest


class HandoffCorrupt(RuntimeError):
    """A KV handoff payload failed its digest or would not unpickle —
    the receiving replica must NOT seat it (a half-written strip decodes
    garbage silently). The router re-exports or fails the request."""


class RoleMismatch(RuntimeError):
    """A request needing engine work this replica's role does not do
    landed here (e.g. a hot restore-with-prefix on a prefill-only
    scheduler). Typed — and deliberately NOT a ``ValueError``, which the
    router's replay path treats as 'request already finished' and
    swallows silently."""


def kv_namespace(request_id: str) -> str:
    """The blob-plane key for one request's KV handoff — mirrors
    :func:`~tpusystem_torch.serve.failover.journal_identity` so every sidecar
    plane namespaces the same way (``journal:{identity}``,
    ``trace:{process}``, ``kv:{request}``)."""
    return f'kv:{request_id}'


@dataclasses.dataclass
class KVHandoff:
    """One finished prefill, ready to decode somewhere else.

    ``request`` is the original :class:`~tpusystem_torch.serve.Request`
    (trace context included); ``prefix`` the tokens already emitted
    before a replay (the exported strips cover ``prompt + prefix``);
    ``first`` the prefill's first token; ``kv`` the cache path (such as
    ``'h_0/attn/key'``) -> ``[1, max_seq, heads, head_dim]`` strips;
    ``waited`` seconds already spent queued on the prefill side, so
    decode-side deadline and latency accounting stay truthful.

    The reference's strips are numpy arrays, keyed by ``keystr`` paths.
    The port keeps them as CPU ``torch.Tensor`` objects in the cache's own
    dtype, which pickle as they are: a bfloat16 strip has no numpy dtype
    without ``ml_dtypes``, and widening it to float32 would double the
    bytes shipped. Full ``max_seq`` strips are shipped, as in the reference."""
    request: object
    first: int
    kv: dict
    prefix: list = dataclasses.field(default_factory=list)
    waited: float = 0.0


def pack_handoff(handoff: KVHandoff) -> bytes:
    """Serialize with an end-to-end digest prefix (the journal's
    ``digest:payload`` framing). The TCP blob plane already verifies
    per-transfer digests, but the handoff must survive ANY transport —
    the digest travels inside the payload."""
    payload = pickle.dumps(handoff, protocol=pickle.HIGHEST_PROTOCOL)
    return _blob_digest(payload).encode('ascii') + b':' + payload


def unpack_handoff(data: bytes) -> KVHandoff:
    """Verify and deserialize :func:`pack_handoff`'s payload; raises
    :exc:`HandoffCorrupt` on digest mismatch or a payload that will not
    unpickle."""
    digest, sep, payload = bytes(data).partition(b':')
    if not sep or _blob_digest(payload).encode('ascii') != digest:
        raise HandoffCorrupt(
            'handoff payload failed its digest — truncated or corrupted '
            'in flight; refusing to seat a half-written KV strip')
    try:
        handoff = pickle.loads(payload)
    except Exception as error:
        raise HandoffCorrupt(
            f'handoff payload would not deserialize: {error}') from error
    if not isinstance(handoff, KVHandoff):
        raise HandoffCorrupt(
            f'kv: blob decoded to {type(handoff).__name__}, not KVHandoff')
    return handoff


class KVStripStore:
    """The prefill side's outbox on the blob-request plane.

    Packed handoffs are :meth:`offer`'d under their ``kv:{request}``
    key; :meth:`attach` chains :meth:`answer` into a transport's
    ``on_blob_request`` (the chainable-receiver discipline of the
    reference's ``Tracer.accept_blob`` — keys that are not ours fall through
    to whatever hook was installed before). Entries live until
    :meth:`release` (the decode side's ack), so a fetch that died
    mid-flight can simply retry."""

    def __init__(self) -> None:
        self._blobs: dict[str, bytes] = {}
        self._chained = None

    def offer(self, request_id: str, data: bytes) -> None:
        self._blobs[kv_namespace(request_id)] = bytes(data)

    def release(self, request_id: str) -> None:
        self._blobs.pop(kv_namespace(request_id), None)

    def __len__(self) -> int:
        return len(self._blobs)

    def attach(self, transport) -> None:
        self._chained = transport.on_blob_request
        transport.on_blob_request = self.answer

    def answer(self, key: str):
        data = self._blobs.get(key)
        if data is not None:
            return data
        return self._chained(key) if self._chained is not None else None


def fetch_handoff(transport, peer: int, request_id: str,
                  timeout: float = 30.0) -> KVHandoff:
    """Decode-side pull: fetch ``kv:{request}`` from ``peer`` over the
    chunked digest-verified blob plane and unpack it. Raises
    :class:`~tpusystem_torch.parallel.multihost.BlobError` when the peer has
    no such strip (not exported yet, or already released) and
    :exc:`HandoffCorrupt` on a payload that fails verification."""
    return unpack_handoff(
        transport.fetch_blob(peer, kv_namespace(request_id),
                             timeout=timeout))
