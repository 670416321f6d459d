"""Per-tenant control-plane namespaces: the blast-radius isolation layer.

One physical mesh, N jobs, ONE shared event bus — the first thing a
multi-tenant orchestrator must guarantee is that tenant A's events never
fire tenant B's handlers. The pattern already exists in miniature:
``recsys.eval.evaluation_consumer(subject=)`` guards its ``Trained``
handler with *"is this event about my model?"* so two models sharing a
bus cannot cross-evaluate. This module generalizes that guard from one
handler to ANY consumer and stamps the subject at dispatch, so it works
for events that carry no ``model`` field at all (the whole serving
lifecycle — ``RequestCompleted`` has only an id):

* :func:`subject_of` — where an event's tenant identity lives: the
  ``tenant`` attribute a :class:`TenantBus` stamps, falling back to the
  ``model``/``model.id`` convention ``evaluation_consumer`` reads.
* :func:`scoped` — wrap any :class:`~tpusystem_torch.services.prodcon.
  Consumer` so it only ever consumes its own tenant's events. Foreign
  and *unattributed* events are both dropped — on a multi-tenant bus an
  event nobody claimed is a wiring bug, and delivering it to everyone
  would be exactly the cross-job leak this layer exists to prevent.
* :class:`TenantBus` — one tenant's facade over the shared
  :class:`~tpusystem_torch.services.prodcon.Producer`: ``dispatch`` stamps the
  tenant onto the event, ``register`` scopes the consumer. A job wired
  through its bus cannot observe (or be observed by) another job, yet
  fleet-wide taps (ledger, flight recorder) on the underlying producer
  still see the whole narrative.
* :class:`LeakAudit` — the certification witness: records every
  delivery whose subject is NOT the expected tenant, so the cross-tenant
  chaos drill can assert ``leaks == []`` instead of trusting the filter.
* :class:`NamespacedWriter` — the TensorBoard face of the same idea: a
  tag-prefixing wrapper over :class:`~tpusystem_torch.observe.tensorboard.
  SummaryWriter`, so every tenant's ``serve/*``/``supervisor/*`` charts
  land under ``{tenant}/...`` in ONE logdir instead of overwriting each
  other.
"""

from __future__ import annotations

from typing import Any

from tpusystem_torch.services.prodcon import Consumer, Producer

__all__ = ['subject_of', 'scoped', 'ScopedConsumer', 'TenantBus',
           'LeakAudit', 'NamespacedWriter']


def subject_of(event: Any) -> Any:
    """The tenant identity an event is about, or None when unattributed.

    Resolution order: the ``tenant`` attribute stamped by
    :meth:`TenantBus.dispatch`, then the ``model`` aggregate's ``id``
    (the ``evaluation_consumer`` convention), then the ``model`` object
    itself. Events shaped like neither (a bare ``RequestCompleted`` on a
    single-job bus) resolve to None — attributable only by stamping.
    """
    tenant = getattr(event, 'tenant', None)
    if tenant is not None:
        return tenant
    model = getattr(event, 'model', None)
    if model is None:
        return None
    return getattr(model, 'id', model)


class ScopedConsumer:
    """A consumer that only consumes its own tenant's events.

    Quacks like :class:`~tpusystem_torch.services.prodcon.Consumer` for the
    producer's purposes (``consume`` is the whole fan-out surface);
    ``handlers``/``types``/``dependency_overrides`` proxy through so
    composition roots can keep wiring the inner consumer's DI seams
    after scoping it.
    """

    def __init__(self, inner: Consumer, subject: Any) -> None:
        self.inner = inner
        self.subject = subject
        self.name = f'{getattr(inner, "name", None) or "consumer"}' \
                    f'@{subject}'

    @property
    def handlers(self):
        return self.inner.handlers

    @property
    def types(self):
        return self.inner.types

    @property
    def dependency_overrides(self):
        return self.inner.dependency_overrides

    def matches(self, event: Any) -> bool:
        subject = subject_of(event)
        if subject is None:
            return False             # unattributed: nobody's business
        return subject is self.subject or subject == self.subject

    def consume(self, event: Any) -> None:
        if self.matches(event):
            self.inner.consume(event)


def scoped(consumer: Consumer, subject: Any) -> ScopedConsumer:
    """Scope ``consumer`` to one tenant on a shared bus — the
    ``evaluation_consumer(subject=)`` guard generalized to any consumer
    (serve metrics, sentinel charts, tensorboard, ...). Events whose
    :func:`subject_of` is a different tenant — or None — never reach the
    inner handlers."""
    return ScopedConsumer(consumer, subject)


class TenantBus:
    """One tenant's view of the shared control plane.

    ``dispatch`` stamps ``event.tenant = tenant`` before handing the
    event to the shared producer (events are plain dataclasses — the
    stamp rides the instance and packs with it through journals and
    ledgers); ``register`` scopes every consumer with :func:`scoped`.
    The result: a job wired entirely through its bus emits and observes
    exactly its own namespace, while taps on the shared producer (the
    hash-chain ledger, the flight recorder) still witness the fleet-wide
    stream in one order.

    Events that already carry a *different* tenant stamp are refused
    (``ValueError``) rather than silently re-stamped — re-attributing
    another job's event is precisely the corruption this layer guards
    against.
    """

    def __init__(self, producer: Producer, tenant: Any) -> None:
        if tenant is None:
            raise ValueError('a tenant bus needs a non-None tenant '
                             'identity — None is the "unattributed" '
                             'sentinel scoped consumers drop')
        self.producer = producer
        self.tenant = tenant

    def dispatch(self, event: Any) -> None:
        stamped = getattr(event, 'tenant', None)
        if stamped is not None and stamped != self.tenant:
            raise ValueError(
                f'event {type(event).__name__} already belongs to tenant '
                f'{stamped!r}; refusing to re-stamp it as {self.tenant!r}')
        try:
            event.tenant = self.tenant
        except AttributeError:       # frozen/slotted payloads still route
            object.__setattr__(event, 'tenant', self.tenant)
        self.producer.dispatch(event)

    def register(self, *consumers: Consumer) -> None:
        self.producer.register(*(scoped(consumer, self.tenant)
                                 for consumer in consumers))


class LeakAudit:
    """The negative witness for the chaos certifier: a consumer that
    records every event delivered to it whose subject is NOT ``tenant``.

    Register it UNSCOPED next to a tenant's scoped consumers — on a
    correctly namespaced bus it sees the whole stream and its ``leaks``
    list stays empty of that tenant's *deliveries* only if the scoped
    consumers were the ones filtering. The certifier instead registers
    it through the tenant's own wiring path: any foreign event that
    reaches it IS a cross-tenant leak, reported as
    ``(tenant, foreign_subject, event_type)``.
    """

    def __init__(self, tenant: Any) -> None:
        self.tenant = tenant
        self.leaks: list = []
        self.seen = 0

    def consume(self, event: Any) -> None:
        self.seen += 1
        subject = subject_of(event)
        if not (subject is self.tenant or subject == self.tenant):
            self.leaks.append((self.tenant, subject,
                               type(event).__name__))


class NamespacedWriter:
    """Tag-prefixing wrapper over a shared
    :class:`~tpusystem_torch.observe.tensorboard.SummaryWriter`: every
    ``add_scalar('serve/tok_s', ...)`` lands as
    ``{prefix}/serve/tok_s``, so N tenants chart into one logdir
    without colliding. ``close`` only flushes — the underlying writer
    is shared and owned by the composition root."""

    def __init__(self, board: Any, prefix: str) -> None:
        if not prefix:
            raise ValueError('a namespaced writer needs a non-empty '
                             'prefix (the tenant name)')
        self.board = board
        self.prefix = prefix

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.board.add_scalar(f'{self.prefix}/{tag}', value, step)

    def add_scalars(self, main_tag: str, values: dict, step: int) -> None:
        self.board.add_scalars(f'{self.prefix}/{main_tag}', values, step)

    def flush(self) -> None:
        self.board.flush()

    close = flush
