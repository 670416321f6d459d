"""Per-host runtime, one-process form: the port of :mod:`tpusystem.runtime`.

The reference's composition root is a single-process ``main.py``
(``examples/tinysys/main.py``); a job of many processes runs that
composition root once per host. :class:`Runtime` is the object that makes
the same ``main()`` correct in both worlds. The port has its one-process
form:

* the world is one process and the control plane a
  :class:`~tpusystem_torch.parallel.multihost.Loopback`; a coordinator
  (the argument or ``TPUSYSTEM_COORDINATOR``) or more than one process
  raises ``NotImplementedError`` (ROADMAP queue 1 item 9, which also holds
  the reference's ``TcpTransport``, ``Hub`` and ``connect``);
* :class:`~tpusystem_torch.parallel.multihost.DistributedProducer` /
  ``DistributedPublisher`` buses with rank-aware consumer placement, so
  storage/TensorBoard consumers register ``primary_only`` and run exactly
  once per experiment (SURVEY.md §5);
* optionally hash-chains the event stream
  (:class:`~tpusystem_torch.observe.EventLedger`);
* owns the epoch-boundary housekeeping — :meth:`sync` drains queued events
  and verifies the ledger; :meth:`should_stop` turns one host's stop wish
  into everyone's verdict before the next collective.

The epoch loop is the reference's::

    runtime = Runtime(preemption=True)
    runtime.producer.register(consumer)
    try:
        for epoch in range(epochs):
            try:
                service.handle('iterate', model, loaders, metrics)
                wants_stop = False
            except StopIteration:  # unhandled stop event unwound from commit
                wants_stop = True
            runtime.sync()         # Preempted raises here
            if runtime.should_stop(wants_stop):
                break
    finally:
        runtime.close()
"""

from __future__ import annotations

import os
import signal as signal_module

from tpusystem_torch.observe.ledger import EventLedger
from tpusystem_torch.parallel import multihost
from tpusystem_torch.parallel.multihost import (DistributedProducer,
                                                DistributedPublisher,
                                                Loopback, World)
from tpusystem_torch.parallel.recovery import Preempted


# The control-plane address of a job of many processes, resolved as the
# reference resolves it; the port's Runtime does not dial one yet.
def _control_address(coordinator: str | None,
                     control_port: int | None) -> tuple[str, int]:
    """Resolve where the control-plane hub lives for a multi-host job.

    Precedence: ``TPUSYSTEM_CONTROL=host:port`` env var; else the
    coordinator's host with ``control_port`` (or the coordinator port + 1).
    There is deliberately no localhost fallback — every host dialing its own
    loopback would "work" single-host and silently partition the job.
    """
    spec = os.environ.get('TPUSYSTEM_CONTROL')
    if spec:
        return _parse_hostport(spec, 'TPUSYSTEM_CONTROL')
    return _coordinator_derived(coordinator, control_port)


def _parse_hostport(spec: str, source: str) -> tuple[str, int]:
    host, separator, port = spec.rpartition(':')
    if not separator:
        raise ValueError(f'{source} must be host:port, got {spec!r}')
    return host, int(port)


def _coordinator_derived(coordinator: str | None,
                         control_port: int | None) -> tuple[str, int]:
    if coordinator:
        host, separator, port = coordinator.rpartition(':')
        if not separator:
            host, port = coordinator, None
        if control_port is not None:
            return host, control_port
        if port is not None:
            return host, int(port) + 1
    raise ValueError(
        'multi-host job without a control-plane address: set '
        'TPUSYSTEM_CONTROL=host:port, or pass coordinator="host:port" '
        '(control plane defaults to port+1)')


class Runtime:
    """Host-side runtime context for a training job of one process.

    Args:
        coordinator: ``host:port`` of a coordinator, or None to read
            ``TPUSYSTEM_COORDINATOR`` from the environment. Either, or
            ``num_processes`` above 1, raises ``NotImplementedError``: the
            port runs one process, whose control plane is a
            :class:`Loopback`.
        num_processes: the job's processes, as the reference takes them.
        ledger: hash-chain the event stream for divergence detection
            (:meth:`sync` then verifies it across hosts).
        preemption: install the SIGTERM preemption handler
            (:meth:`install_preemption_handler`) at construction. Off by
            default — signal handlers can only be installed from the main
            thread, and not every embedding owns the process's signals.
    """

    def __init__(self, coordinator: str | None = None, *,
                 num_processes: int | None = None,
                 ledger: bool = False,
                 preemption: bool = False) -> None:
        coordinator = coordinator or os.environ.get('TPUSYSTEM_COORDINATOR')
        self._preempt_signal: int | None = None
        self._previous_handlers: dict = {}
        self.world: World = multihost.initialize(coordinator, num_processes)
        self.transport = Loopback()
        self.producer = DistributedProducer(self.transport)
        self.publisher = DistributedPublisher(self.transport)
        self.ledger: EventLedger | None = (
            EventLedger().tap(self.producer) if ledger else None)
        if preemption:
            self.install_preemption_handler()

    @property
    def is_primary(self) -> bool:
        return self.world.is_primary

    def install_preemption_handler(
            self, *signals: int) -> None:
        """Arm preemption detection: the given signals (default SIGTERM —
        what most schedulers deliver before an eviction) set a flag, and
        the next :meth:`sync` raises
        :class:`~tpusystem_torch.parallel.recovery.Preempted` on the host
        loop thread.

        The handler itself only records the signal: raising from inside a
        signal handler could land mid-step or mid-save and tear exactly
        the state the emergency checkpoint needs intact. The raise happens
        at the :meth:`sync` drain point; when one epoch outlasts the
        scheduler's kill grace window, poll :attr:`preempted` inside the
        step loop and call :meth:`sync` when it trips (see :meth:`sync`).
        Must be called from the main thread (a Python signal-handling
        constraint); the previous handlers are restored by :meth:`close`.
        """
        if not signals:
            signals = (signal_module.SIGTERM,)

        def on_signal(signum, frame):
            self._preempt_signal = signum

        for signum in signals:
            previous = signal_module.signal(signum, on_signal)
            # a re-install must not record our own handler as 'previous',
            # or close() would leave it armed for the process's lifetime
            self._previous_handlers.setdefault(signum, previous)

    @property
    def preempted(self) -> bool:
        """True once a preemption signal arrived (sticky until the
        :class:`Preempted` raise hands control to the exit path)."""
        return self._preempt_signal is not None

    def sync(self) -> None:
        """Epoch-boundary housekeeping: deliver queued events on this
        thread, then (when enabled) verify the event hash-chain across
        hosts. Call once per epoch — never unconditionally per step. Raises
        :class:`~tpusystem_torch.parallel.recovery.Preempted` (after the
        drain, so queued events still deliver) when a preemption signal
        arrived since the last sync.

        When an epoch outlasts the scheduler's SIGTERM→SIGKILL grace
        window, guard the inner loop with the cheap :attr:`preempted` flag
        so the raise still lands at a step boundary::

            if runtime.preempted:
                runtime.sync()        # raises Preempted now, drained
        """
        self.producer.drain()
        self.publisher.drain()
        if self.ledger is not None:
            self.ledger.verify(self.transport)
        if self._preempt_signal is not None:
            raise Preempted(self._preempt_signal)

    def should_stop(self, wants_stop: bool) -> bool:
        """Collective early-stop verdict: any host wanting out stops all
        (the distributed form of the reference's exception-unwinding stop,
        ``torchsystem/domain/events.py:162-163``)."""
        return multihost.agree(self.transport, wants_stop, op='or')

    def barrier(self) -> None:
        """Host-level rendezvous (checkpoint commit points etc.); returns at
        once in one process."""
        self.transport.barrier()

    def close(self) -> None:
        try:
            for signum, handler in self._previous_handlers.items():
                signal_module.signal(signum, handler)
            self._previous_handlers.clear()
        except ValueError:
            # close() on a non-main thread cannot touch signal dispositions
            # (a Python constraint); never let that abort the transport
            # teardown below — the handler stays until the process exits
            pass
        self.transport.close()

    def __enter__(self) -> 'Runtime':
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
