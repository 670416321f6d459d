"""Shared pieces of the serving control plane's twins
(``tests/test_torch_{disagg,scheduler,failover,fleet,router_failover}.py``).

A twin drives the port's modules exactly as the reference's test drives the
reference's. :func:`package` bundles one package's serving names, so a
scenario written once against ``P`` runs on ``REF`` (``tpusystem``) and on
``PORT`` (``tpusystem_torch``); :class:`Served` holds one model's weights in
both packages (float32 on the CPU, carried over by ``params_from_jax``) and
builds either package's ``Engine`` on them. :func:`plain` turns completions
and events into data that compares across packages: a pickled row names its
class's module, so rows, tokens and event fields are compared, never
digests.
"""

from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np


def package(root: str) -> SimpleNamespace:
    """One package's serving names: everything ``{root}.serve`` exports,
    plus the chaos seams, the in-process ``MemStore``, the ``Loopback``
    blob plane, the events, the in-process buses and the span tracer."""
    serve = importlib.import_module(f'{root}.serve')
    names = {name: getattr(serve, name) for name in serve.__all__}
    chaos = importlib.import_module(f'{root}.parallel.chaos')
    memstore = importlib.import_module(f'{root}.checkpoint.memstore')
    prodcon = importlib.import_module(f'{root}.services.prodcon')
    trace = importlib.import_module(f'{root}.observe.trace')
    return SimpleNamespace(
        root=root, **names,
        certify=importlib.import_module(f'{root}.serve.certify'),
        events=importlib.import_module(f'{root}.observe.events'),
        PreemptionWave=chaos.PreemptionWave, DieAtStep=chaos.DieAtStep,
        StalledStep=chaos.StalledStep, WorkerKilled=chaos.WorkerKilled,
        Loopback=importlib.import_module(
            f'{root}.parallel.multihost').Loopback,
        blob_digest=memstore.blob_digest, MemStore=memstore.MemStore,
        Producer=prodcon.Producer, Consumer=prodcon.Consumer,
        Tracer=trace.Tracer, connected_traces=trace.connected_traces)


REF = package('tpusystem')
PORT = package('tpusystem_torch')
BOTH = (REF, PORT)


class FakeClock:
    """Injectable monotonic clock (the reference tests' own)."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def witness(P, producer, *event_types):
    """Collect the given event types (by name, from ``P``'s events)
    dispatched on ``producer``."""
    seen = []
    consumer = P.Consumer('probe')
    for event_type in event_types:
        if isinstance(event_type, str):
            event_type = getattr(P.events, event_type)
        consumer.register(event_type, seen.append)
    producer.register(consumer)
    return seen


def plain(value, *, seconds: bool = True):
    """``value`` as data that compares across packages: a ``Completion``
    becomes ``(id, tokens, reason[, seconds])``, an event ``(type name,
    fields)``, containers recursively. ``seconds=False`` drops wall-clock
    fields (completion seconds, ``ttft``, ``waited``, ``tokens_per_sec``)
    where a run reads the real clock."""
    if isinstance(value, dict):
        return {key: plain(item, seconds=seconds)
                for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(item, seconds=seconds) for item in value]
    if type(value).__name__ == 'Completion':
        out = (value.request.id, [int(t) for t in value.tokens],
               value.reason)
        return out + (value.seconds,) if seconds else out
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        fields = {field.name: getattr(value, field.name)
                  for field in dataclasses.fields(value)}
        if not seconds:
            for name in ('ttft', 'seconds', 'waited', 'tokens_per_sec'):
                fields.pop(name, None)
        return (type(value).__name__, fields)
    return value


def span_tree(events: list) -> list:
    """The spans of a tracer's export as data that compares across
    packages: process label, name, category, phase, timestamps and args
    (trace, span and parent ids included), in export order."""
    processes = {event['pid']: event['args']['name'] for event in events
                 if event['ph'] == 'M'}
    return [(processes[event['pid']], event['name'], event.get('cat'),
             event['ph'], event['ts'], event.get('dur'), event['args'])
            for event in events if event['ph'] in ('X', 'i')]


class Served:
    """One model's float32 weights in both packages: ``family`` is
    ``'gpt2'`` (``gpt2_tiny``) or ``'llama'`` (``llama_tiny``), initialised
    as the reference tests' ``served`` fixtures initialise them."""

    def __init__(self, family: str = 'gpt2', seed: int | None = None):
        from tpusystem.models import gpt2_tiny, llama_tiny
        from tpusystem_torch import models
        from tpusystem_torch.convert import params_from_jax
        seed = (0 if family == 'gpt2' else 1) if seed is None else seed
        reference = (gpt2_tiny if family == 'gpt2' else llama_tiny)(
            dtype='float32')
        prompt = jnp.asarray(
            np.random.default_rng(seed).integers(0, 256, (1, 8)), jnp.int32)
        params = reference.init(jax.random.PRNGKey(seed), prompt)['params']
        port = getattr(models, f'{family}_tiny')(dtype='float32',
                                                 device='cpu')
        self.family = family
        self._modules = {REF.root: reference, PORT.root: port}
        self._params = {REF.root: params, PORT.root: params_from_jax(params)}
        self._oracle: dict = {}

    def module(self, P):
        return self._modules[P.root]

    def params(self, P):
        return self._params[P.root]

    def knobs(self, P, knobs: dict) -> dict:
        """Engine keywords for ``P``: ``draft=True`` becomes the self-draft
        (``draft_module``/``draft_params`` of the same weights), and the
        port's engine is asked for the CPU."""
        knobs = dict(knobs)
        if knobs.pop('draft', False):
            knobs.update(draft_module=self.module(P),
                         draft_params=self.params(P))
        if P is PORT:
            knobs['device'] = 'cpu'
        return knobs

    def engine(self, P, **knobs):
        return P.Engine(self.module(P), self.params(P),
                        **self.knobs(P, knobs))

    def service(self, P, **knobs):
        """``P``'s ``InferenceService`` on these weights (its engine levers
        in ``knobs``; the port's on the CPU)."""
        return P.InferenceService(self.module(P), self.params(P),
                                  **self.knobs(P, knobs))

    def generate(self, prompt, steps: int) -> list:
        """The reference's standalone greedy decode of one prompt, the
        reference tests' parity oracle (cached)."""
        from tpusystem.train import generate
        key = (tuple(int(t) for t in prompt), steps)
        if key not in self._oracle:
            out = generate(self.module(REF), self.params(REF),
                           jnp.asarray(prompt, jnp.int32)[None],
                           steps=steps)
            self._oracle[key] = [int(t)
                                 for t in np.asarray(out)[0, len(prompt):]]
        return self._oracle[key]
