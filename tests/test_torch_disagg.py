"""Disaggregated serving on the port: the engine's hand-off seam, KV
hand-offs over the blob plane, and the role-aware fleet.

Twins of ``tests/test_serve_disagg.py``'s ``TestHandoffWire``,
``TestExportAdmit``, ``TestAuditUnderAdoptChurn``, ``TestRoleFleet``,
``TestRoleChaosDrill`` and ``TestRoleAutoscale``. Each drill with engines
runs the same requests through both packages (``tests/torch_serving.py``)
on ``gpt2_tiny`` and, where the engine seam is under test, ``llama_tiny``,
float32 on the CPU: the token streams, the completion reasons and the
events' fields are equal, and exported strips agree within 1e-5. One
case crosses the packages: strips the reference exported, renamed to the
port's cache paths, seat on the port and decode the reference's stream.

Left out, with the ROADMAP queue 1 item each waits for:

* tensor parallelism (9): ``submesh``, ``TestDecodeTpPlan``,
  ``TestShardedEngine``, ``TestReasonMatrix``'s mesh cases and every
  ``mesh=`` case.

``test_sharing_counters_and_trace_parentage_survive_the_role_hop`` is two
tests here: its sharing half on both families, its trace half on
``gpt2_tiny``.
"""

import json

import pickle
import re

import numpy as np
import pytest
import torch

from tests.torch_serving import (BOTH, PORT, REF, FakeClock, Served, plain,
                                 span_tree)
from tests.torch_serving import witness
from tpusystem_torch.parallel.multihost import Loopback, _blob_digest
from tpusystem_torch.serve import (HandoffCorrupt, KVHandoff, KVStripStore,
                                   Request, RoleMismatch, Scheduler,
                                   ServingReplica, fetch_handoff,
                                   kv_namespace, pack_handoff,
                                   unpack_handoff)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def gpt2():
    return Served('gpt2')


@pytest.fixture(scope='module')
def llama():
    return Served('llama')


@pytest.fixture(params=['gpt2', 'llama'])
def family(request, gpt2, llama):
    return gpt2 if request.param == 'gpt2' else llama


def port_path(keystr: str) -> str:
    """The port's cache path of a reference ``keystr`` path:
    ``"['h_0']['attn']['key']"`` -> ``'h_0/attn/key'``."""
    return '/'.join(re.findall(r"\['([^']*)'\]", keystr))


def drain(engine, steps=64):
    """Step until every row retires; returns tag -> emitted tokens."""
    tokens: dict = {}
    for _ in range(steps):
        report = engine.step()
        for row, new in report.emitted.items():
            tokens.setdefault(row, []).extend(int(t) for t in new)
        if not engine.active_rows:
            break
    return tokens


def prefill_calls(engine) -> list:
    """Record every prefill ``engine`` runs: its full prefill
    (``_prefill``) and its resumed one (``_resume``), the only two."""
    calls = []
    for name in ('_prefill', '_resume'):
        def counted(*args, _run=getattr(engine, name), _name=name):
            calls.append(_name)
            return _run(*args)
        setattr(engine, name, counted)
    return calls


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


class TestHandoffWire:

    def _handoff(self):
        return KVHandoff(request=Request('a', [1, 2, 3], 4), first=7,
                         kv={'k': torch.arange(6, dtype=torch.bfloat16)},
                         prefix=[9], waited=1.5)

    def test_pack_unpack_roundtrip(self):
        received = unpack_handoff(pack_handoff(self._handoff()))
        assert received.request.id == 'a'
        assert (received.first, received.prefix,
                received.waited) == (7, [9], 1.5)
        # a bfloat16 strip crosses as itself, not widened
        assert received.kv['k'].dtype == torch.bfloat16
        assert torch.equal(received.kv['k'],
                           torch.arange(6, dtype=torch.bfloat16))

    def test_corrupt_payload_is_typed(self):
        data = bytearray(pack_handoff(self._handoff()))
        data[-1] ^= 0xFF
        with pytest.raises(HandoffCorrupt, match='digest'):
            unpack_handoff(bytes(data))
        with pytest.raises(HandoffCorrupt):
            unpack_handoff(data[: len(data) // 2])

    def test_wrong_object_is_typed(self):
        payload = pickle.dumps({'not': 'a handoff'})
        framed = _blob_digest(payload).encode('ascii') + b':' + payload
        with pytest.raises(HandoffCorrupt, match='not KVHandoff'):
            unpack_handoff(framed)

    def test_strip_store_offers_answers_releases(self):
        wire = Loopback()
        store = KVStripStore()
        store.attach(wire)
        store.offer('a', b'payload')
        assert wire.fetch_blob(0, kv_namespace('a')) == b'payload'
        assert len(store) == 1
        store.release('a')
        assert len(store) == 0

    def test_strip_store_chains_the_prior_hook(self):
        wire = Loopback()
        wire.on_blob_request = lambda key: b'prior' if key == 'x' else None
        store = KVStripStore()
        store.attach(wire)
        store.offer('a', b'strip')
        assert wire.on_blob_request(kv_namespace('a')) == b'strip'
        assert wire.on_blob_request('x') == b'prior'  # falls through

    def test_fetch_handoff_verifies_end_to_end(self):
        wire = Loopback()
        store = KVStripStore()
        store.attach(wire)
        store.offer('a', pack_handoff(self._handoff()))
        received = fetch_handoff(wire, 0, 'a')
        assert received.request.id == 'a'
        corrupt = bytearray(pack_handoff(self._handoff()))
        corrupt[-1] ^= 0xFF
        store.offer('b', bytes(corrupt))
        with pytest.raises(HandoffCorrupt):
            fetch_handoff(wire, 0, 'b')

    def test_digest_and_namespace_are_the_references(self):
        from tpusystem.parallel.multihost import _blob_digest as reference
        from tpusystem.serve import kv_namespace as reference_namespace
        for data in (b'', b'strip', bytes(range(256)) * 9):
            assert _blob_digest(data) == reference(data)
        assert kv_namespace('r7') == reference_namespace('r7')


# ---------------------------------------------------------------------------
# export_prefill -> admit_prefilled: the engine seam
# ---------------------------------------------------------------------------


def _export_admit(P, served, prompts, budget=6, sampling=None):
    """The reference's colocated run and its disaggregated twin on ``P``:
    (colocated streams, disaggregated streams, colocated and exported first
    tokens, the prefiller's live rows and blocks after the exports)."""
    colocated = served.engine(P, rows=2, block_size=8)
    admitted = [colocated.admit(prompt, budget, tag=f'r{index}',
                                sampling=sampling).token
                for index, prompt in enumerate(prompts)]
    reference = drain(colocated)
    prefiller = served.engine(P, rows=2, block_size=8)
    decoder = served.engine(P, rows=2, block_size=8)
    firsts = []
    for index, prompt in enumerate(prompts):
        first, kv = prefiller.export_prefill(prompt, sampling=sampling)
        firsts.append(first)
        received = P.unpack_handoff(P.pack_handoff(P.KVHandoff(
            request=P.Request(f'r{index}', prompt, budget), first=first,
            kv=kv)))
        decoder.admit_prefilled(prompt, budget, received.first,
                                received.kv, tag=f'r{index}',
                                sampling=sampling)
    return (reference, drain(decoder), admitted, firsts,
            (prefiller.active_rows, prefiller.pool.live_blocks))


class TestExportAdmit:

    @pytest.mark.parametrize('sampled', [False, True])
    def test_prefill_on_a_decodes_on_b_token_exact(self, family, sampled):
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 256, (n,)).tolist() for n in (5, 9)]
        sampling = dict(seed=21, temperature=0.8, top_k=32) if sampled \
            else None
        runs = {P.root: _export_admit(
            P, family, prompts,
            sampling=None if sampling is None
            else P.SamplingParams(**sampling)) for P in BOTH}
        reference, decoded, admitted, firsts, prefiller = runs[PORT.root]
        # export seats nothing on the prefill engine
        assert prefiller == (0, 0)
        assert decoded == reference
        assert firsts == admitted
        assert runs[PORT.root] == runs[REF.root]

    def test_exported_strips_match_the_reference(self, family):
        prompt = np.random.default_rng(5).integers(0, 256, (11,)).tolist()
        first, kv = family.engine(REF, rows=2, block_size=8) \
            .export_prefill(prompt)
        port_first, port_kv = family.engine(PORT, rows=2, block_size=8) \
            .export_prefill(prompt)
        assert port_first == first
        assert sorted(port_kv) == sorted(port_path(name) for name in kv)
        for name, strip in kv.items():
            got = port_kv[port_path(name)]
            assert got.device.type == 'cpu' and got.dtype == torch.float32
            assert tuple(got.shape) == strip.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(strip),
                                       rtol=0, atol=1e-5)

    def test_reference_strips_seat_on_the_port(self, family):
        """Strips exported by the reference's engine, renamed to the port's
        paths, seated by the port's ``admit_prefilled``, decode the
        reference's own stream."""
        rng = np.random.default_rng(9)
        prompts = [rng.integers(0, 256, (n,)).tolist() for n in (6, 13)]
        reference = family.engine(REF, rows=2, block_size=8)
        port = family.engine(PORT, rows=2, block_size=8)
        exporter = family.engine(REF, rows=2, block_size=8)
        for index, prompt in enumerate(prompts):
            reference.admit(prompt, 7, tag=index)
            first, kv = exporter.export_prefill(prompt)
            port.admit_prefilled(prompt, 7, first,
                                 {port_path(name): torch.from_numpy(
                                     np.array(strip))
                                  for name, strip in kv.items()}, tag=index)
        assert drain(port) == drain(reference)

    def test_admit_prefilled_runs_no_prefill(self, family):
        prompt = list(range(1, 12))
        source = family.engine(PORT, rows=2, block_size=8)
        engine = family.engine(PORT, rows=2, block_size=8)
        exported = prefill_calls(source)
        calls = prefill_calls(engine)
        first, kv = source.export_prefill(prompt)
        assert exported == ['_prefill']
        engine.admit_prefilled(prompt, 5, first, kv)
        drain(engine)
        assert calls == []
        engine.admit(prompt, 5)             # the local path does prefill
        assert calls == ['_prefill']

    def test_export_validates_the_prompt(self, gpt2):
        engine = gpt2.engine(PORT, rows=2, block_size=8)
        with pytest.raises(ValueError, match='empty'):
            engine.export_prefill([])
        with pytest.raises(ValueError, match='decode room'):
            engine.export_prefill(list(range(engine.max_seq)))

    def test_geometry_mismatch_is_caught_before_seating(self, family):
        engine = family.engine(PORT, rows=2, block_size=8)
        first, kv = engine.export_prefill([1, 2, 3])
        missing = dict(kv)
        missing.pop(sorted(missing)[0])
        with pytest.raises(ValueError, match='missing KV leaf'):
            engine.admit_prefilled([1, 2, 3], 4, first, missing)
        short = {name: strip[:, :-8] for name, strip in kv.items()}
        with pytest.raises(ValueError, match='same module geometry'):
            engine.admit_prefilled([1, 2, 3], 4, first, short)
        assert engine.active_rows == 0     # nothing half-seated
        assert engine.pool.live_blocks == 0 and engine.free_rows == 2

    def test_speculative_engine_refuses_before_seating(self, gpt2):
        source = gpt2.engine(PORT, rows=2, block_size=8)
        engine = gpt2.engine(PORT, rows=2, block_size=8, draft=True,
                             speculate=3)
        first, kv = source.export_prefill([1, 2, 3])
        with pytest.raises(ValueError, match='speculative rows'):
            engine.admit_prefilled([1, 2, 3], 4, first, kv)
        assert engine.active_rows == 0 and engine.pool.live_blocks == 0

    def test_replayed_prefix_continues_the_sampled_stream(self, gpt2):
        """A hand-off carrying a replayed prefix (``emitted=``): the first
        token samples at ``(seed, len(emitted))`` on the prefill side and the
        decode side continues the stream, equal to the reference's."""
        prompt = np.random.default_rng(11).integers(0, 256, (7,)).tolist()
        out = {}
        for P in BOTH:
            sampling = P.SamplingParams(seed=5, temperature=0.9)
            whole = gpt2.engine(P, rows=1, block_size=8)
            whole.admit(prompt, 9, sampling=sampling)
            stream = [whole.tokens(0)[0]] + [t for ts in drain(whole)
                                             .values() for t in ts]
            prefix = stream[:3]
            source = gpt2.engine(P, rows=1, block_size=8)
            engine = gpt2.engine(P, rows=1, block_size=8)
            first, kv = source.export_prefill(prompt + prefix,
                                              sampling=sampling,
                                              emitted=prefix)
            engine.admit_prefilled(prompt + prefix, 6, first, kv,
                                   sampling=sampling, emitted=prefix)
            resumed = [first] + [t for ts in drain(engine).values()
                                 for t in ts]
            assert prefix + resumed == stream
            out[P.root] = stream
        assert out[PORT.root] == out[REF.root]

    def test_adopted_strips_share_prefix_blocks(self, family):
        """Strip adoptions run through the radix index exactly like local
        admissions: the second adopted request with the same head scores a
        prefix hit and shares blocks."""
        sharing = {}
        for P in BOTH:
            source = family.engine(P, rows=2, block_size=8)
            engine = family.engine(P, rows=4, block_size=8,
                                   share_prefix=True)
            head = list(range(1, 17))
            for index, tail in enumerate(([21, 22], [23, 24])):
                first, kv = source.export_prefill(head + tail)
                engine.admit_prefilled(head + tail, 4, first, kv,
                                       tag=f'r{index}')
            assert engine.sharing['prefix_hits'] >= 1
            assert engine.sharing['shared_tokens'] >= 16
            engine.pool.audit()
            sharing[P.root] = (dict(engine.sharing), drain(engine))
        assert sharing[PORT.root] == sharing[REF.root]


# ---------------------------------------------------------------------------
# pool audit under adopted-strip churn at refcount boundaries
# ---------------------------------------------------------------------------


def _adopt_churn(P, served):
    source = served.engine(P, rows=2, block_size=8)
    engine = served.engine(P, rows=4, block_size=8, share_prefix=True)
    head = list(range(1, 17))            # two full shared blocks
    audits = []

    def seat(tag, tail):
        first, kv = source.export_prefill(head + tail)
        return engine.admit_prefilled(head + tail, 3, first, kv, tag=tag)
    a = seat('a', [31, 32])              # refs 0 -> 1
    audits.append(engine.pool.audit())
    b = seat('b', [33, 34])              # refs 1 -> 2 (shared head)
    audits.append(engine.pool.audit())
    engine.evict(a.row)                  # refs 2 -> 1: b still owns
    audit = engine.pool.audit()
    assert audit['live'] > 0
    audits.append(audit)
    c = seat('c', [35, 36])              # re-share while b holds
    audits.append(engine.pool.audit())
    engine.evict(b.row)
    engine.evict(c.row)                  # refs -> 0: head goes warm
    audit = engine.pool.audit()
    assert audit['cached'] > 0, 'shared head should park warm'
    audits.append(audit)
    d = seat('d', [37, 38])              # warm -> re-owned
    audits.append(engine.pool.audit())
    assert engine.sharing['prefix_hits'] >= 3
    engine.evict(d.row)
    final = engine.pool.audit()
    assert final['live'] == 0
    return audits + [final], dict(engine.sharing)


def _interleaved(P, served):
    source = served.engine(P, rows=2, block_size=8)
    engine = served.engine(P, rows=4, block_size=8, share_prefix=True)
    head = list(range(40, 56))
    local = engine.admit(head + [1], 3, tag='local')
    audits = [engine.pool.audit()]
    first, kv = source.export_prefill(head + [2])
    adopted = engine.admit_prefilled(head + [2], 3, first, kv,
                                     tag='adopted')
    audits.append(engine.pool.audit())
    assert engine.sharing['prefix_hits'] >= 1
    engine.evict(local.row)              # the original owner first
    audits.append(engine.pool.audit())
    engine.evict(adopted.row)
    audits.append(engine.pool.audit())
    assert audits[-1]['live'] == 0
    return audits, dict(engine.sharing)


class TestAuditUnderAdoptChurn:

    def test_audit_across_adopt_free_churn(self, gpt2):
        assert _adopt_churn(PORT, gpt2) == _adopt_churn(REF, gpt2)

    def test_audit_interleaved_local_and_adopted(self, gpt2):
        assert _interleaved(PORT, gpt2) == _interleaved(REF, gpt2)


# ---------------------------------------------------------------------------
# the role-aware fleet
# ---------------------------------------------------------------------------


def role_fleet(P, served, clock, roles, *, wire=None, producer=None,
               rows=2, clients=None, tracers=None, **engine_knobs):
    """One replica per role string; a shared ``Loopback`` ``wire`` puts the
    hand-offs on the blob plane; ``clients`` gives each replica a journal
    store that outlives a kill; with a ``tracers`` list each scheduler
    traces into its own ``P.Tracer`` (appended) and the router into
    ``router.tracer``. Returns (router, handles)."""
    handles = []
    for index, role in enumerate(roles):
        tracer = None
        if tracers is not None:
            tracer = P.Tracer(f'rep{index}', clock=clock)
            tracers.append(tracer)

        def build(role=role, tracer=tracer):
            return P.Scheduler(
                served.engine(P, rows=rows, block_size=8, **engine_knobs),
                clock=clock, prefill_only=(role == 'prefill'),
                tracer=tracer)
        replica = P.ServingReplica(build, identity=f'rep{index}',
                                   clock=clock, role=role,
                                   client=clients[index] if clients
                                   else None)
        handles.append(P.ReplicaHandle(replica, transport=wire, rank=0))
    router = P.Router(handles, clock=clock, producer=producer,
                      tracer=None if tracers is None
                      else P.Tracer('router', clock=clock))
    return router, handles


def reference_results(P, served, clock, requests, **engine_knobs):
    def build():
        return P.Scheduler(served.engine(P, rows=2, block_size=8,
                                         **engine_knobs), clock=clock)
    router = P.Router([P.ReplicaHandle(P.ServingReplica(
        build, identity='colo', clock=clock))], clock=clock)
    for rid, prompt, budget in requests:
        router.submit(P.Request(rid, list(prompt), budget))
    return router.run_until_idle()


def mixed_requests(seed=7, n=6):
    rng = np.random.default_rng(seed)
    lengths = (5, 9, 7, 4, 11, 6, 8, 5, 10)[:n]
    budgets = (8, 6, 9, 5, 7, 8, 6, 9, 7)[:n]
    return [(f'r{i}', rng.integers(0, 256, (k,)).tolist(), b)
            for i, (k, b) in enumerate(zip(lengths, budgets))]


def sampled_specs(seed=13, n=5):
    """Mixed greedy and seeded-sampled prompts sharing a system-prompt
    head, so ``share_prefix=True`` radix hits ride the drill too."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 256, (10,)).tolist()
    specs = []
    for i, k in enumerate((3, 5, 2, 4, 6)[:n]):
        tail = rng.integers(0, 256, (k,)).tolist()
        sampling = (dict(temperature=0.7, seed=300 + i, top_k=16)
                    if i % 2 == 0 else None)
        specs.append((f's{i}', head + tail, 5 + (i % 3), sampling))
    return specs


def sampled_requests(P, specs):
    """Fresh requests from specs (one set per fleet)."""
    return [P.Request(rid, list(prompt), budget,
                      sampling=None if sampling is None
                      else P.SamplingParams(**sampling))
            for rid, prompt, budget, sampling in specs]


def sampled_reference(P, served, clock, specs):
    def build():
        return P.Scheduler(served.engine(P, rows=2, block_size=8,
                                         share_prefix=True), clock=clock)
    router = P.Router([P.ReplicaHandle(P.ServingReplica(
        build, identity='colo', clock=clock))], clock=clock)
    for request in sampled_requests(P, specs):
        router.submit(request)
    return router.run_until_idle()


def handoff_fields(events) -> list:
    """``PrefillHandoff`` events as comparable fields."""
    return [(e.id, e.origin, e.target, e.tokens, e.bytes) for e in events]


class TestRoleFleet:

    def test_prefill_only_scheduler_refuses_hot_restores(self, gpt2):
        clock = FakeClock()
        scheduler = Scheduler(gpt2.engine(PORT, rows=2, block_size=8),
                              clock=clock, prefill_only=True)
        with pytest.raises(RoleMismatch):
            scheduler.restore(Request('a', [1, 2], 4), waited=1.0,
                              prefix=[5])
        assert not isinstance(RoleMismatch('x'), ValueError)

    def test_role_and_scheduler_contract_must_agree(self, gpt2):
        clock = FakeClock()
        with pytest.raises(ValueError, match='must agree'):
            ServingReplica(
                lambda: Scheduler(gpt2.engine(PORT, rows=2, block_size=8),
                                  clock=clock),
                identity='bad', clock=clock, role='prefill')

    def test_disagg_fleet_token_exact_over_blob_plane(self, family):
        """The acceptance path: prompts admitted on the prefill replica,
        strips shipped over the blob plane, every request decoded on a
        decode replica, token-exact against colocated serving, strips
        released on ack, and the move narrated as ``PrefillHandoff``; the
        port's run is the reference's, event for event."""
        requests = mixed_requests()
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            reference = reference_results(P, family, clock, requests)
            wire = P.Loopback()
            producer = P.Producer()
            router, handles = role_fleet(
                P, family, clock, ('prefill', 'decode', 'decode'),
                wire=wire, producer=producer)
            seen = witness(P, producer, 'PrefillHandoff')
            for rid, prompt, budget in requests:
                assert router.submit(P.Request(rid, list(prompt), budget)) \
                    == 'rep0'        # every prompt lands on the prefill tier
            moved = []
            for _ in range(400):
                if router.idle:
                    break
                moved.extend(router.step().handoffs)
            assert router.idle
            assert sorted(moved) == sorted(rid for rid, _, _ in requests)
            assert set(router.results) == set(reference)
            for rid, completion in router.results.items():
                assert completion.tokens == reference[rid].tokens, rid
                assert completion.reason == reference[rid].reason, rid
            assert len(seen) == len(requests)
            assert all(event.origin == 'rep0' and event.bytes > 0
                       and event.target in ('rep1', 'rep2')
                       for event in seen)
            assert handles[0].strips is not None \
                and len(handles[0].strips) == 0
            assert handles[0].scheduler.engine.active_rows == 0
            runs[P.root] = (plain(router.results), moved,
                            handoff_fields(seen), plain(reference))
        assert runs[PORT.root] == runs[REF.root]

    def test_corrupt_handoff_falls_back_to_cold_prefill(self, gpt2):
        """A payload torn on the wire must not seat: the router re-places
        the request cold on the decode tier and the completion is still
        token-exact."""
        requests = mixed_requests(n=2)
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            reference = reference_results(P, gpt2, clock, requests)
            wire = P.Loopback()
            producer = P.Producer()
            seen = witness(P, producer, 'HandoffCorrupted')
            router, handles = role_fleet(
                P, gpt2, clock, ('prefill', 'decode'), wire=wire,
                producer=producer)
            original = wire.fetch_blob

            def torn(peer, key, timeout=30.0, original=original):
                data = bytearray(original(peer, key, timeout))
                data[-1] ^= 0xFF
                return bytes(data)
            wire.fetch_blob = torn
            for rid, prompt, budget in requests:
                router.submit(P.Request(rid, list(prompt), budget))
            results = router.run_until_idle()
            for rid, _, _ in requests:
                assert results[rid].tokens == reference[rid].tokens, rid
            assert {event.id for event in seen} == {'r0', 'r1'}
            runs[P.root] = (plain(results), plain(seen))
        assert runs[PORT.root] == runs[REF.root]

    def test_handoff_parks_until_a_decode_replica_exists(self, gpt2):
        """No healthy decode target: the strip parks in the undelivered
        queue (the fleet is not idle) and delivers the moment a decode
        replica is adopted."""
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            router, handles = role_fleet(P, gpt2, clock, ('prefill',))
            router.submit(P.Request('a', [1, 2, 3, 4], 5))
            for _ in range(5):
                router.step()
            assert not router.idle and len(router._undelivered) == 1

            def build():
                return P.Scheduler(gpt2.engine(P, rows=2, block_size=8),
                                   clock=clock)
            router.adopt(P.ReplicaHandle(
                P.ServingReplica(build, identity='late', clock=clock,
                                 role='decode')))
            results = router.run_until_idle()
            reference = reference_results(P, gpt2, clock,
                                          [('a', [1, 2, 3, 4], 5)])
            assert results['a'].tokens == reference['a'].tokens
            runs[P.root] = plain(results)
        assert runs[PORT.root] == runs[REF.root]

    def test_sharing_counters_survive_the_role_hop(self, family):
        """Requests sharing a system prompt hop from the prefill replica to
        a decode replica: the decode-side radix pool scores the prefix hits
        (sharing works through adopted strips)."""
        rng = np.random.default_rng(19)
        head = rng.integers(0, 256, (12,)).tolist()
        requests = [(f'r{i}', head + rng.integers(0, 256, (k,)).tolist(), 5)
                    for i, k in enumerate((3, 2, 4))]
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            reference = reference_results(P, family, clock, requests,
                                          share_prefix=True)
            router, handles = role_fleet(P, family, clock,
                                         ('prefill', 'decode'),
                                         share_prefix=True)
            for rid, prompt, budget in requests:
                router.submit(P.Request(rid, list(prompt), budget))
            results = router.run_until_idle()
            for rid, _, _ in requests:
                assert results[rid].tokens == reference[rid].tokens, rid
            sharing = handles[1].scheduler.engine.sharing
            assert sharing['prefix_hits'] >= 2
            assert sharing['shared_tokens'] > 0
            runs[P.root] = (plain(results), dict(sharing))
        assert runs[PORT.root] == runs[REF.root]

    def test_trace_parentage_survives_the_role_hop(self, gpt2, tmp_path):
        """The trace half of the reference's drill: requests sharing a
        system prompt hop from the prefill replica to the decode one, and
        the merged export holds ONE connected trace per request whose spans
        cross both replicas (queued/handoff on the prefill process,
        seated/decode on the decode one), zero orphans; the port's span
        tree is the reference's."""
        rng = np.random.default_rng(19)
        head = rng.integers(0, 256, (12,)).tolist()
        requests = [(f'r{i}', head + rng.integers(0, 256, (k,)).tolist(), 5)
                    for i, k in enumerate((3, 2, 4))]
        trees = {}
        for P in BOTH:
            clock, tracers = FakeClock(), []
            router, handles = role_fleet(P, gpt2, clock,
                                         ('prefill', 'decode'),
                                         tracers=tracers, share_prefix=True)
            for rid, prompt, budget in requests:
                router.submit(P.Request(rid, list(prompt), budget))
            router.run_until_idle()
            for tracer in tracers:
                router.tracer.merge(tracer)
            payload = json.loads(router.tracer.export(
                tmp_path / f'{P.root}-disagg.json').read_text())
            by_trace = P.connected_traces(payload['traceEvents'])
            events = [e for e in payload['traceEvents']
                      if e['ph'] in ('X', 'i')]
            processes = {e['pid']: e['args']['name']
                         for e in payload['traceEvents'] if e['ph'] == 'M'}
            for rid, _, _ in requests:
                roots = [e for e in events if e['name'] == f'request {rid}']
                assert len(roots) == 1, rid          # ONE trace per request
                group = by_trace[roots[0]['args']['trace_id']]
                crossed = {processes[e['pid']] for e in group
                           if processes[e['pid']].startswith('rep')}
                assert crossed == {'rep0', 'rep1'}, (rid, crossed)
                assert 'handoff' in {e['name'] for e in group}, rid
            trees[P.root] = span_tree(payload['traceEvents'])
        assert trees[PORT.root] == trees[REF.root]


def _rerouted(events) -> list:
    return [(e.id, e.origin, e.target, e.where, e.prefix, e.cause)
            for e in events]


class TestRoleChaosDrill:

    def test_kill_prefill_mid_transfer_token_exact(self, gpt2):
        """Kill the prefill replica while strips are queued or ready to
        ship: journal recovery re-homes its rows onto the second prefill
        replica (cold), nothing is dropped or double-decoded, and every
        completion is token-exact against an uninterrupted fleet."""
        requests = mixed_requests(n=6)
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            reference = reference_results(P, gpt2, clock, requests)
            router, handles = role_fleet(
                P, gpt2, clock, ('prefill', 'prefill', 'decode'))
            for rid, prompt, budget in requests:
                router.submit(P.Request(rid, list(prompt), budget))
            wave = P.PreemptionWave(step=2, kills=(handles[0].kill,))
            for _ in range(400):
                if router.idle:
                    break
                wave(router.ticks + 1)
                router.step()
            assert router.idle and wave.fired and not handles[0].healthy
            assert set(router.results) == set(reference)
            for rid, completion in router.results.items():
                assert completion.tokens == reference[rid].tokens, rid
                assert completion.reason == reference[rid].reason, rid
            runs[P.root] = plain(router.results)
        assert runs[PORT.root] == runs[REF.root]

    def test_kill_decode_mid_stream_token_exact(self, gpt2):
        """Kill a decode replica mid-decode: seated rows re-home hot
        (prompt and emitted prefix replayed on the surviving decode
        replica, never onto the prefill tier), token-exact."""
        requests = mixed_requests(n=6)
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            producer = P.Producer()
            seen = witness(P, producer, 'RequestRerouted')
            reference = reference_results(P, gpt2, clock, requests)
            router, handles = role_fleet(
                P, gpt2, clock, ('prefill', 'decode', 'decode'),
                producer=producer)
            for rid, prompt, budget in requests:
                router.submit(P.Request(rid, list(prompt), budget))
            victim = handles[1]
            wave = P.PreemptionWave(step=4, kills=(victim.kill,))
            placements = {}
            for _ in range(400):
                if router.idle:
                    break
                wave(router.ticks + 1)
                router.step()
                if not victim.healthy and 'v' not in placements:
                    placements['v'] = victim.placements
                assert handles[0].healthy, 'prefill replica must survive'
            assert router.idle and wave.fired and not victim.healthy
            assert victim.placements == placements['v']
            assert set(router.results) == set(reference)
            for rid, completion in router.results.items():
                assert completion.tokens == reference[rid].tokens, rid
                assert completion.reason == reference[rid].reason, rid
            assert handles[0].scheduler.engine.active_rows == 0
            runs[P.root] = (plain(router.results), _rerouted(seen))
        assert runs[PORT.root] == runs[REF.root]

    def test_kill_prefill_between_export_and_ship_token_exact(self, gpt2):
        """The prefill replica dies after ``export_prefill`` filled its
        outbox but before the router shipped a strip. No prefill survivor
        exists, so every row re-prefills cold on the decode tier, token-
        exact with ``share_prefix=True`` and seeded sampling."""
        specs = sampled_specs()
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            reference = sampled_reference(P, gpt2, clock, specs)
            producer = P.Producer()
            reroutes = witness(P, producer, 'RequestRerouted')
            router, handles = role_fleet(
                P, gpt2, clock, ('prefill', 'decode', 'decode'),
                producer=producer, share_prefix=True,
                clients=[P.MemStore() for _ in range(3)])
            for request in sampled_requests(P, specs):
                assert router.submit(request) == 'rep0'
            for _ in range(8):
                if handles[0].replica.scheduler.outbox:
                    break
                handles[0].replica.step()
            exported = [handoff.request.id
                        for handoff in handles[0].replica.scheduler.outbox]
            assert exported, 'prefill never exported a strip'
            handles[0].kill()
            results = router.run_until_idle()
            assert not handles[0].healthy
            assert set(results) == {rid for rid, _, _, _ in specs}
            for rid, completion in results.items():
                assert completion.tokens == reference[rid].tokens, rid
                assert completion.reason == reference[rid].reason, rid
            moved = {event.id: event for event in reroutes}
            assert set(moved) == set(results)
            assert all(event.where == 'cold'
                       and event.target in ('rep1', 'rep2')
                       for event in moved.values())
            runs[P.root] = (plain(results), exported, _rerouted(reroutes))
        assert runs[PORT.root] == runs[REF.root]

    def test_kill_decode_holding_seated_handoffs_token_exact(self, gpt2):
        """A decode replica dies holding rows it seated from shipped
        strips: its journal replays the rows hot onto the decode survivor,
        never to the prefill tier, token-exact with ``share_prefix=True``
        and seeded sampling."""
        specs = sampled_specs(seed=17)
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            reference = sampled_reference(P, gpt2, clock, specs)
            producer = P.Producer()
            reroutes = witness(P, producer, 'RequestRerouted')
            router, handles = role_fleet(
                P, gpt2, clock, ('prefill', 'decode', 'decode'),
                producer=producer, share_prefix=True,
                clients=[P.MemStore() for _ in range(3)])
            for request in sampled_requests(P, specs):
                router.submit(request)
            victim, shipped = None, []
            for _ in range(400):
                if router.idle:
                    break
                shipped.extend(router.step().handoffs)
                if victim is None and shipped:
                    seated = [handle for handle in handles[1:]
                              if handle.healthy
                              and handle.scheduler.engine.active_rows > 0]
                    if seated:
                        victim = seated[0]
                        victim.kill()
            assert router.idle and victim is not None \
                and not victim.healthy
            assert handles[0].healthy, 'prefill replica must survive'
            assert set(router.results) == {rid for rid, _, _, _ in specs}
            for rid, completion in router.results.items():
                assert completion.tokens == reference[rid].tokens, rid
                assert completion.reason == reference[rid].reason, rid
            from_victim = [event for event in reroutes
                           if event.origin == victim.name]
            assert from_victim, 'the dead decode replica held no rows?'
            survivor = ({'rep1', 'rep2'} - {victim.name}).pop()
            hot = [event for event in from_victim if event.where == 'hot']
            assert hot, 'no seated row re-homed hot'
            assert all(event.target == survivor for event in hot)
            assert handles[0].scheduler.engine.active_rows == 0
            runs[P.root] = (plain(router.results), victim.name,
                            _rerouted(reroutes))
        assert runs[PORT.root] == runs[REF.root]


class TestRoleAutoscale:

    def _provisioned(self, P, served, clock):
        built = []

        def provision(role='decode'):
            index = len(built)

            def build(role=role):
                return P.Scheduler(
                    served.engine(P, rows=2, block_size=8),
                    clock=clock, prefill_only=(role == 'prefill'))
            replica = P.ServingReplica(build, identity=f'grown{index}',
                                       clock=clock, role=role)
            built.append(role)
            return P.ReplicaHandle(replica)
        return built, provision

    def test_breathe_grows_the_decode_tier_for_parked_handoffs(self, gpt2):
        """Undelivered hand-offs are decode-tier pressure: the autoscaler
        provisions a decode replica and the parked strip seats on it."""
        runs = {}
        for P in BOTH:
            clock = FakeClock()
            router, handles = role_fleet(P, gpt2, clock, ('prefill',))
            built, provision = self._provisioned(P, gpt2, clock)
            router.autoscale = P.AutoscalePolicy(
                min_replicas=1, max_replicas=3, grow_after=1,
                shrink_after=10_000, cooldown=0)
            router._provision = provision
            router.submit(P.Request('a', [1, 2, 3, 4], 5))
            results = router.run_until_idle()
            assert built and built[0] == 'decode'
            reference = reference_results(P, gpt2, clock,
                                          [('a', [1, 2, 3, 4], 5)])
            assert results['a'].tokens == reference['a'].tokens
            runs[P.root] = (plain(results), built)
        assert runs[PORT.root] == runs[REF.root]

    def test_shrink_never_empties_a_tier(self, gpt2):
        """An idle split fleet shrinks, but never below one replica per
        tier."""
        clock = FakeClock()
        router, handles = role_fleet(PORT, gpt2, clock,
                                     ('prefill', 'decode'))
        router.autoscale = PORT.AutoscalePolicy(
            min_replicas=1, max_replicas=4, grow_after=10_000,
            shrink_after=1, cooldown=0)
        router._provision = lambda: None
        for _ in range(20):
            router.step()
        assert {handle.role for handle in router.healthy} \
            == {'prefill', 'decode'}

