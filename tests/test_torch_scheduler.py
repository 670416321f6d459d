"""The port's ``Scheduler``, ``serve_levers`` and ``InferenceService``.

Twins of the scheduler, ``serve_levers`` and ``InferenceService`` tests of
``tests/test_serve.py``, among them ``:794`` (speculative rows with prefix
sharing through the ``Scheduler``) and the ``Scheduler``-driven forms of
``:813`` and ``tests/test_serve_sampling.py:390`` (speculative rows under a
stop token and under sampling); and of the scheduler, service and
streaming tests of ``tests/test_serve_sampling.py``. Each scenario runs
through both packages on ``gpt2_tiny`` in float32 on the CPU
(``tests/torch_serving.py``): the port's completions (tokens, reasons) and
events equal the reference's, and its greedy streams equal the reference's
standalone ``generate``. Runs on the real clock compare everything but
wall-clock fields.

The TensorBoard consumer's serving charts
(``test_tensorboard_serve_handlers_chart_the_events``) are twinned in
``tests/test_torch_serve.py``. The compiled-step witness ``trace_count``
has no counterpart (the port compiles nothing, so the twins check the
streams alone).
"""

import time

import numpy as np
import pytest
import torch

from tests.torch_serving import PORT, REF, FakeClock, Served, plain, witness
from tpusystem_torch.serve import (InferenceService, Request, Scheduler,
                                   UnseededSampling, serve_levers)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def served():
    return Served('gpt2')


SAMPLED = dict(seed=11, temperature=0.9, top_k=16, top_p=0.95)


def twin(scenario, served, **kwargs):
    """Run ``scenario(P, served)`` on both packages; the port's record
    must equal the reference's. Returns the port's."""
    port = scenario(PORT, served, **kwargs)
    assert port == scenario(REF, served, **kwargs)
    return port


def sampled_reference(P, served, prompt, steps, sampling, **knobs):
    """One sampled request on a fresh engine, uninterrupted."""
    knobs = dict(dict(rows=2, block_size=8), **knobs)
    scheduler = P.Scheduler(served.engine(P, **knobs))
    scheduler.submit(P.Request('ref', list(prompt), steps,
                               sampling=P.SamplingParams(**sampling)))
    return scheduler.run()['ref'].tokens


# ---------------------------------------------------------------------------
# test_serve.py: the scheduler
# ---------------------------------------------------------------------------


def _free_list_exhaustion(P, served):
    rng = np.random.default_rng(13)
    # 8 allocatable blocks of 4 = 32 tokens; each request needs 3 blocks
    engine = served.engine(P, rows=2, block_size=4, blocks=7)
    scheduler = P.Scheduler(engine)
    prompts = [rng.integers(0, 256, (4,)) for _ in range(5)]
    for index, prompt in enumerate(prompts):
        scheduler.submit(P.Request(f'r{index}', list(prompt), max_new=6))
    saw_backlog, depths = False, []
    for _ in range(200):
        if scheduler.idle:
            break
        tick = scheduler.step()
        saw_backlog |= tick.queue_depth > 0
        depths.append((tick.queue_depth, tick.active))
        assert tick.active <= 2
    assert scheduler.idle, 'queue never drained'
    assert saw_backlog, 'workload never actually queued'
    for index, prompt in enumerate(prompts):
        assert scheduler.results[f'r{index}'].tokens == served.generate(
            prompt, 6), f'r{index} diverged under backlog'
    return plain(scheduler.results, seconds=False), depths


def test_free_list_exhaustion_queues_not_crashes(served):
    twin(_free_list_exhaustion, served)


def test_scheduler_refuses_never_fitting_requests(served):
    engine = served.engine(PORT, rows=2, block_size=8, blocks=4)
    scheduler = Scheduler(engine)
    with pytest.raises(ValueError, match='capacity'):
        scheduler.submit(Request('big', list(range(1, 100)), max_new=120))
    with pytest.raises(ValueError, match='blocks'):
        scheduler.submit(Request('wide', list(range(1, 30)), max_new=10))
    with pytest.raises(ValueError, match='non-empty'):
        scheduler.submit(Request('empty', [], max_new=4))


def _prefill_budget(P, served):
    rng = np.random.default_rng(17)
    engine = served.engine(P, rows=4, block_size=16)
    scheduler = P.Scheduler(engine, prefill_budget=16)
    for index in range(3):
        scheduler.submit(P.Request(f'r{index}',
                                   list(rng.integers(0, 256, (5,))),
                                   max_new=8))
    assert len(scheduler.step().admitted) == 1         # budget, not rows
    assert len(scheduler.step().admitted) == 1
    # a prompt wider than the whole budget still admits (alone)
    scheduler.submit(P.Request('wide', list(rng.integers(0, 256, (30,))),
                               max_new=4))
    admitted = {request.id
                for request, _, _ in scheduler.step().admitted}
    assert admitted == {'r2'}
    assert {request.id for request, _, _
            in scheduler.step().admitted} == {'wide'}
    return plain(scheduler.run(), seconds=False)


def test_prefill_budget_caps_admissions_per_step(served):
    twin(_prefill_budget, served)


def _cancellation(P, served):
    rng = np.random.default_rng(19)
    keep_prompt = rng.integers(0, 256, (6,))
    engine = served.engine(P, rows=2, block_size=8)
    scheduler = P.Scheduler(engine)
    scheduler.submit(P.Request('keep', list(keep_prompt), max_new=12))
    scheduler.submit(P.Request('dead', list(rng.integers(0, 256, (5,))),
                               max_new=12))
    scheduler.submit(P.Request('next', list(rng.integers(0, 256, (4,))),
                               max_new=3))                 # waits for a row
    scheduler.step()
    assert scheduler.queue_depth == 1
    scheduler.step()
    assert scheduler.cancel('dead') == 'active'
    cancelled = scheduler.results['dead']
    assert cancelled.reason == 'cancelled'
    assert 0 < len(cancelled.tokens) < 12
    results = scheduler.run()
    assert results['keep'].tokens == served.generate(keep_prompt, 12)
    assert results['next'].reason == 'length'
    assert scheduler.cancel('keep') is None              # already done
    return plain(results, seconds=False)


def test_cancellation_mid_decode_frees_the_row_and_spares_neighbors(served):
    twin(_cancellation, served)


def _foreign_rows(P, served):
    rng = np.random.default_rng(41)
    engine = served.engine(P, rows=1, block_size=8, blocks=5)
    engine.admit(rng.integers(0, 256, (5,)), max_new=6)   # foreign row
    scheduler = P.Scheduler(engine)
    scheduler.submit(P.Request('late', list(rng.integers(0, 256, (4,))),
                               max_new=5))
    results = scheduler.run()
    assert results['late'].reason == 'length'
    assert len(results['late'].tokens) == 5
    return plain(results, seconds=False)


def test_scheduler_tolerates_rows_admitted_directly_on_the_engine(served):
    twin(_foreign_rows, served)


def test_cancelling_a_queued_request_drops_it(served):
    engine = served.engine(PORT, rows=1, block_size=8)
    scheduler = Scheduler(engine)
    scheduler.submit(Request('q', [1, 2, 3], max_new=4))
    assert scheduler.cancel('q') == 'queued'
    assert scheduler.idle and 'q' not in scheduler.results


def _stop_token(P, served):
    prompt = np.random.default_rng(23).integers(0, 256, (7,))
    expected = served.generate(prompt, 12)
    stop = expected[3]
    first_hit = expected.index(stop)                     # tokens repeat
    scheduler = P.Scheduler(served.engine(P, rows=1, block_size=8))
    scheduler.submit(P.Request('s', list(prompt), max_new=12,
                               stop_token=stop))
    results = scheduler.run()
    assert results['s'].reason == 'stop'
    assert results['s'].tokens == expected[:first_hit + 1]  # stop included
    return plain(results, seconds=False)


def test_stop_token_completes_early(served):
    twin(_stop_token, served)


# ---------------------------------------------------------------------------
# test_serve.py: deadlines
# ---------------------------------------------------------------------------


def _deadline_queued(P, served):
    rng = np.random.default_rng(21)
    scheduler = P.Scheduler(served.engine(P, rows=1, block_size=8))
    prompt = list(rng.integers(0, 256, (4,)))
    scheduler.submit(P.Request('hog', prompt, max_new=12))
    scheduler.submit(P.Request('starved', prompt, max_new=4, deadline=0.05))
    tick = scheduler.step()                # hog seats; starved waits
    assert tick.queue_depth == 1 and not tick.expired
    time.sleep(0.08)
    tick = scheduler.step()
    assert [(completion.request.id, where)
            for completion, where in tick.expired] == [('starved', 'queued')]
    starved = scheduler.results['starved']
    assert starved.reason == 'expired' and starved.tokens == []
    assert starved.seconds >= 0.05
    scheduler.run()
    hog = scheduler.results['hog']
    assert hog.reason == 'length'
    assert hog.tokens == served.generate(prompt, 12)
    return plain(scheduler.results, seconds=False)


def test_deadline_expires_queued_requests_instead_of_starving(served):
    twin(_deadline_queued, served)


def _deadline_active(P, served):
    rng = np.random.default_rng(23)
    scheduler = P.Scheduler(served.engine(P, rows=2, block_size=8))
    slow = list(rng.integers(0, 256, (5,)))
    quick = list(rng.integers(0, 256, (6,)))
    scheduler.submit(P.Request('slow', slow, max_new=50, deadline=0.05))
    scheduler.submit(P.Request('quick', quick, max_new=6))
    scheduler.step()                       # both seated, decoding
    time.sleep(0.08)
    tick = scheduler.step()
    assert [(completion.request.id, where)
            for completion, where in tick.expired] == [('slow', 'active')]
    expired = scheduler.results['slow']
    assert expired.reason == 'expired'
    assert 0 < len(expired.tokens) < 50    # partial output survives
    scheduler.run()
    assert scheduler.results['quick'].tokens == served.generate(quick, 6)
    return plain(scheduler.results, seconds=False)


def test_deadline_evicts_active_requests_mid_decode(served):
    twin(_deadline_active, served)


def test_deadline_validation(served):
    scheduler = Scheduler(served.engine(PORT, rows=1, block_size=8))
    with pytest.raises(ValueError, match='deadline'):
        scheduler.submit(Request('bad', [1, 2, 3], max_new=4, deadline=0.0))


def _service_expired(P, served):
    rng = np.random.default_rng(27)
    producer = P.Producer()
    witnessed = witness(P, producer, 'RequestExpired')
    service = served.service(P, producer=producer, rows=1, block_size=8)
    prompt = list(rng.integers(0, 256, (4,)))
    service.submit(P.Request('hog', prompt, max_new=8))
    service.submit(P.Request('starved', prompt, max_new=4, deadline=0.05))
    service.step()
    time.sleep(0.08)
    service.run_until_idle()
    assert len(witnessed) == 1
    event = witnessed[0]
    assert event.id == 'starved' and event.where == 'queued'
    assert event.produced == 0 and event.waited >= 0.05
    return plain(witnessed, seconds=False), plain(service.results,
                                                  seconds=False)


def test_service_narrates_request_expired(served):
    twin(_service_expired, served)


# ---------------------------------------------------------------------------
# test_serve.py: the bus front door and the levers
# ---------------------------------------------------------------------------


def _service_lifecycle(P, served):
    rng = np.random.default_rng(29)
    producer = P.Producer()
    witnessed = witness(P, producer, 'RequestAdmitted', 'RequestCompleted',
                        'RequestEvicted', 'ServeStepped')
    service = served.service(P, producer=producer, rows=2, block_size=8)
    service.service.handle('submit',
                           P.Request('a', list(rng.integers(0, 256, (5,))),
                                     max_new=4))
    service.service.handle('submit',
                           P.Request('b', list(rng.integers(0, 256, (6,))),
                                     max_new=20))
    service.step()
    service.service.handle('cancel', 'b')
    service.run_until_idle()
    kinds = {type(event).__name__ for event in witnessed}
    assert kinds == {'RequestAdmitted', 'RequestCompleted',
                     'RequestEvicted', 'ServeStepped'}
    admitted = [e for e in witnessed if type(e).__name__ == 'RequestAdmitted']
    assert {e.id for e in admitted} == {'a', 'b'}
    assert all(e.ttft >= 0 for e in admitted)
    evicted = [e for e in witnessed if type(e).__name__ == 'RequestEvicted']
    assert evicted[0].id == 'b' and evicted[0].reason == 'cancelled'
    completed = [e for e in witnessed
                 if type(e).__name__ == 'RequestCompleted']
    assert completed[0].id == 'a' and completed[0].reason == 'length'
    stepped = [e for e in witnessed if type(e).__name__ == 'ServeStepped']
    assert stepped[-1].queue_depth == 0 and stepped[-1].active == 0
    return plain(witnessed, seconds=False)


def test_service_narrates_the_request_lifecycle(served):
    twin(_service_lifecycle, served)


def test_serve_levers_pick_the_default():
    """The port keeps the module's dtype on every device (no int8 default:
    GPT-2's decode step on the card is host-bound)."""
    assert serve_levers() == {'stream_dtype': 'auto'}


def test_service_builds_its_engine_on_the_card_unless_asked(served,
                                                             monkeypatch):
    module, params = served.module(PORT), served.params(PORT)
    service = InferenceService(module, params, rows=1, block_size=8,
                               device='cpu')
    assert service.engine.device.type == 'cpu'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceService(module, params, rows=1, block_size=8)


# ---------------------------------------------------------------------------
# test_serve.py: speculative rows and sharing through the scheduler
# ---------------------------------------------------------------------------


def _spec_sharing(P, served):
    rng = np.random.default_rng(71)
    engine = served.engine(P, rows=4, block_size=4, share_prefix=True,
                           draft=True, speculate=3, tree_fanout=2)
    scheduler = P.Scheduler(engine)
    head = [int(t) for t in rng.integers(0, 256, (13,))]
    prompts = [head + [int(t) for t in rng.integers(0, 256, (k,))]
               for k in (3, 2)]
    for index, prompt in enumerate(prompts):
        scheduler.submit(P.Request(f'r{index}', prompt, max_new=6))
    results = scheduler.run()
    for index, prompt in enumerate(prompts):
        assert results[f'r{index}'].tokens == served.generate(prompt, 6)
    assert engine.sharing['prefix_hits'] >= 1
    return plain(results, seconds=False), dict(engine.sharing)


@pytest.mark.slow
def test_speculative_rows_compose_with_sharing_through_scheduler(served):
    twin(_spec_sharing, served)


def _spec_budget(P, served):
    rng = np.random.default_rng(73)
    engine = served.engine(P, rows=2, block_size=8, draft=True, speculate=3)
    with pytest.raises(ValueError, match='speculate'):
        # 8 + 117 + 3 + 1 > 128: the draft chain would overrun max_seq
        engine.admit(list(rng.integers(0, 256, (8,))), max_new=117)
    prompt = [int(t) for t in rng.integers(0, 256, (7,))]
    expected = served.generate(prompt, 12)
    stop = expected[3]
    scheduler = P.Scheduler(engine)
    scheduler.submit(P.Request('s', prompt, max_new=12, stop_token=stop))
    results = scheduler.run()
    assert results['s'].reason == 'stop'
    assert results['s'].tokens == expected[:expected.index(stop) + 1]
    return plain(results, seconds=False)


def test_speculative_validates_budget_and_stop_token(served):
    twin(_spec_budget, served)


def _spec_sampled(P, served):
    prompt = list(np.random.default_rng(37).integers(0, 256, (6,)))
    ref = sampled_reference(P, served, prompt, 10, SAMPLED)
    scheduler = P.Scheduler(served.engine(P, rows=2, block_size=8,
                                          draft=True, speculate=3))
    sampling = P.SamplingParams(**SAMPLED)
    scheduler.submit(P.Request('full', prompt, 10, sampling=sampling))
    stop = ref[4]
    first_hit = ref.index(stop)
    scheduler.submit(P.Request('stopped', prompt, 10, stop_token=stop,
                               sampling=sampling))
    results = scheduler.run()
    assert results['full'].tokens == ref
    assert results['full'].reason == 'length'
    assert results['stopped'].tokens == ref[:first_hit + 1]
    assert results['stopped'].reason == 'stop'
    return plain(results, seconds=False)


def test_speculative_sampled_matches_plain_and_stops_in_window(served):
    twin(_spec_sampled, served)


def _uncached_suffix(P, served):
    rng = np.random.default_rng(79)
    engine = served.engine(P, rows=4, block_size=16, blocks=64,
                           share_prefix=True)
    head = [int(t) for t in rng.integers(0, 256, (33,))]   # 2 full blocks
    scheduler = P.Scheduler(engine, prefill_budget=64)
    scheduler.submit(P.Request('cold', head + [1], max_new=3))
    scheduler.run()                       # radix tree now holds the head
    assert engine.prefix_cached_len(head + [2]) == 32
    for index in range(4):
        scheduler.submit(P.Request(f'w{index}', head + [2 + index],
                                   max_new=3))
    tick = scheduler.step()
    assert len(tick.admitted) == 4, [r.id for r, _, _ in tick.admitted]
    assert engine.admit_cost(head + [2]) == 16
    assert engine.admit_cost(head) == 16  # fully cached still costs >0
    return plain(scheduler.run(), seconds=False), dict(engine.sharing)


def test_prefill_budget_counts_only_the_uncached_suffix(served):
    twin(_uncached_suffix, served)


# ---------------------------------------------------------------------------
# test_serve_sampling.py: the scheduler and the front doors
# ---------------------------------------------------------------------------


def test_unseeded_sampled_refused_typed_at_scheduler(served):
    scheduler = Scheduler(served.engine(PORT, rows=1, block_size=8))
    prompt = list(np.random.default_rng(2).integers(0, 256, (5,)))
    unseeded = PORT.SamplingParams(temperature=0.8)
    with pytest.raises(UnseededSampling, match='seed'):
        scheduler.submit(Request('bad', prompt, 4, sampling=unseeded))
    with pytest.raises(UnseededSampling):
        scheduler.engine.admit(prompt, 4, sampling=unseeded)
    assert isinstance(UnseededSampling('x'), ValueError)  # fleet contract
    scheduler.submit(Request('ok', prompt, 4))
    assert scheduler.run()['ok'].tokens == served.generate(prompt, 4)


def test_unseeded_sampled_refused_at_fleet_front_door():
    class _Stub:
        identity = 'stub'
        client = None
        fallbacks = ()
        scheduler = None

    router = PORT.Router([PORT.ReplicaHandle(_Stub())])
    with pytest.raises(UnseededSampling, match='seed'):
        router.submit(Request('bad', [1, 2], 4,
                              sampling=PORT.SamplingParams(temperature=1.0)))


def _sampling_churn(P, served):
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(0, 256, (n,))) for n in (5, 7, 6)]
    scheduler = P.Scheduler(served.engine(P, rows=2, block_size=8))
    scheduler.submit(P.Request('greedy', prompts[0], 8))
    scheduler.submit(P.Request('s1', prompts[1], 8,
                               sampling=P.SamplingParams(**SAMPLED)))
    scheduler.submit(P.Request('s2', prompts[2], 8,
                               sampling=P.SamplingParams(
                                   seed=3, temperature=1.3, top_k=0,
                                   top_p=0.8)))
    results = scheduler.run()
    assert results['greedy'].tokens == served.generate(prompts[0], 8)
    return plain(results, seconds=False)


def test_sampling_churn_keeps_greedy_bitwise(served):
    twin(_sampling_churn, served)


def _same_seed(P, served):
    prompt = list(np.random.default_rng(7).integers(0, 256, (6,)))
    first = sampled_reference(P, served, prompt, 10, SAMPLED)
    again = sampled_reference(P, served, prompt, 10, SAMPLED)
    other = sampled_reference(P, served, prompt, 10,
                              dict(SAMPLED, seed=12))
    assert first == again
    assert first != other
    assert first != served.generate(prompt, 10)
    narrowed = sampled_reference(P, served, prompt, 6,
                                 dict(seed=4, temperature=2.0, top_k=1))
    assert narrowed == served.generate(prompt, 6)
    return first, other


def test_same_seed_is_bitwise_reproducible_across_engines(served):
    twin(_same_seed, served)


def _grammar(P, served):
    vocab = served.module(P).vocab_size
    even = np.zeros(vocab, bool)
    even[::2] = True

    def even_mask(emitted):
        return even

    prompt = list(np.random.default_rng(13).integers(0, 256, (5,)))
    scheduler = P.Scheduler(served.engine(P, rows=2, block_size=8))
    scheduler.submit(P.Request('sg', prompt, 6, sampling=P.SamplingParams(
        seed=8, temperature=0.9, mask_fn=even_mask)))
    scheduler.submit(P.Request('gg', prompt, 6, sampling=P.SamplingParams(
        mask_fn=even_mask)))                     # greedy under the grammar
    results = scheduler.run()
    for rid in ('sg', 'gg'):
        assert all(t % 2 == 0 for t in results[rid].tokens), rid
    assert any(t % 2 for t in served.generate(prompt, 6))
    return plain(results, seconds=False)


def test_grammar_mask_constrains_sampled_and_greedy_rows(served):
    twin(_grammar, served)


# ---------------------------------------------------------------------------
# test_serve_sampling.py: streaming through the service
# ---------------------------------------------------------------------------


def _streaming(P, served):
    producer = P.Producer()
    streamed = witness(P, producer, 'TokenStreamed')
    stepped = witness(P, producer, 'ServeStepped')
    service = served.service(P, producer=producer, rows=2, block_size=8)
    prompt = list(np.random.default_rng(43).integers(0, 256, (5,)))
    delivered = []
    service.submit(P.Request('s', prompt, 6,
                             sampling=P.SamplingParams(**SAMPLED)),
                   on_token=lambda index, token: delivered.append(
                       (index, token)))
    service.submit(P.Request('quiet', prompt, 4))      # non-streaming
    results = service.run_until_idle()
    assert [i for i, _ in delivered] == list(range(6))
    assert [t for _, t in delivered] == results['s'].tokens
    assert [(e.index, e.token) for e in streamed] == delivered
    assert {e.id for e in streamed} == {'s'}         # quiet stays quiet
    assert max(e.sampled for e in stepped) == 1      # the sampled gauge
    assert stepped[-1].sampled == 0                  # drained
    return delivered, plain(stepped, seconds=False)


def test_streaming_delivers_each_token_and_narrates(served):
    twin(_streaming, served)


def _cancel_stream(P, served):
    service = served.service(P, rows=1, block_size=8)
    prompt = list(np.random.default_rng(47).integers(0, 256, (5,)))
    delivered = []
    service.submit(P.Request('c', prompt, 20),
                   on_token=lambda index, token: delivered.append(token))
    for _ in range(3):
        service.step()
    frozen = list(delivered)
    assert 0 < len(frozen) < 20
    assert service.cancel('c') == 'active'
    for _ in range(3):
        service.step()
    assert delivered == frozen                  # stream went silent
    assert service.results['c'].tokens == frozen
    return frozen


def test_cancel_mid_stream_keeps_delivered_tokens(served):
    twin(_cancel_stream, served)


def _expiry_stream(P, served):
    clock = FakeClock()
    producer = P.Producer()
    expired = witness(P, producer, 'RequestExpired')
    service = served.service(P, producer=producer, rows=1, block_size=8,
                             clock=clock)
    prompt = list(np.random.default_rng(53).integers(0, 256, (4,)))
    delivered = []
    service.submit(P.Request('d', prompt, 30, deadline=5.0,
                             sampling=P.SamplingParams(**SAMPLED)),
                   on_token=lambda index, token: delivered.append(token))
    for _ in range(3):
        service.step()
    assert delivered
    clock.advance(10.0)
    service.step()
    assert expired and expired[0].id == 'd'
    assert expired[0].where == 'active'
    assert expired[0].produced == len(delivered)
    frozen = list(delivered)
    service.step()
    assert delivered == frozen
    assert service.results['d'].tokens == frozen
    return frozen, plain(expired)


def test_deadline_expiry_mid_stream_is_truthful_about_partials(served):
    twin(_expiry_stream, served)
