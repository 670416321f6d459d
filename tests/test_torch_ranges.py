"""The port's program ranges (``observe.profile.annotate``, ``RANGES``) in
the train step, the flash call and the embedding lookup, read from a CPU
profiler's raw events: the ranges nest as the step runs them, and the
autograd engine's backward events carry the sequence number of a forward
operator inside the range that made them, so a trace's reader can put
backward work down to the forward range."""

import pytest
import torch

from tpusystem_torch.observe import annotate
from tpusystem_torch.observe import profile as profile_module
from tpusystem_torch.observe.profile import (ATTENTION, EMBEDDING,
                                             RANGE_PREFIX, RANGES,
                                             TRAIN_BACKWARD, TRAIN_FORWARD,
                                             TRAIN_LOSS, TRAIN_OPTIMIZER)

BACKWARD_EVENT = 'autograd::engine::evaluate_function: '
TRAIN = (TRAIN_FORWARD, TRAIN_LOSS, TRAIN_BACKWARD, TRAIN_OPTIMIZER)


def _events(body):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as profiler:
        body()
    return profiler.profiler.kineto_results.events()


def _ranges(events, name):
    return [(event.start_ns(), event.end_ns()) for event in events
            if event.name() == name]


def _inside(outer, inner) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_every_range_name_has_the_prefix():
    assert len(set(RANGES)) == 6
    assert all(name.startswith(RANGE_PREFIX) for name in RANGES)
    assert RANGE_PREFIX == 'tpusystem_torch.'


def test_annotate_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first, second = annotate(TRAIN_FORWARD), annotate('other')
    assert first is second is profile_module._UNTRACED
    with first:
        torch.ones(2).add_(1)
    events = _events(lambda: torch.ones(2).add_(1))
    assert not _ranges(events, TRAIN_FORWARD)


def test_annotate_records_an_operator_range_under_a_profiler():
    def body():
        context = annotate('work')
        assert context is not profile_module._UNTRACED
        with context:
            torch.ones(2).add_(1)
    events = _events(body)
    (work,) = [event for event in events if event.name() == 'work']
    assert not work.is_user_annotation()
    adds = _ranges(events, 'aten::add_')
    assert adds and _inside((work.start_ns(), work.end_ns()), adds[0])


def _gpt2_step(accumulate=1):
    from tpusystem_torch.models import GPT2
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)
    torch.manual_seed(0)
    module = GPT2(vocab_size=64, layers=2, dim=32, heads=2, max_seq=32,
                  dropout=0.0, dtype='float32', attention='flash',
                  return_features=True, device='cpu')
    optimizer = AdamW(lr=1e-3)
    step = build_train_step(module_apply(module),
                            ChunkedNextTokenLoss(chunks=2), optimizer,
                            accumulate=accumulate)
    state = init_state(module, optimizer)
    tokens = torch.randint(0, 64, (4, 16))
    return lambda: step(state, tokens, tokens)


def _dlrm_step():
    from tpusystem_torch.models import DLRM
    from tpusystem_torch.train import (SGD, BCEWithLogitsLoss,
                                       build_train_step, init_state,
                                       module_apply)
    torch.manual_seed(0)
    module = DLRM(vocabs=(40, 9, 100), dim=8, dense_features=4,
                  bottom=(16,), top=(16,), device='cpu')
    optimizer = SGD(lr=0.1)
    step = build_train_step(module_apply(module), BCEWithLogitsLoss(),
                            optimizer)
    state = init_state(module, optimizer)
    features = {'dense': torch.randn(32, 4),
                'ids': torch.stack([torch.randint(0, vocab, (32, 2))
                                    for vocab in (40, 9, 100)], 1)}
    labels = torch.randint(0, 2, (32,)).float()
    return lambda: step(state, features, labels)


STEPS = {'gpt2': (_gpt2_step, ATTENTION, 2),
         'dlrm': (_dlrm_step, EMBEDDING, 3)}


@pytest.mark.parametrize('model', sorted(STEPS))
def test_a_train_step_records_its_ranges_nested(model):
    make, layer, per_step = STEPS[model]
    step = make()
    step()                                      # the first step is set-up
    events = _events(step)
    train = [_ranges(events, name) for name in TRAIN]
    assert [len(found) for found in train] == [1, 1, 1, 1]
    (forward,), (loss,), (backward,), (update,) = train
    assert forward[1] <= loss[0] and loss[1] <= backward[0]
    assert backward[1] <= update[0]
    layers = _ranges(events, layer)
    assert len(layers) == per_step
    assert all(_inside(forward, found) for found in layers)
    other = EMBEDDING if layer == ATTENTION else ATTENTION
    assert not _ranges(events, other)


def test_microbatches_take_the_ranges_each():
    step = _gpt2_step(accumulate=2)
    step()
    events = _events(step)
    assert [len(_ranges(events, name)) for name in TRAIN] == [2, 2, 2, 1]
    assert len(_ranges(events, ATTENTION)) == 4


def _forward_ranges(events):
    """For each backward event, the innermost program range around the
    forward operator with its sequence number on its forward thread."""
    ranges = [(event.start_thread_id(), event.start_ns(), event.end_ns(),
               event.name()) for event in events
              if event.name().startswith(RANGE_PREFIX)]
    forward = {}
    for event in events:
        key = (event.start_thread_id(), event.sequence_nr())
        if event.sequence_nr() >= 0 and key not in forward:
            forward[key] = event.start_ns()
    made = []
    for event in events:
        if not event.name().startswith(BACKWARD_EVENT):
            continue
        key = (event.fwd_thread_id(), event.sequence_nr())
        if key not in forward:
            continue
        around = [(end - start, name) for thread, start, end, name in ranges
                  if thread == key[0] and start <= forward[key] <= end]
        made.append((event.name()[len(BACKWARD_EVENT):],
                     min(around)[1] if around else None))
    return made


@pytest.mark.parametrize('model', sorted(STEPS))
def test_backward_events_link_to_forward_ranges(model):
    make, layer, _ = STEPS[model]
    step = make()
    step()
    made = _forward_ranges(_events(step))
    found = {name for _, name in made}
    assert {TRAIN_FORWARD, TRAIN_LOSS, layer} <= found
    assert TRAIN_BACKWARD not in found and TRAIN_OPTIMIZER not in found
    nodes = {node for node, name in made if name == layer}
    expected = ('_FlashAttentionBackward' if layer == ATTENTION
                else '_ExpandRowsBackward')
    assert any(expected in node for node in nodes), nodes


def test_the_speculative_step_keeps_its_range_names():
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.serve import Engine
    torch.manual_seed(0)
    module = gpt2_tiny(dtype='float32', device='cpu')
    params = {name: leaf.detach() for name, leaf in module.named_parameters()}
    engine = Engine(module, params, draft_module=module,
                    draft_params=params, device='cpu', rows=2, block_size=4,
                    speculate=2)
    engine.admit([1, 2, 3, 4, 5], 6)
    engine.step()
    events = _events(engine.step)
    assert _ranges(events, 'speculative.draft')
    assert _ranges(events, 'speculative.verify')


@pytest.mark.cuda
def test_a_range_draws_nothing_on_the_device_and_owns_its_kernels():
    """On the card: a range has no copy on the device's timeline, and the
    runtime call that launched a kernel inside it (K1, launched through
    ctypes, with no aten operator) shares the kernel's correlation id and
    lies inside the range on its thread."""
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the flash kernels run only on an '
                    'NVIDIA card')
    from tpusystem_torch.ops.cuda.flash import flash_attention
    query = torch.randn(1, 128, 2, 64, device='cuda', dtype=torch.bfloat16)
    flash_attention(query, query, query)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as profiler:
        flash_attention(query, query, query)
        torch.cuda.synchronize()
    events = profiler.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    assert not [event for event in events if event.device_type() == cuda
                and event.name().startswith(RANGE_PREFIX)]
    (attention,) = [event for event in events if event.name() == ATTENTION]
    (kernel,) = [event for event in events if event.device_type() == cuda
                 and 'flash_fwd_kernel' in event.name()]
    (launcher,) = [event for event in events if event.device_type() != cuda
                   and event.linked_correlation_id()
                   and event.correlation_id() == kernel.correlation_id()]
    assert launcher.start_thread_id() == attention.start_thread_id()
    assert _inside((attention.start_ns(), attention.end_ns()),
                   (launcher.start_ns(), launcher.end_ns()))
