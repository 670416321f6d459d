"""``chip_smoke.py``'s reading of ptxas' report, on the CPU.

The spill check finds each kernel instance by its demangled name. nvcc
names the anonymous namespace of ``flash_bwd.cu`` and ``grouped_matmul.cu``
with hashes that change with the source's path and may hold digits, so
these cases put digits next to the kernel's own length prefix; template
arguments are int and bool literals in any order and number.
"""

import importlib.util
import pathlib

import pytest

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / 'chip_smoke.py'


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _report(mangled, registers=255, spills=0):
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spills} bytes spill stores, "
            f"{spills} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers\n")


@pytest.mark.parametrize('suffix', ['ac07497f', '629f6fbe', '11af923d',
                                    '88561712', '55485822', '00000025'])
@pytest.mark.parametrize('kernel', ['flash_bwd_fused_kernel',
                                    'flash_bwd_dq_kernel',
                                    'flash_bwd_dkv_kernel'])
def test_ptxas_report_names_kernels_whatever_the_namespace_hash(kernel,
                                                                suffix):
    namespace = f'_GLOBAL__N__f0fb9384_12_flash_bwd_cu_{suffix}'
    output = ''.join(
        _report(f'_ZN{len(namespace)}{namespace}{len(kernel)}{kernel}'
                f'ILi{head_dim}EEEv14CUtensorMap_stS1_PKfi7Dropout',
                registers=100 + head_dim)
        for head_dim in (16, 32, 64, 128))
    report = _chip_smoke().ptxas_report(output)
    assert report == {f'{kernel}<{head_dim}>': {
        'stack': 0, 'spill_stores': 0, 'spill_loads': 0,
        'registers': 100 + head_dim} for head_dim in (16, 32, 64, 128)}


def test_ptxas_report_reads_a_global_kernel_and_its_flag():
    report = _chip_smoke().ptxas_report(
        _report('_Z16flash_fwd_kernelILi128ELb1EEvPK13__nv_bfloat16',
                spills=8))
    assert report == {'flash_fwd_kernel<128, true>': {
        'stack': 0, 'spill_stores': 8, 'spill_loads': 8, 'registers': 255}}


def test_spill_check_fails_on_a_missing_or_spilling_instance():
    chip_smoke = _chip_smoke()
    namespace = '_GLOBAL__N__f0fb9384_12_flash_bwd_cu_629f6fbe'
    kernel = 'flash_bwd_fused_kernel'

    def output(spilling):
        return ''.join(
            _report(f'_ZN{len(namespace)}{namespace}{len(kernel)}{kernel}'
                    f'ILi{head_dim}EEEv', spills=8 * (head_dim in spilling))
            for head_dim in (16, 32, 64, 128))

    instances = [f'{kernel}<{head_dim}>' for head_dim in (16, 32, 64, 128)]
    chip_smoke.check_spills('bwd-ptxas', chip_smoke.ptxas_report(output(())),
                            instances)
    with pytest.raises(SystemExit):
        chip_smoke.check_spills(
            'bwd-ptxas', chip_smoke.ptxas_report(output((64,))), instances)
    missing = chip_smoke.ptxas_report(output(()))
    del missing[f'{kernel}<32>']
    with pytest.raises(SystemExit):
        chip_smoke.check_spills('bwd-ptxas', missing, instances)


GROUPED = 'grouped_gemm_kernel'
FLAGS = [(gather, trans_b) for gather in (0, 1) for trans_b in (0, 1)]


def _grouped_output(suffix, spilling=()):
    # K6/K7's kernel, template <bool GATHER, bool TRANS_B>, in the
    # anonymous namespace of grouped_matmul.cu
    namespace = f'_GLOBAL__N__9d0c3e11_17_grouped_matmul_cu_{suffix}'
    return ''.join(
        _report(f'_ZN{len(namespace)}{namespace}{len(GROUPED)}{GROUPED}'
                f'ILb{gather}ELb{trans_b}EEEv14CUtensorMap_stS1_NS_7ProblemE',
                registers=90 + 2 * gather + trans_b,
                spills=8 * ((gather, trans_b) in spilling))
        for gather, trans_b in FLAGS)


def _flag(value):
    return 'true' if value else 'false'


@pytest.mark.parametrize('suffix', ['ac07497f', '11af923d', '55485822',
                                    '00000025'])
def test_ptxas_report_names_bool_bool_kernels_under_a_digit_hash(suffix):
    report = _chip_smoke().ptxas_report(_grouped_output(suffix))
    assert report == {
        f'{GROUPED}<{_flag(gather)}, {_flag(trans_b)}>': {
            'stack': 0, 'spill_stores': 0, 'spill_loads': 0,
            'registers': 90 + 2 * gather + trans_b}
        for gather, trans_b in FLAGS}


@pytest.mark.parametrize('arguments,expected', [
    ('ILi64ELb0ELi3EE', ['64', 'false', '3']),
    ('ILb1ELi128EE', ['true', '128']),
    ('ILin2ELj7EE', ['-2', '7']),
    ('ILb1E', None),
    ('EPK13__nv_bfloat16', None)])
def test_template_arguments_read_ints_and_bools_in_any_order(arguments,
                                                              expected):
    assert _chip_smoke().template_arguments(arguments) == expected


@pytest.mark.parametrize('broken', ['spilling', 'missing'])
@pytest.mark.parametrize('gather,trans_b', FLAGS)
def test_grouped_spill_check_fails_on_a_missing_or_spilling_instance(
        broken, gather, trans_b):
    chip_smoke = _chip_smoke()
    instances = chip_smoke.GROUPED_INSTANCES
    assert sorted(instances) == sorted(
        f'{GROUPED}<{_flag(g)}, {_flag(t)}>' for g, t in FLAGS)
    chip_smoke.check_spills('grouped-ptxas', chip_smoke.ptxas_report(
        _grouped_output('629f6fbe')), instances)
    if broken == 'spilling':
        report = chip_smoke.ptxas_report(
            _grouped_output('629f6fbe', spilling=((gather, trans_b),)))
    else:
        report = chip_smoke.ptxas_report(_grouped_output('629f6fbe'))
        del report[f'{GROUPED}<{_flag(gather)}, {_flag(trans_b)}>']
    with pytest.raises(SystemExit):
        chip_smoke.check_spills('grouped-ptxas', report, instances)


def _bwd_output(suffix, spilling=()):
    # the backward library's kernels in the anonymous namespace of
    # flash_bwd.cu: flash_bwd_fused_kernel<int D, bool WITH_DQ> (K2a/K2b
    # with dq, K3b without) and flash_bwd_dq_kernel<int D> (K3a)
    namespace = f'_GLOBAL__N__f0fb9384_12_flash_bwd_cu_{suffix}'
    fused, dq = 'flash_bwd_fused_kernel', 'flash_bwd_dq_kernel'
    mangled = [(f'{fused}<{d}, {_flag(w)}>',
                f'{len(fused)}{fused}ILi{d}ELb{w}EEEv14CUtensorMap_')
               for d in (16, 32, 64, 128) for w in (0, 1)]
    mangled += [(f'{dq}<{d}>', f'{len(dq)}{dq}ILi{d}EEEv14CUtensorMap_')
                for d in (16, 32, 64, 128)]
    return ''.join(_report(f'_ZN{len(namespace)}{namespace}{tail}',
                           spills=8 * (name in spilling))
                   for name, tail in mangled)


@pytest.mark.parametrize('broken', ['spilling', 'missing'])
@pytest.mark.parametrize('kernel', ['flash_bwd_dq', 'flash_bwd_dkv'])
@pytest.mark.parametrize('head_dim', [16, 32, 64, 128])
def test_bwd_spill_check_covers_the_split_pair_at_every_head_dim(
        broken, kernel, head_dim):
    """``bwd-ptxas`` covers K3a (``flash_bwd_dq_kernel<D>``) and K3b (the
    fused kernel's body without dq, ``flash_bwd_fused_kernel<D, false>``)
    beside K2a/K2b (``<D, true>``) at every head dim: the names read back
    from ptxas' report, and a missing or spilling instance fails."""
    chip_smoke = _chip_smoke()
    assert chip_smoke.BWD_INSTANCES == tuple(sorted(
        [f'flash_bwd_fused_kernel<{d}, {w}>' for d in (16, 32, 64, 128)
         for w in ('true', 'false')]
        + [f'flash_bwd_dq_kernel<{d}>' for d in (16, 32, 64, 128)]))
    assert chip_smoke.template_arguments(f'ILi{head_dim}ELb0EEEv') == [
        str(head_dim), 'false']
    instance = chip_smoke.BWD_INSTANCE[kernel].format(head_dim)
    assert instance in chip_smoke.BWD_INSTANCES
    report = chip_smoke.ptxas_report(_bwd_output('629f6fbe'))
    assert sorted(report) == list(chip_smoke.BWD_INSTANCES)
    chip_smoke.check_spills('bwd-ptxas', report, chip_smoke.BWD_INSTANCES)
    if broken == 'spilling':
        report = chip_smoke.ptxas_report(
            _bwd_output('11af923d', spilling=(instance,)))
    else:
        del report[instance]
    with pytest.raises(SystemExit):
        chip_smoke.check_spills('bwd-ptxas', report, chip_smoke.BWD_INSTANCES)


def _decode_output(suffix, spilling=()):
    # K4's kernel, template <bool GELU, int weight type>, in the anonymous
    # namespace of decode_matmul.cu
    namespace = f'_GLOBAL__N__7e1f0a55_16_decode_matmul_cu_{suffix}'
    kernel = 'decode_matmul_kernel'
    return ''.join(
        _report(f'_ZN{len(namespace)}{namespace}{len(kernel)}{kernel}'
                f'ILb{gelu}ELi{mode}EEEv14CUtensorMap_stPK13__nv_bfloat16PKf'
                f'S6_P13__nv_bfloat16iiiii', registers=40 + 8 * mode + gelu,
                spills=8 * ((gelu, mode) in spilling))
        for mode in (0, 1, 2) for gelu in (0, 1))


def test_decode_instances_are_every_k4_instantiation():
    """``decode-ptxas`` covers K4 at every activation and weight type the
    wrapper launches: bf16 (0), int8 (1) and e4m3 (2), with and without
    GELU."""
    chip_smoke = _chip_smoke()
    report = chip_smoke.ptxas_report(_decode_output('629f6fbe'))
    assert sorted(report) == sorted(chip_smoke.DECODE_INSTANCES)
    assert report['decode_matmul_kernel<true, 2>']['registers'] == 57
    assert len(chip_smoke.DECODE_INSTANCES) == 6


@pytest.mark.parametrize('broken', ['spilling', 'missing'])
@pytest.mark.parametrize('gelu', [0, 1])
@pytest.mark.parametrize('mode', [0, 1, 2])
def test_decode_spill_check_fails_on_a_missing_or_spilling_instance(
        broken, gelu, mode):
    chip_smoke = _chip_smoke()
    instances = chip_smoke.DECODE_INSTANCES
    chip_smoke.check_spills('decode-ptxas', chip_smoke.ptxas_report(
        _decode_output('00000025')), instances)
    name = f'decode_matmul_kernel<{_flag(gelu)}, {mode}>'
    if broken == 'spilling':
        report = chip_smoke.ptxas_report(
            _decode_output('00000025', spilling=((gelu, mode),)))
    else:
        report = chip_smoke.ptxas_report(_decode_output('00000025'))
        del report[name]
    with pytest.raises(SystemExit):
        chip_smoke.check_spills('decode-ptxas', report, instances)


def _ffn_output(suffix, spilling=()):
    # one build of decode_matmul.cu: K4's six kernels and K5's, template
    # <int weight type>, in the same anonymous namespace
    namespace = f'_GLOBAL__N__7e1f0a55_16_decode_matmul_cu_{suffix}'
    kernel = 'decode_ffn_kernel'
    return _decode_output(suffix) + ''.join(
        _report(f'_ZN{len(namespace)}{namespace}{len(kernel)}{kernel}'
                f'ILi{mode}EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PKfS6_S6_'
                f'S6_PfPiPS2_iiiiiiiiii', registers=110 + 8 * mode,
                spills=8 * (mode in spilling))
        for mode in (0, 1, 2))


@pytest.mark.parametrize('suffix', ['94ea2dd3', '629f6fbe', '00000025'])
def test_decode_ptxas_covers_every_k5_instantiation(suffix):
    """``decode-ptxas`` covers K5 at every weight type the wrapper launches
    (bf16 0, int8 1, e4m3 2) beside K4's six instances: the names read back
    from one build's report, whatever digits the namespace's hash holds."""
    chip_smoke = _chip_smoke()
    assert chip_smoke.FFN_INSTANCES == tuple(
        f'decode_ffn_kernel<{mode}>' for mode in (0, 1, 2))
    instances = chip_smoke.DECODE_INSTANCES + chip_smoke.FFN_INSTANCES
    report = chip_smoke.ptxas_report(_ffn_output(suffix))
    assert sorted(report) == sorted(instances)
    assert report['decode_ffn_kernel<1>']['registers'] == 118
    chip_smoke.check_spills('decode-ptxas', report, instances)


@pytest.mark.parametrize('broken', ['spilling', 'missing'])
@pytest.mark.parametrize('mode', [0, 1, 2])
def test_k5_spill_check_fails_on_a_missing_or_spilling_instance(broken,
                                                                mode):
    chip_smoke = _chip_smoke()
    instances = chip_smoke.DECODE_INSTANCES + chip_smoke.FFN_INSTANCES
    if broken == 'spilling':
        report = chip_smoke.ptxas_report(
            _ffn_output('00000025', spilling=(mode,)))
    else:
        report = chip_smoke.ptxas_report(_ffn_output('00000025'))
        del report[f'decode_ffn_kernel<{mode}>']
    with pytest.raises(SystemExit):
        chip_smoke.check_spills('decode-ptxas', report, instances)


def _lookup_output(suffix, spilling=()):
    # K9's kernels in the anonymous namespace of embedding_lookup.cu: the
    # staging pass, template <bool BF16, bool VEC>, and the fold, template
    # <bool BF16>
    namespace = f'_GLOBAL__N__15093042_19_embedding_lookup_cu_{suffix}'
    stage, fold = 'stage_products_kernel', 'segment_fold_kernel'
    mangled = [(f'{stage}<{_flag(b)}, {_flag(v)}>',
                f'{len(stage)}{stage}ILb{b}ELb{v}EEEvPKvPKfPKiPKlPfiiii')
               for b in (0, 1) for v in (0, 1)]
    mangled += [(f'{fold}<{_flag(b)}>',
                 f'{len(fold)}{fold}ILb{b}EEEvPKfPKvS2_PKlPKiPfiiiiii')
                for b in (0, 1)]
    return ''.join(_report(f'_ZN{len(namespace)}{namespace}{tail}',
                           registers=60 + 30 * ('fold' in name),
                           spills=8 * (name in spilling))
                   for name, tail in mangled)


@pytest.mark.parametrize('suffix', ['edaf5b8c', '11af923d', '00000025'])
def test_lookup_instances_are_every_k9_instantiation(suffix):
    """``lookup-ptxas`` covers K9's staging pass at both row types, with
    and without vector loads, and its fold at both row types, whatever
    digits the anonymous namespace's hash holds."""
    chip_smoke = _chip_smoke()
    report = chip_smoke.ptxas_report(_lookup_output(suffix))
    assert sorted(report) == sorted(chip_smoke.LOOKUP_INSTANCES)
    assert len(chip_smoke.LOOKUP_INSTANCES) == 6
    assert report['segment_fold_kernel<true>'] == {
        'stack': 0, 'spill_stores': 0, 'spill_loads': 0, 'registers': 90}


@pytest.mark.parametrize('broken', ['spilling', 'missing'])
@pytest.mark.parametrize('instance', [
    'segment_fold_kernel<false>', 'segment_fold_kernel<true>',
    'stage_products_kernel<false, false>', 'stage_products_kernel<false, true>',
    'stage_products_kernel<true, false>', 'stage_products_kernel<true, true>'])
def test_lookup_spill_check_fails_on_a_missing_or_spilling_instance(
        broken, instance):
    chip_smoke = _chip_smoke()
    instances = chip_smoke.LOOKUP_INSTANCES
    assert instance in instances
    chip_smoke.check_spills('lookup-ptxas', chip_smoke.ptxas_report(
        _lookup_output('629f6fbe')), instances)
    if broken == 'spilling':
        report = chip_smoke.ptxas_report(
            _lookup_output('629f6fbe', spilling=(instance,)))
    else:
        report = chip_smoke.ptxas_report(_lookup_output('629f6fbe'))
        del report[instance]
    with pytest.raises(SystemExit):
        chip_smoke.check_spills('lookup-ptxas', report, instances)


def test_kernel_ptxas_reads_the_build_output_and_fails_on_a_spill(
        monkeypatch, capsys):
    """``kernel_ptxas`` reads a library's compiler output as this process
    built it, prints the instances' registers and fails on a spill."""
    chip_smoke = _chip_smoke()
    from tpusystem_torch.ops.cuda._build import LIBRARIES
    monkeypatch.setitem(LIBRARIES.compiler_output, 'embedding_lookup',
                        _lookup_output('629f6fbe'))
    mine = chip_smoke.kernel_ptxas('lookup-ptxas', 'embedding_lookup',
                                   chip_smoke.LOOKUP_INSTANCES)
    assert sorted(mine) == sorted(chip_smoke.LOOKUP_INSTANCES)
    assert capsys.readouterr().out.startswith('lookup-ptxas {')
    monkeypatch.setitem(LIBRARIES.compiler_output, 'embedding_lookup',
                        _lookup_output('629f6fbe',
                                       spilling=('segment_fold_kernel<false>',)))
    with pytest.raises(SystemExit):
        chip_smoke.kernel_ptxas('lookup-ptxas', 'embedding_lookup',
                                chip_smoke.LOOKUP_INSTANCES)


@pytest.mark.parametrize('longest,clock,expected', [
    (16600, 1980.0, 16600 * 4 / 1.98e6), (39831, 1755.0, 39831 * 4 / 1.755e6),
    (1, 1000.0, 4e-6), (0, 1980.0, 0.0)])
def test_chain_floor_is_the_longest_segment_in_dependent_adds(longest, clock,
                                                              expected):
    """The fold's chain floor: 4 cycles a dependent float32 add at the SM
    clock (MHz), in ms; ~0.0335 ms for a 16,600-long Zipf head at
    1.98 GHz."""
    floor = _chip_smoke().chain_floor_ms(longest, clock)
    assert floor == pytest.approx(expected, rel=1e-12)
    if longest == 16600:
        assert 0.033 < floor < 0.034


@pytest.mark.parametrize('case', ['one-id', 'vocab3-head', 'distinct',
                                  'sentinels', 'threshold',
                                  'threshold-shifted', 'bf16', 'dim8',
                                  'dim130', 'dim512'])
def test_fold_cases_hold_what_they_name(case):
    """Each case of the K9 fold sweep holds the segments it is there for,
    with the long path's threshold at 256."""
    import numpy as np
    import torch
    chip_smoke = _chip_smoke()
    assert case in chip_smoke.FOLD_CASES
    rows, ids, scale, table_rows = chip_smoke.fold_case(case, 256, 3)
    assert rows.shape[0] == ids.shape[0] == scale.shape[0]
    counts = np.bincount(ids.numpy()[(ids.numpy() >= 0)
                                     & (ids.numpy() < table_rows)])
    sentinels = int((ids >= table_rows).sum())
    if case == 'one-id':
        assert counts.tolist() == [65536]
    elif case == 'vocab3-head':
        assert table_rows == 3 and 37000 < counts.max() < 42000
    elif case == 'distinct':
        assert counts.max() == 1 and len(counts) == 65536
    elif case == 'sentinels':
        assert sentinels > 13000 and bool((ids[-300:] >= table_rows).all())
    elif case.startswith('threshold'):
        assert {255, 256, 257} <= set(counts.tolist())
        assert counts.max() == 257 and rows.shape[0] == 16 * 256
    else:
        assert sentinels > 600 and counts.max() > 256
        assert rows.dtype == (torch.bfloat16 if case == 'bf16'
                              else torch.float32)
        assert rows.shape[1] == (128 if case == 'bf16' else int(case[3:]))


def _phase_14(seed=3, counted=True):
    """Phase 14's composition on the CPU at ``dlrm_tiny``'s size: the
    model, the train phase's result and the host objects."""
    import torch
    from tpusystem_torch.data import Loader, SyntheticClicks
    from tpusystem_torch.models import dlrm_tiny
    from tpusystem_torch.ops.cuda import embedding_lookup as el
    chip_smoke = _chip_smoke()
    clicks = dict(samples=96, vocabs=(64, 32), seed=0)
    holdout = SyntheticClicks(train=False, **clicks)
    counters = (el.gather_rows, el.scatter_add_rows) if counted else ()
    model, service, runtime, events = chip_smoke.compose_recommender(
        torch, dlrm_tiny, {}, holdout, device='cpu', seed=seed, lr=0.5,
        batch=32, counters=counters)
    batches = list(Loader(SyntheticClicks(**clicks), 32, shuffle=True,
                          seed=seed, device='cpu'))
    return chip_smoke, holdout, batches, model, service, runtime, events


def test_phase_14_drives_the_dlrm_through_the_host_layers_on_the_cpu():
    """``compose_recommender`` with ``dlrm_tiny`` on the CPU: the
    ``Compiler`` draws the weights from the injected seed on the injected
    device, the ``train`` handler's losses are the plain train step's on
    the same weights and batches, the phase gives one ``Trained`` and one
    ``RecsysEvaluated`` that ``check_host`` accepts, and the enqueued stop
    unwinds. On the CPU the lookup runs its plain versions, so the kernels'
    counters stay at 0."""
    import torch
    from tpusystem_torch.models import dlrm_tiny
    from tpusystem_torch.registry import gethash
    from tpusystem_torch.train import (SGD, BCEWithLogitsLoss,
                                       build_train_step, init_state,
                                       module_apply)
    chip_smoke, holdout, batches, model, service, runtime, events = (
        _phase_14())
    want = dlrm_tiny(device='cpu')
    want.init_weights(torch.Generator('cpu').manual_seed(3))
    weights = want.state_dict()
    assert isinstance(model, chip_smoke.Recommender)
    assert isinstance(model, torch.nn.Module) and model.phase == 'train'
    assert dict(model.named_children()) == {'network': model.network}
    assert model.id == gethash(model.network) == gethash(want)
    for name, value in model.network.state_dict().items():
        assert torch.equal(value, weights[name]), name
    assert all(model.state.params[name] is param for name, param
               in model.network.named_parameters())

    phase = service.handle('train', model, iter(batches))
    optimizer = SGD(lr=0.5)
    step = build_train_step(module_apply(want), BCEWithLogitsLoss(),
                            optimizer)
    state = init_state(want, optimizer, rng=3)
    plain = [step(state, *batch)[1][1].item() for batch in batches]
    assert phase['losses'] == plain
    assert len(phase['seconds']) == 2 and phase['stop'] is False
    assert phase['launches'] == {'gather_rows': 0, 'scatter_add_rows': 0}
    host = chip_smoke.check_host(model, runtime, events, phase, holdout,
                                 32)
    assert host['events'] == {'Trained': 1, 'RecsysEvaluated': 1}
    assert host['ledger_count'] == 2 and host['direct_metrics_equal']
    assert host['early_stop_unwound'] and host['should_stop'] is True
    assert host['epoch'] == 2 and host['id'] == model.id
    runtime.close()


@pytest.mark.parametrize('broken', ['extra-event', 'other-metrics',
                                    'unledgered', 'stopped'])
def test_phase_14_host_check_fails_on_a_wrong_phase(broken):
    """``check_host`` exits on an extra event, metrics that are not the
    direct run's, an event the ledger did not count, or a phase that asked
    to stop."""
    chip_smoke, holdout, batches, model, service, runtime, events = (
        _phase_14(counted=False))
    phase = service.handle('train', model, iter(batches))
    if broken == 'extra-event':
        events.append(events[0])
    elif broken == 'other-metrics':
        events[1].metrics['auc'] += 1e-9
    elif broken == 'unledgered':
        runtime.ledger.count -= 1
    else:
        phase['stop'] = True
    with pytest.raises(SystemExit):
        chip_smoke.check_host(model, runtime, events, phase, holdout, 32)
    runtime.close()


@pytest.mark.parametrize('script', ['events', 'prodcon', 'pubsub'])
def test_phase_19_expects_what_the_reference_examples_print(script, capsys):
    """Phase 19 holds the twins' output against ``VERYBASIC_OUTPUT`` on the
    card, where the reference cannot run: it is what the reference's
    scripts print."""
    path = SCRIPT.parent / 'examples' / 'verybasic' / f'{script}.py'
    spec = importlib.util.spec_from_file_location(f'reference_{script}',
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main()
    assert _chip_smoke().VERYBASIC_OUTPUT[script] == capsys.readouterr().out


def test_phase_18_prompts_hit_as_the_phase_expects():
    """Phase 18's prompts through the radix index as the phase seats them
    (eight rows; the two long prompts as the first two rows free): every
    prompt but the first of each prefix adopts its prefix, so the phase
    expects eight resumed prefills."""
    from tpusystem_torch.serve import PagedKVCache

    chip_smoke = _chip_smoke()
    prompts = chip_smoke.prefix_prompts(0, 50257)
    block = chip_smoke.BLOCK
    pool = PagedKVCache(chip_smoke.ROWS, chip_smoke.ROWS * 1024 // block + 1,
                        block, 1024, share_prefix=True)
    shared = []
    for row, prompt in enumerate(prompts[:chip_smoke.ROWS]):
        pool.admit(row, len(prompt) + chip_smoke.MAX_NEW, prompt=prompt)
        shared.append(pool.shared_tokens(row))
    for row, prompt in enumerate(prompts[chip_smoke.ROWS:]):
        pool.evict(row)
        pool.admit(row, len(prompt) + chip_smoke.MAX_NEW, prompt=prompt)
        shared.append(pool.shared_tokens(row))
    assert shared == [0] + [chip_smoke.PREFIX_SHARED] * 7 + [
        0, chip_smoke.LONG_PREFIX]
    assert all(len(prompt) < 1024 - chip_smoke.MAX_NEW for prompt in prompts)
    assert chip_smoke.even_ids([]).shape == (chip_smoke.GPT2_VOCAB,)


NEW_PHASES = ('serve-llama-narrow', 'spec-generate', 'serve-spec',
              'serve-moe')


def test_the_speculative_moe_and_narrow_phases_print_in_order():
    """Phases 15b and 20-22 print their lines: Llama's narrow serving right
    after phase 15 (it reuses its weights), the other three after phase 19,
    and the ``kernels`` and ``ok`` lines stay last."""
    import inspect
    source = inspect.getsource(_chip_smoke().main)
    order = [source.index(f"print('{label} '") for label in (
        'serve-llama', 'serve-llama-narrow', 'train-llama', 'verybasic',
        'spec-generate', 'serve-spec', 'serve-moe')]
    assert order == sorted(order)
    assert source.index("print('serve-moe '") < source.index(
        "print(json.dumps({'kernels': kernels}))") < source.index("'ok': True")
    for label in NEW_PHASES:
        assert label in SCRIPT.read_text()


def test_chip_smoke_imports_no_jax():
    """Importing the script (which imports the port) loads neither JAX nor
    the JAX package."""
    import subprocess
    import sys
    code = ('import sys; import chip_smoke; '
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'tpusystem')); "
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=SCRIPT.parent,
                   check=True, timeout=120)


def test_phase_21_rows_keep_the_greedy_row_deepest():
    """Phase 21 (c) holds its greedy row to its stream in (a): the row is
    the deepest prompt's, so every read window matches (a)'s while it
    runs; the sampled rows sample and the prompts fit the draft's
    capacity."""
    chip_smoke = _chip_smoke()
    lengths = chip_smoke.PROMPT_LENGTHS
    greedy = [index for index, spec in chip_smoke.SPEC_SAMPLED
              if spec is None]
    assert len(greedy) == 1 and lengths[greedy[0]] == max(lengths)
    assert sum(spec is not None and spec['temperature'] > 0
               for _, spec in chip_smoke.SPEC_SAMPLED) == 3
    assert max(lengths) + chip_smoke.MAX_NEW + chip_smoke.SPEC_K + 1 <= \
        chip_smoke.SPEC_SERVE_DRAFT['max_seq']
    assert dict(chip_smoke.GROUPED_SERVING) == {'decode': chip_smoke.ROWS,
                                                'prefill': 1024}


@pytest.mark.parametrize('fanout', [1, 2])
def test_drive_engine_serves_speculative_rows_through_a_queue(fanout,
                                                              monkeypatch):
    """``drive_engine`` on the CPU (no card to synchronise) with more
    requests than seats: the speculative rows' streams equal the plain
    engine's, the self-draft takes fewer steps than it emits tokens, a
    traced window keeps its tokens, and the pool's audit runs after every
    eviction."""
    import numpy as np
    import torch

    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.serve import Engine

    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *args: None)
    chip_smoke = _chip_smoke()
    module = gpt2_tiny(dtype='float32', device='cpu')
    prompts = [np.random.default_rng(i).integers(0, 256, (n,))
               for i, n in enumerate((5, 9, 7, 3, 12))]
    plain = chip_smoke.drive_engine(
        torch, Engine(module, None, rows=4, block_size=8, device='cpu'),
        prompts, max_new=10)
    engine = Engine(module, None, rows=4, block_size=8, draft_module=module,
                    speculate=3, tree_fanout=fanout, device='cpu')
    run = chip_smoke.drive_engine(torch, engine, prompts, max_new=10,
                                  audit=True, profile_at=1)
    assert run['tokens'] == plain['tokens']
    assert run['engine_steps'] < run['decode_tokens'] == 5 * 9
    assert run['traced_steps'] == 4 and run['audits'] == 5
    assert run['last_audit'] == {'free': engine.pool.blocks - 1, 'cached': 0,
                                 'live': 0}
    assert engine.speculation['accepted'] == 3 * engine.speculation['groups']


def test_phase_23_prints_after_the_moe_phase():
    """Phase 23 prints its line after phase 22's, and the ``kernels`` and
    ``ok`` lines stay last."""
    import inspect
    source = inspect.getsource(_chip_smoke().main)
    assert source.index("print('serve-moe '") < source.index(
        "print('serve-disagg '") < source.index(
        "print(json.dumps({'kernels': kernels}))") < source.index("'ok': True")


@pytest.fixture
def one_torch_thread():
    """Tiny models gain nothing from torch's thread pool, whose spinning
    threads would slow the test workers beside this one."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_phase_23_drives_the_control_plane_on_the_cpu(monkeypatch,
                                                      one_torch_thread):
    """Phase 23's four parts at ``gpt2_tiny`` on the CPU (no card: the
    engines run the module path, so the only checks that fail are the ones
    about the card: the fused route and the kernels' counters). The
    disaggregated streams, the service's and the replayed ones equal the
    colocated run's in float32, the hand-offs ship full ``max_seq`` strips,
    the killed engine is collected and the certification passes."""
    import numpy as np
    import torch

    import tpusystem_torch.serve.engine as engine_module
    from tpusystem_torch.models import gpt2_tiny

    chip_smoke = _chip_smoke()
    failures = []
    monkeypatch.setattr(chip_smoke, 'fail', failures.append)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *args: None)
    monkeypatch.setattr(torch.cuda, 'memory_allocated', lambda *args: 0)
    monkeypatch.setattr(engine_module, 'resolve_device',
                        lambda device=None: torch.device('cpu'))
    module = gpt2_tiny(dtype='float32', device='cpu')
    prompts = [np.random.default_rng(i).integers(0, 256, (n,))
               for i, n in enumerate((20, 30, 70, 20, 30, 70, 10, 45))]
    colocated, record = chip_smoke.disagg_serving(torch, module, prompts)
    assert record['streams_equal'] == {'share': 1.0,
                                       'first_difference': None}
    assert record['first_tokens_equal_share'] == 1.0
    strip = module.max_seq * module.dim * 4          # float32, k or v
    assert record['handoff_kv_bytes'] == [2 * module.layers * strip]
    assert all(len(times) == len(prompts)
               for times in record['handoff_ms'].values())
    service = chip_smoke.service_streams(torch, module, prompts, colocated)
    assert service['events']['TokenStreamed'] == len(prompts) \
        * chip_smoke.MAX_NEW
    drill = chip_smoke.kill_drill(torch, module, prompts, colocated)
    assert drill['replayed_hot'] == len(prompts)
    assert drill['streams_equal']['share'] == 1.0    # exact in float32
    assert chip_smoke.certify(torch, module, prompts)['ok']
    assert all('decode_impl' in message or 'K4/K5 did not launch' in message
               or 'InferenceService built its engine on cpu' in message
               for message in failures), failures


def test_phase_24_prints_after_the_control_plane_phase():
    """Phase 24 prints its line after phase 23's, and the ``kernels`` and
    ``ok`` lines stay last."""
    import inspect
    source = inspect.getsource(_chip_smoke().main)
    assert source.index("print('serve-disagg '") < source.index(
        "print('train-resilient '") < source.index(
        "print(json.dumps({'kernels': kernels}))") < source.index("'ok': True")


def test_phase_24_drives_the_resilient_trainer_on_the_cpu(one_torch_thread):
    """Phase 24's five parts at ``gpt2_tiny``'s widths on the CPU (bfloat16
    activations, the flash kernels' plain versions): scanned equals
    unrolled and multi-step equals single steps bit for bit, the NaN step
    is suppressed with every slot frozen, the forced rollback repeats the
    run, and the worker SIGKILLed under the Supervisor restores hot and
    ends where the uninterrupted run ends, bit for bit. Nothing fails."""
    import torch

    chip_smoke = _chip_smoke()
    failures = []
    chip_smoke.fail = failures.append
    model = dict(vocab_size=256, layers=2, dim=64, heads=4, max_seq=128,
                 dropout=0.0, attention='flash', return_features=True)
    result = chip_smoke.train_resilient(torch, 0, 'cpu', model, batch=2,
                                        seq=33, vocab=256)
    assert failures == []
    assert result['scan']['losses_equal'] and result['scan']['params_equal']
    assert result['multi']['bitwise_equal']
    guard = result['guard']
    assert all(guard['checks'].values()) and 6 in guard['flagged']
    assert guard['adam_count'] == 12 - len(guard['flagged'])
    checkpoint = result['checkpoint']
    assert checkpoint['rolled_to'] == 4 and checkpoint['repeats_bitwise']
    assert checkpoint['kept_after_rollback'] == [4]
    assert len(checkpoint['commits']) == 3
    kill = result['kill']
    assert kill['exit_code'] == 0 and kill['exit_codes'] == [-9, 0]
    assert kill['resume'][0]['source'] == 'hot'
    assert kill['resume'][0]['resumed'] == 5
    assert kill['disk_restore'][0]['disk_step'] == 8
    assert kill['losses_equal'] and kill['digest_equal']
    assert kill['hot_bytes'] > 0 and kill['detect_to_first_step_s'] > 0
    # phase 25 (d): the killed worker's flight recorder and the traced
    # recovery
    assert kill['postmortem_steps'] == [1, 2, 3, 4, 5]
    assert kill['postmortem_process'] == 'resilient-worker'
    (spans,) = kill['recovery_spans']
    assert 'recovery rank0' in spans and len(spans) >= 3


def test_phase_25_prints_after_the_resilient_trainer():
    """Phase 25 prints its line after phase 24's, and the ``kernels`` and
    ``ok`` lines stay last."""
    import inspect
    source = inspect.getsource(_chip_smoke().main)
    assert source.index("print('train-resilient '") < source.index(
        "print('observe-lm '") < source.index(
        "print(json.dumps({'kernels': kernels}))") < source.index("'ok': True")


def test_phase_25_serves_traced_on_the_cpu(monkeypatch, one_torch_thread):
    """Phase 25 (c) at ``gpt2_tiny`` on the CPU (the module path: only the
    checks about the card fail, the fused route and the kernels'
    counters): the traced streams equal the untraced ones, one connected
    trace per request with one root, the flight recorder holds the spans
    and ``ServeLatency`` every admission."""
    import numpy as np
    import torch

    from tpusystem_torch.models import gpt2_tiny

    chip_smoke = _chip_smoke()
    failures = []
    monkeypatch.setattr(chip_smoke, 'fail', failures.append)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *args: None)
    module = gpt2_tiny(dtype='float32', device='cpu')
    prompts = [np.random.default_rng(i).integers(0, 256, (n,))
               for i, n in enumerate((20, 30, 70, 20, 30, 70, 10, 45))]
    record = chip_smoke.traced_serving(torch, module, prompts, device='cpu')
    assert record['streams_equal_share'] == 1.0
    assert record['traces'] == len(prompts)
    assert record['request_roots'] == [1] * len(prompts)
    assert record['flight_entries'] == record['spans'] > len(prompts)
    assert record['ttft_count'] == len(prompts)
    assert 0 < record['ttft_p50_s'] <= record['ttft_p99_s']
    assert all("decode_impl='flax'" in message or 'K1/K4/K5' in message
               for message in failures), failures


def test_phase_25_pretrains_and_resumes_the_lm_example_on_the_cpu(
        tmp_path, monkeypatch, one_torch_thread, capsys):
    """Phase 25 (a) on the LM example's tiny preset on the CPU: every
    check holds but the two about the card's kernel counters."""
    import torch

    chip_smoke = _chip_smoke()
    failures = []
    monkeypatch.setattr(chip_smoke, 'fail', failures.append)
    monkeypatch.setattr(chip_smoke, 'LM_EPOCHS', (1, 2))
    record = chip_smoke.pretrain_lm(torch, chip_smoke.lm_example(),
                                    tmp_path, full=False, device='cpu')
    checks = record['checks']
    assert {name for name, held in checks.items() if not held} == {
        'K1 a layer a step', 'K2b a layer a train step'}
    assert len(failures) == 1 and 'K1 a layer a step' in failures[0]
    assert record['printed'][1].endswith('from epoch 1')
    assert len(record['train_tokens_per_s']) == 2
    assert 'from epoch 1' in capsys.readouterr().out


def test_phase_25_profile_fails_without_cuda_kernels(tmp_path, monkeypatch,
                                                     one_torch_thread):
    """Phase 25 (b) on the CPU: ``observe.trace`` writes a trace with the
    two step ranges, and the phase fails because the profiler saw no
    CUDA kernel."""
    import torch

    chip_smoke = _chip_smoke()
    failures = []
    monkeypatch.setattr(chip_smoke, 'fail', failures.append)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *args: None)
    record = chip_smoke.profile_lm(torch, chip_smoke.lm_example(), tmp_path,
                                   full=False, device='cpu')
    assert record['step_ranges'] == chip_smoke.PROFILED_STEPS
    assert record['kernels'] == 0
    assert failures == ['phase 25 (b): the profiler saw no CUDA kernel']


def test_step_kernels_reads_the_kernels_inside_the_step_ranges():
    """A kernel counts when it starts in a device-side step range, or when
    its launch (same correlation) lies in a host-side one; others do
    not."""
    chip_smoke = _chip_smoke()
    events = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'ProfilerStep#1',
         'ts': 100, 'dur': 50},
        {'ph': 'X', 'cat': 'gpu_user_annotation', 'name': 'ProfilerStep#1',
         'ts': 300, 'dur': 100},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
         'ts': 120, 'dur': 2, 'args': {'correlation': 7}},
        {'ph': 'X', 'cat': 'cuda_driver', 'name': 'cuLaunchKernelEx',
         'ts': 10, 'dur': 2, 'args': {'correlation': 8}},
        # launched inside the host range, runs after the device range
        {'ph': 'X', 'cat': 'kernel', 'name': 'void flash_fwd_kernel<64>()',
         'ts': 900, 'dur': 30, 'args': {'correlation': 7}},
        # inside the device range
        {'ph': 'X', 'cat': 'kernel',
         'name': 'void flash_bwd_fused_kernel<64, true>()', 'ts': 350,
         'dur': 40, 'args': {'correlation': 9}},
        # launched before the step, runs before it
        {'ph': 'X', 'cat': 'kernel', 'name': 'void flash_fwd_kernel<64>()',
         'ts': 20, 'dur': 30, 'args': {'correlation': 8}},
    ]
    record = chip_smoke.step_kernels(events)
    assert record['kernels'] == 3 and record['kernels_in_steps'] == 2
    assert record['flash_in_steps'] == {'flash_fwd_kernel': 1,
                                        'flash_bwd_fused_kernel': 1}
    assert record['kernel_ms_in_steps'] == 0.07


def test_phase_26_prints_after_the_lm_phase():
    """Phase 26 prints its line after phase 25's, and the ``kernels`` and
    ``ok`` lines stay last."""
    import inspect
    source = inspect.getsource(_chip_smoke().main)
    assert source.index("print('observe-lm '") < source.index(
        "print('resnet '") < source.index(
        "print(json.dumps({'kernels': kernels}))") < source.index("'ok': True")


def _symmetric_pads(monkeypatch):
    """flax's asymmetric 'SAME' pads replaced by ``k // 2`` on both sides
    (the output shapes stay the same)."""
    from tpusystem_torch.models import resnet
    same = resnet.same_pads
    monkeypatch.setattr(
        resnet, 'same_pads', lambda size, kernel, stride:
        (kernel // 2,) * 2 if sum(same(size, kernel, stride)) % 2
        else same(size, kernel, stride))


def _bf16_residual(monkeypatch):
    """Norms that hand bf16 back where the convolutions are bf16: a bf16
    residual stream."""
    import torch

    from tpusystem_torch.models import resnet
    norm = resnet.GroupNorm.forward
    monkeypatch.setattr(
        resnet.GroupNorm, 'forward', lambda self, hidden:
        norm(self, hidden).to(hidden.dtype)
        if hidden.dtype == torch.bfloat16 else norm(self, hidden))


@pytest.mark.parametrize('broken', [None, _symmetric_pads, _bf16_residual],
                         ids=['as-is', 'symmetric-pads', 'bf16-residual'])
def test_phase_26_holds_the_resnet_on_the_cpu(monkeypatch, one_torch_thread,
                                               broken):
    """Phase 26 (a) at ``resnet_tiny`` on the CPU (both sides on the CPU):
    the port's ResNet passes against the plain forward, and a symmetric
    pad or a bf16 residual stream fails it."""
    import torch

    chip_smoke = _chip_smoke()
    failures = []
    monkeypatch.setattr(chip_smoke, 'fail', failures.append)
    if broken is not None:
        broken(monkeypatch)
    record = chip_smoke.resnet_card_vs_cpu(torch, 0, device='cpu')
    if broken is None:
        assert failures == []
        assert record['plain_float32_max_abs_err'] <= 1e-5
        assert record['residual_bfloat16'] == ['torch.float32']
        assert record['grads_max_abs_err'] == 0.0       # same device
    else:
        assert len(failures) == 1 and 'plain forward' in failures[0]


def test_phase_26_trains_a_small_resnet_on_the_cpu(one_torch_thread):
    """Phase 26 (b)'s loop at ``resnet_tiny``'s widths on the CPU: the
    losses are finite and fall, the record names its ``mfu``
    convention."""
    import torch

    chip_smoke = _chip_smoke()
    failures = []
    chip_smoke.fail = failures.append
    record = chip_smoke.train_resnet(
        torch, 0, 'cpu', batch=4, size=32, steps=3, warmup=2,
        stages=(1, 1), width=16, groups=8, classes=10)
    assert failures == []
    assert len(record['losses']) == 5 and len(record['step_ms']) == 3
    assert record['losses'][-1] < record['losses'][0]
    assert 'training = 3 x forward' in record['mfu_convention']
    assert record['flops_per_step'] == 3 * 4 * record[
        'forward_flops_per_image']


def test_resnet50_forward_flops_from_the_shapes():
    """8.18 GFLOP an image at 224x224: ResNet-50's 4.09 G multiply-adds."""
    from tpusystem_torch.models import resnet50
    flops = _chip_smoke().resnet_forward_flops(resnet50(device='meta'), 224)
    assert flops == 8_178_368_512


def test_kernel_counters_are_every_kernel_wrapper():
    names = {counter.__name__ for counter in _chip_smoke().kernel_counters()}
    assert {'flash_attention_lse', 'flash_bwd_fused', 'flash_bwd_fused_g1',
            'flash_bwd_dq', 'flash_bwd_dkv', 'decode_matmul', 'decode_ffn',
            'gather_rows_matmul', 'matmul_scatter_rows', 'gather_rows',
            'scatter_add_rows', 'bernoulli_mask', 'row_uniforms'} <= names


def test_phase_27_prints_after_the_resnet_phase():
    """Phase 27 prints its line after phase 26's, its K1/K2b launches join
    the ``kernels`` line (phase 28), and the ``kernels`` and ``ok`` lines
    stay last."""
    import inspect
    source = inspect.getsource(_chip_smoke().main)
    assert source.index("print('resnet '") < source.index(
        "print('data-parallel '") < source.index(
        "print(json.dumps({'kernels': kernels}))") < source.index("'ok': True")
    assert source.count("data_parallel_record['launches']") == 2
    assert '28. print the ``kernels`` line' in _chip_smoke().__doc__


def _tiny_flash_gpt2():
    from tpusystem_torch.models import gpt2_tiny
    return gpt2_tiny(attention='flash', return_features=True, device='cpu')


def test_phase_27_drives_both_policies_on_the_cpu(one_torch_thread):
    """Phase 27 (a) and (b) at ``gpt2_tiny`` over a gloo world of one rank
    on the CPU: the collectives at world size one, the checksums against
    the host's, and DP and FSDP bit for bit the unplaced steps; the device
    plane is left behind it."""
    import torch

    chip_smoke = _chip_smoke()
    failures = []
    chip_smoke.fail = failures.append
    record = chip_smoke.data_parallel(torch, 0, device='cpu',
                                      factory=_tiny_flash_gpt2,
                                      shape=(4, 32), two_ranks=False)
    assert failures == []
    assert not torch.distributed.is_initialized()
    assert record['collectives']['data']['backend'] == 'gloo'
    assert 'all_gather_grad' in record['collectives']['fsdp']['checked']
    assert record['checksums']['changed'] == [4]
    runs = record['train']['runs']
    assert set(runs) == {'unplaced', 'dp', 'fsdp'}
    for run in runs.values():
        assert run['params_equal'] and run['losses_equal']
        assert run['losses'] == runs['unplaced']['losses']
        assert len(run['step_ms']) == chip_smoke.DP_STEPS


def test_phase_27_fails_on_a_step_that_is_not_bitwise(monkeypatch,
                                                      one_torch_thread):
    """A DP step whose gradients are off by one ulp fails (b)."""
    import torch

    from tpusystem_torch.train import step as train_step
    chip_smoke = _chip_smoke()
    failures = []
    chip_smoke.fail = failures.append
    sync = train_step.sync_grads
    monkeypatch.setattr(train_step, 'sync_grads', lambda grads, placed, mesh: [
        torch.nextafter(grad, torch.full_like(grad, 1.0))
        for grad in sync(grads, placed, mesh)])
    chip_smoke.data_parallel(torch, 0, device='cpu', factory=_tiny_flash_gpt2,
                             shape=(4, 32), two_ranks=False)
    assert any('not bit for bit' in failure for failure in failures)


def test_host_checksum_is_the_wrapping_word_sum():
    import numpy as np
    import torch

    from tpusystem_torch.parallel.collectives import _bit_checksum
    chip_smoke = _chip_smoke()
    for tensor in (torch.tensor([1.0, -2.5, 3e38]),
                   torch.tensor([0.5, 7.0], dtype=torch.bfloat16),
                   torch.tensor([2 ** 40 + 3, -1], dtype=torch.int64),
                   torch.tensor([True, False, True])):
        assert chip_smoke.host_checksum(tensor) == int(_bit_checksum(tensor))
    words = np.array([0xFFFFFFFF, 2], dtype=np.uint32)
    assert chip_smoke.host_checksum(torch.from_numpy(words.view(
        np.float32))) == 1
