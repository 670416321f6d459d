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
