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
