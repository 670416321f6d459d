"""The port's native batch-assembly core (``tpusystem_torch.data.native``)
against the reference's (``tpusystem.data.native``): the twin of
``tests/test_native.py``.

Both packages build the same ``batcher.cpp`` with the system C++
toolchain. The contract under test is the reference's: the native gather
is bit-identical to numpy fancy indexing, its absence (or any unusual
input) degrades to numpy, and on the same seeded arrays the port's
``gather`` and ``gather_windows`` equal the reference's bit for bit.
"""

import numpy as np
import pytest

from tpusystem.data import native as reference_native
from tpusystem_torch.data import ArrayDataset, native


@pytest.fixture(scope='module')
def lib():
    library = native.library()
    if library is None:
        pytest.skip('no C++ toolchain available')
    return library


def _same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_builds_into_the_ports_own_directory(lib):
    assert lib.ts_abi_version() == 2
    assert native.available()
    built = sorted(native.BUILD_DIR.glob('batcher-*.so'))
    assert built and built[0].parent.parent.name == 'native'
    assert native._SOURCE.read_bytes().split(b'\n', 2)[2] == (
        reference_native._SOURCE.read_bytes().split(b'\n', 1)[1])


@pytest.mark.parametrize('dtype', [np.float32, np.int32, np.uint8, np.float64])
@pytest.mark.parametrize('shape', [(), (17,), (28, 28), (3, 8, 8)])
def test_gather_matches_numpy_and_the_reference(lib, dtype, shape):
    rng = np.random.default_rng(0)
    array = rng.integers(0, 200, size=(64,) + shape).astype(dtype)
    indices = rng.integers(0, 64, size=33)
    got = native.gather(array, indices)
    np.testing.assert_array_equal(got, array[indices])
    _same(got, reference_native.gather(array, indices))


def test_gather_into_preallocated_buffer(lib):
    array = np.arange(40, dtype=np.float32).reshape(10, 4)
    indices = np.array([9, 0, 3])
    out = np.empty((3, 4), np.float32)
    result = native.gather(array, indices, out=out)
    assert result is out
    _same(out, reference_native.gather(array, indices))


def test_gather_large_enough_to_go_multithreaded(lib):
    # > 1 MiB/worker threshold: exercises the threaded path
    rng = np.random.default_rng(1)
    array = rng.standard_normal((4096, 1024)).astype(np.float32)  # 16 MiB
    indices = rng.permutation(4096)
    got = native.gather(array, indices)
    np.testing.assert_array_equal(got, array[indices])
    _same(got, reference_native.gather(array, indices))


def test_negative_and_out_of_range_keep_numpy_semantics(lib):
    array = np.arange(12, dtype=np.int64).reshape(6, 2)
    _same(native.gather(array, np.array([-1, 0])),
          reference_native.gather(array, np.array([-1, 0])))
    with pytest.raises(IndexError):
        native.gather(array, np.array([6]))


def test_boolean_mask_keeps_numpy_selection_semantics(lib):
    array = np.arange(12, dtype=np.int64).reshape(6, 2)
    mask = np.array([False, True, False, True, False, False])
    _same(native.gather(array, mask), array[mask])


def test_float_indices_raise_like_numpy(lib):
    array = np.arange(12, dtype=np.int64).reshape(6, 2)
    with pytest.raises(IndexError):
        native.gather(array, np.array([1.0, 2.0]))


def test_mismatched_out_buffer_is_validated_not_corrupted(lib):
    array = np.arange(40, dtype=np.float32).reshape(10, 4)
    indices = np.array([1, 2, 3])
    wrong_dtype = np.empty((3, 4), np.float64)
    result = native.gather(array, indices, out=wrong_dtype)  # numpy copyto path
    np.testing.assert_array_equal(result, array[indices])
    with pytest.raises(ValueError):
        native.gather(array, indices, out=np.empty((2, 4), np.float32))


def test_overlapping_out_buffer_stays_correct(lib):
    """out aliasing the source must not be fed to the raw memcpy — numpy
    materializes array[indices] first, so [5, 0] into a[:2] is [a5, a0]."""
    array = np.arange(12, dtype=np.float32).reshape(6, 2)
    expected = array[np.array([5, 0])].copy()
    result = native.gather(array, np.array([5, 0]), out=array[:2])
    np.testing.assert_array_equal(result, expected)


def test_non_contiguous_falls_back(lib):
    array = np.arange(48, dtype=np.float32).reshape(12, 4)[:, ::2]
    assert not array.flags.c_contiguous
    indices = np.array([1, 5, 0])
    _same(native.gather(array, indices), reference_native.gather(array,
                                                                 indices))


def test_disabled_by_env_falls_back(monkeypatch):
    monkeypatch.setattr(native, '_lib', False)
    monkeypatch.setenv('TPUSYSTEM_NO_NATIVE', '1')
    assert not native.available()
    array = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_array_equal(
        native.gather(array, np.array([4, 2])), array[[4, 2]])
    monkeypatch.setattr(native, '_lib', False)   # re-probe for other tests


def test_array_dataset_uses_native_path(lib):
    rng = np.random.default_rng(2)
    inputs = rng.standard_normal((50, 7)).astype(np.float32)
    targets = rng.integers(0, 10, size=50)
    dataset = ArrayDataset(inputs, targets)
    span = np.array([3, 1, 4, 1, 5])
    got_inputs, got_targets = dataset[span]
    _same(got_inputs, inputs[span])
    _same(got_targets, targets[span])


@pytest.mark.parametrize('dtype', [np.uint16, np.int32, np.float32])
def test_gather_windows_matches_numpy_and_the_reference(lib, dtype):
    rng = np.random.default_rng(3)
    corpus = rng.integers(0, 500, size=4096).astype(dtype)
    starts = rng.integers(0, 4096 - 65, size=48)
    window = 65
    reference = corpus[starts[:, None] + np.arange(window)[None, :]]
    got = native.gather_windows(corpus, starts, window)
    np.testing.assert_array_equal(got, reference)
    _same(got, reference_native.gather_windows(corpus, starts, window))


def test_gather_windows_overlapping_and_from_memmap(lib, tmp_path):
    corpus = np.arange(10_000, dtype=np.uint16)
    path = tmp_path / 'corpus.bin'
    corpus.tofile(path)
    mapped = np.memmap(path, dtype=np.uint16, mode='r')
    starts = np.arange(0, 9000, 7)          # overlapping windows
    window = 129
    got = native.gather_windows(mapped, starts, window)
    np.testing.assert_array_equal(
        got, mapped[starts[:, None] + np.arange(window)[None, :]])
    _same(got, reference_native.gather_windows(mapped, starts, window))


def test_gather_windows_falls_back_out_of_range(lib):
    corpus = np.arange(100, dtype=np.int32)
    with pytest.raises(IndexError):
        native.gather_windows(corpus, np.array([90]), 20)  # numpy semantics


def test_memmap_tokens_batched_windows_are_the_references(lib, tmp_path):
    from tpusystem.data import MemmapTokens as ReferenceTokens
    from tpusystem_torch.data import MemmapTokens
    corpus = np.random.default_rng(4).integers(0, 50000, size=5000,
                                               dtype=np.uint16)
    path = tmp_path / 'tokens.bin'
    corpus.tofile(path)
    span = np.asarray([0, 3, 7, 3])
    for stride in (None, 32):
        (got,) = MemmapTokens(path, sequence_length=64, stride=stride)[span]
        (want,) = ReferenceTokens(path, sequence_length=64,
                                  stride=stride)[span]
        assert got.shape == (4, 65) and got.dtype == np.int32
        _same(got, want)
