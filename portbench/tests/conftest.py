import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from portbench.tests import tiny  # noqa: E402


@pytest.fixture(scope='session')
def bench(tmp_path_factory) -> pathlib.Path:
    """A copy of the benchmark with the tiny cells beside the real ones."""
    return tiny.make(tmp_path_factory.mktemp('portbench'))
