"""Operations and bytes of the DLRM's work, from its shapes and the ids a
batch holds.

The update is counted row-sparse: a step reads and writes the table rows
its batch touches, once, whatever the program does with the rest of a
table. So the counts do not change when the program's update is dense.
"""

from __future__ import annotations

FLOAT = 4
INDEX = 4


def _widths(config: dict) -> tuple:
    dense = config['dense_arch_layer_sizes']
    over = config['over_arch_layer_sizes']
    vectors = 1 + len(config['num_embeddings_per_feature'])
    pairs = vectors * (vectors - 1) // 2
    bottom = [config['dense_in_features']] + list(dense)
    top = [dense[-1] + pairs] + list(over)
    return bottom, top, pairs


def mlp_weights(config: dict) -> int:
    """Kernel weights of both arches."""
    bottom, top, _ = _widths(config)
    return sum(a * b for widths in (bottom, top)
               for a, b in zip(widths, widths[1:]))


def mlp_parameters(config: dict) -> int:
    bottom, top, _ = _widths(config)
    return mlp_weights(config) + sum(bottom[1:]) + sum(top[1:])


def train_step_flops(config: dict, batch: int) -> float:
    """3 x the forward: the arches' products and the interaction's
    distinct pairwise dot products."""
    _, _, pairs = _widths(config)
    dim = config['embedding_dim']
    forward = 2 * batch * mlp_weights(config) + 2 * batch * pairs * dim
    return 3.0 * forward


def train_step_bytes(config: dict, batch: int, touched_rows: int) -> float:
    """The batch's inputs read once, the touched table rows read and
    written once, the arches' parameters read and written once."""
    tables = len(config['num_embeddings_per_feature'])
    inputs = batch * (config['dense_in_features'] * FLOAT + tables * INDEX
                      + FLOAT)
    rows = touched_rows * config['embedding_dim'] * FLOAT
    return float(inputs + 2 * rows + 2 * mlp_parameters(config) * FLOAT)


def lookup_bytes(config: dict, batch: int, touched_rows: int) -> float:
    """The embedding tier's least bytes a step: the lookups read each
    touched row and the ids once and write the pooled rows; the backward
    reads the pooled rows' gradients and the ids once and writes each
    touched row's gradient once."""
    tables = len(config['num_embeddings_per_feature'])
    row = config['embedding_dim'] * FLOAT
    forward = touched_rows * row + batch * tables * (INDEX + row)
    backward = batch * tables * (INDEX + row) + touched_rows * row
    return float(forward + backward)
