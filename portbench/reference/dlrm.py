"""The DLRM in plain float32 PyTorch: the yardstick of the DLRM cells.

Dense features through the dense (bottom) MLP, one pooled row from each
table, the pairwise dot products of the ``1 + tables`` vectors (the
strictly lower triangle, row by row), and the over (top) MLP onto one
click logit; binary cross-entropy on the logits, the mean over the batch.
Parameters are a dict of float32 tensors named as the program's modules
name them (``bottom.fc_0.kernel`` is an ``[in, out]`` kernel,
``table_3.embedding`` a table).

A table may be handed over *compacted*: only the rows a set of batches
touches, with the batches' ids renumbered into it (:func:`compact`). Rows
that no id touches take no part in the loss and get no gradient, so every
loss, gradient norm and update is the whole table's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import operand


def _mlp_recipes(prefix: str, widths_in: int, widths: list, out: int,
                 bias_scale: bool) -> list:
    """torch.nn.Linear's initializer: kernel and bias uniform on
    ``±1/sqrt(fan_in)``."""
    leaves = []
    names = [f'fc_{i}' for i in range(len(widths))] + ['head']
    for name, width in zip(names, list(widths) + [out]):
        bound = widths_in ** -0.5
        leaves += [(f'{prefix}.{name}.kernel', (widths_in, width), 'uniform',
                    bound),
                   (f'{prefix}.{name}.bias', (width,), 'uniform',
                    bound if bias_scale else 0.0)]
        widths_in = width
    return leaves


def layout(config: dict) -> dict:
    """The arches' widths as the program builds them: the dense arch's last
    width is the embedding width; the over arch's last width is one logit.
    Both arches end in a linear layer. torchrec's dense arch applies ReLU
    after its last layer too: a departure of the program from the source
    (the configuration's ``assumed``), which the reference follows."""
    dense = config['dense_arch_layer_sizes']
    over = config['over_arch_layer_sizes']
    vectors = 1 + len(config['num_embeddings_per_feature'])
    return dict(bottom=dense[:-1], dim=dense[-1], top=over[:-1],
                top_in=dense[-1] + vectors * (vectors - 1) // 2)


def recipes(config: dict) -> list:
    """Every leaf's recipe: torchrec's initializers (tables uniform on
    ``±1/sqrt(rows)``, linear layers as torch.nn.Linear)."""
    shape = layout(config)
    dim = config['embedding_dim']
    leaves = _mlp_recipes('bottom', config['dense_in_features'],
                          shape['bottom'], shape['dim'], True)
    for table, rows in enumerate(config['num_embeddings_per_feature']):
        leaves.append((f'table_{table}.embedding', (rows, dim), 'uniform',
                       rows ** -0.5))
    leaves += _mlp_recipes('top', shape['top_in'], shape['top'], 1, True)
    return leaves


def is_table(name: str) -> bool:
    return name.startswith('table_')


def compact(ids_batches: list) -> tuple:
    """``(rows, renumbered)``: per table the sorted distinct ids of all the
    batches (``[tables]`` tensors), and each batch's ids renumbered into
    them."""
    tables = ids_batches[0].shape[1]
    stacked = torch.cat([ids.reshape(ids.shape[0], tables)
                         for ids in ids_batches])
    rows, inverse = [], []
    for table in range(tables):
        unique, index = torch.unique(stacked[:, table], return_inverse=True)
        rows.append(unique)
        inverse.append(index)
    inverse = torch.stack(inverse, 1)
    renumbered = list(inverse.split([ids.shape[0] for ids in ids_batches]))
    return rows, renumbered


def _mlp(weights, prefix, hidden, depth, cast):
    for index in range(depth):
        name = f'{prefix}.fc_{index}'
        hidden = F.relu(cast(hidden) @ cast(weights[name + '.kernel'])
                        + weights[name + '.bias'])
    return (cast(hidden) @ cast(weights[prefix + '.head.kernel'])
            + weights[prefix + '.head.bias'])


def logits(weights: dict, dense, ids, config: dict, precision='float32'):
    """``[batch]`` click logits; ``ids`` is ``[batch, tables]``, one id a
    table, renumbered where the tables are compacted."""
    cast = operand(precision)
    shape = layout(config)
    bottom = _mlp(weights, 'bottom', dense.float(), len(shape['bottom']),
                  cast)
    vectors = [bottom] + [weights[f'table_{t}.embedding'][ids[:, t]]
                          for t in range(ids.shape[1])]
    stacked = torch.stack(vectors, 1)
    inter = cast(stacked) @ cast(stacked).transpose(1, 2)
    count = stacked.shape[1]
    low = torch.tril_indices(count, count, offset=-1, device=dense.device)
    pairs = inter[:, low[0], low[1]]
    top = _mlp(weights, 'top', torch.cat([bottom, pairs], -1),
               len(shape['top']), cast)
    return top[:, 0]


def loss_and_grads(weights: dict, dense, ids, labels, config: dict,
                   precision='float32', keep=None):
    """The mean binary cross-entropy and its gradient by leaf; ``keep``
    (a row count) is the fault of half a batch."""
    if keep is not None:
        dense, ids, labels = dense[:keep], ids[:keep], labels[:keep]
    leaves = {name: leaf.detach().requires_grad_(True)
              for name, leaf in weights.items()}
    out = logits(leaves, dense, ids, config, precision)
    loss = F.binary_cross_entropy_with_logits(out, labels.float())
    loss.backward()
    return loss.item(), {name: leaf.grad for name, leaf in leaves.items()}
