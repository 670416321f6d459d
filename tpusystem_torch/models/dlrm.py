"""DLRM-style recommender models: the port of :mod:`tpusystem.models.dlrm`.

Huge sparse lookups into embedding tables
(:class:`tpusystem_torch.recsys.ShardedEmbedding`), small dense MLPs. Two
variants:

* :class:`DLRM` — dense features through a bottom MLP, sparse features
  pooled from their tables, pairwise dot-product interactions (the strictly
  lower triangle), a top MLP onto one click logit. Trained with
  :class:`tpusystem_torch.train.BCEWithLogitsLoss` through the ordinary
  ``build_train_step``.
* :class:`TwoTower` — user and item towers over their own tables (a
  multi-hot history pools by mean), L2-normalised, scored against each
  other: ``forward`` returns the in-batch ``[B, B]`` score matrix.

Module and parameter names mirror the flax tree (``bottom.fc_0.kernel`` is
a ``[in, out]`` kernel, ``table_3.embedding`` a table), so
:func:`tpusystem_torch.convert.params_from_jax` carries the reference's
parameters across name for name. All dense math is float32, as the
reference's (TF32 stays off: ``torch.backends.cuda.matmul.allow_tf32`` is
False by default). Weights are drawn from a generator seeded 0 on the
module's device (lecun-normal kernels with std ``fan_in ** -0.5``, zero
biases, tables normal with std 0.02); :meth:`DLRM.init_weights` redraws
them. Both ship the reference's ``partition_rules()`` (tables row-split
over the ``expert``/``model`` axes, the MLPs replicated) and take a
``mesh`` whose table axes split the tables: the step hands each table to
its lookup as this rank's rows (:meth:`DLRM.keeps_split`), every other
leaf whole. A table whose vocabulary the table axes do not divide stays
whole (the policy drops the rule's axes) and takes the local lookup.
"""

from __future__ import annotations

import re
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpusystem_torch.device import resolve_device
from tpusystem_torch.models.gpt2 import Dense
from tpusystem_torch.parallel.sharding import TABLE_AXES, table_row_spec
from tpusystem_torch.recsys.embedding import ShardedEmbedding
from tpusystem_torch.registry import register


def _keeps_tables(module, name: str) -> tuple:
    """The mesh axes a placed leaf reaches the forward split over: with a
    ``mesh``, a table's rows stay split over the table axes (its lookup is
    the routed one); every other leaf arrives whole."""
    if module.mesh is None or not re.search(r'table(_\d+)?\.embedding$',
                                            name):
        return ()
    return TABLE_AXES


class _MLP(nn.Module):
    """Plain relu MLP: hidden layers ``fc_0 …`` then a linear ``head``."""

    def __init__(self, features_in: int, widths: Sequence[int], out: int, *,
                 device) -> None:
        super().__init__()
        self.depth = len(widths)
        for index, width in enumerate(widths):
            self.add_module(f'fc_{index}', Dense(features_in, width,
                                                 device=device))
            features_in = width
        self.head = Dense(features_in, out, device=device)

    def forward(self, hidden):
        for index in range(self.depth):
            hidden = F.relu(getattr(self, f'fc_{index}')(hidden,
                                                        torch.float32))
        return self.head(hidden, torch.float32)


@torch.no_grad()
def _init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every weight of ``module`` from ``generator``: kernels with
    std ``fan_in ** -0.5``, biases 0, each table with its ``init_scale``."""
    for name, param in module.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        if leaf == 'kernel':
            param.normal_(0.0, param.shape[0] ** -0.5, generator=generator)
        elif leaf == 'bias':
            param.zero_()
    for table in module.modules():
        if isinstance(table, ShardedEmbedding):
            table.init_weights(generator)


class DLRM(nn.Module):
    """Deep Learning Recommendation Model.

    ``forward(batch)`` takes the pytree batch
    :class:`tpusystem_torch.data.SyntheticClicks` yields::

        {'dense': [B, dense_features] float,
         'ids':   [B, features, hot] int, -1-padded multi-hot,
         'weights': [B, features, hot] float (optional per-id weights)}

    and returns ``[B]`` click logits. Sparse feature *f* looks up table *f*,
    pools its hot rows by summation (padded ids give exact zero rows), and
    the ``1 + features`` vectors (the bottom MLP's output first) interact
    through their pairwise dot products before the top MLP.

    Attributes:
        vocabs: per-sparse-feature table sizes.
        dim: embedding dimension (shared: interactions need one width).
        dense_features: width of the dense input.
        bottom: bottom-MLP hidden widths (its output is ``dim`` wide).
        top: top-MLP hidden widths (its output is one logit).
        mesh: a mesh of ranks whose ``expert``/``model`` axes row-split
            the tables.
        impl / dedup: lookup knobs, passed to every table.
        device: the card unless ``'cpu'`` is asked for.
    """

    def __init__(self, vocabs: Sequence[int] = (128, 64), dim: int = 16,
                 dense_features: int = 4, bottom: Sequence[int] = (32,),
                 top: Sequence[int] = (32,), mesh: object = None,
                 impl: str = 'auto', dedup: bool = True, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.vocabs, self.dim = tuple(vocabs), dim
        self.dense_features = dense_features
        self.mesh, self.impl, self.dedup = mesh, impl, dedup
        self.bottom = _MLP(dense_features, bottom, dim, device=device)
        for feature, vocab in enumerate(self.vocabs):
            self.add_module(f'table_{feature}', ShardedEmbedding(
                vocab, dim, mesh=mesh, impl=impl, dedup=dedup, device=device))
        vectors = 1 + len(self.vocabs)
        self.top = _MLP(dim + vectors * (vectors - 1) // 2, top, 1,
                        device=device)
        self.init_weights(torch.Generator(device).manual_seed(0))

    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator`` (on the weights' device)."""
        _init_weights(self, generator)

    def forward(self, batch, train: bool = False):
        dense = batch['dense'].float()
        ids = batch['ids']
        weights = batch.get('weights') if hasattr(batch, 'get') else None
        if dense.shape[-1] != self.dense_features:
            raise ValueError(f'dense slice is {dense.shape[-1]} wide, model '
                             f'expects {self.dense_features}')
        if ids.shape[1] != len(self.vocabs):
            raise ValueError(f'batch carries {ids.shape[1]} sparse features, '
                             f'model has {len(self.vocabs)} tables')
        bottom = self.bottom(dense)
        vectors = [bottom]
        for feature in range(len(self.vocabs)):
            rows = getattr(self, f'table_{feature}')(
                ids[:, feature],
                None if weights is None else weights[:, feature])
            vectors.append(rows.sum(1))                 # padded rows are zero
        stacked = torch.stack(vectors, 1)               # [B, 1+F, dim]
        # pairwise dot-product interactions, strictly-lower triangle
        inter = torch.bmm(stacked, stacked.transpose(1, 2))
        count = stacked.shape[1]
        lower = torch.tril_indices(count, count, offset=-1,
                                   device=stacked.device)
        # one flat index per pair: its backward adds each gradient once into
        # zeros, which 2-D advanced indexing does through a slower sort
        tri = inter.flatten(1).index_select(1, lower[0] * count + lower[1])
        logits = self.top(torch.cat([bottom, tri], -1))
        return logits[:, 0]

    @staticmethod
    def partition_rules():
        """The reference's rules (``dlrm.py:123``): tables row-split over
        the combined ``expert``/``model`` axes
        (:func:`~tpusystem_torch.parallel.sharding.table_row_spec`); the
        small MLPs replicated (``fsdp=True`` on the policy scatters them
        anyway)."""
        return ((r'table_\d+/embedding$', table_row_spec(2)),)

    keeps_split = _keeps_tables


register(DLRM, excluded_kwargs={'mesh', 'device'})


class TwoTower(nn.Module):
    """Two-tower retrieval model over user and item tables.

    ``forward({'user': [B] or [B, K] ids, 'item': [B] ids})`` embeds each
    side (a multi-hot user history pools by mean over its valid ids), runs
    it through its tower MLP, L2-normalises, and returns the in-batch
    ``[B, B]`` scores ``<user_i, item_j> / temperature``: train it as a
    B-way classification with ``targets = arange(B)``, evaluate recall@k on
    the same matrix."""

    def __init__(self, users: int = 256, items: int = 128, dim: int = 16,
                 tower: Sequence[int] = (32,), temperature: float = 0.05,
                 mesh: object = None, impl: str = 'auto', dedup: bool = True,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.users, self.items, self.dim = users, items, dim
        self.temperature, self.mesh = temperature, mesh
        self.impl, self.dedup = impl, dedup
        for name, vocab in (('user', users), ('item', items)):
            self.add_module(f'{name}_table', ShardedEmbedding(
                vocab, dim, mesh=mesh, impl=impl, dedup=dedup, device=device))
            self.add_module(f'{name}_tower', _MLP(dim, tower, dim,
                                                  device=device))
        self.init_weights(torch.Generator(device).manual_seed(0))

    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator`` (on the weights' device)."""
        _init_weights(self, generator)

    def _tower(self, name: str, ids):
        rows = getattr(self, f'{name}_table')(ids)
        if rows.dim() == 3:                               # multi-hot history
            count = (ids >= 0).float().sum(1)
            rows = rows.sum(1) / torch.clamp(count, min=1.0)[:, None]
        vector = getattr(self, f'{name}_tower')(rows)
        norm = torch.sqrt((vector * vector).sum(-1, keepdim=True))
        return vector / torch.clamp(norm, min=1e-6)

    def forward(self, batch, train: bool = False):
        user = self._tower('user', batch['user'])
        item = self._tower('item', batch['item'])
        return (user @ item.T) / self.temperature

    @staticmethod
    def partition_rules():
        """The reference's rules (``dlrm.py:173``): both tables row-split
        over the ``expert``/``model`` axes."""
        return ((r'(user|item)_table/embedding$', table_row_spec(2)),)

    keeps_split = _keeps_tables


register(TwoTower, excluded_kwargs={'mesh', 'device'})


def dlrm_tiny(**overrides) -> DLRM:
    """Test scale: runs in seconds on the CPU."""
    config = dict(vocabs=(64, 32), dim=8, dense_features=4,
                  bottom=(16,), top=(16,))
    config.update(overrides)
    return DLRM(**config)


def two_tower_tiny(**overrides) -> TwoTower:
    config = dict(users=64, items=32, dim=8, tower=(16,))
    config.update(overrides)
    return TwoTower(**config)
