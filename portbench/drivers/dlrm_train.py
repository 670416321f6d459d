"""The recommender training path: the DLRM through the program's host
layers, as the program's own recommender composition wires it.

The model is the program's ``DLRM`` carrying the benchmark's weights,
drawn from the seed. An ``Aggregate`` holds it with its train state; its
step is ``build_train_step`` over ``BCEWithLogitsLoss`` and the
configuration's ``SGD``. A ``Service``'s ``train`` handler iterates the
batches it is given, which the program's ``Loader`` makes from the mix's
click pool.

Set-up runs the first three steps through that handler, one call each, and
keeps what the correctness check reads: the losses, the first gradient's
norm by leaf (the first update over the learning rate) and each leaf's
change over the three, the starting weights redrawn chunk by chunk.
"""

from __future__ import annotations

import types

import torch

from portbench import harness, weights
from portbench.counts import dlrm as counts
from portbench.reference import dlrm as plain
from portbench.reference import optim as reference_optim
from portbench.reference.precision import no_tf32

FIRST_STEPS = 3
GRADIENT_FLOOR = 1e-3


def build_program(config: dict, device):
    """The program's model, optimizer, aggregate class and handler."""
    from tpusystem_torch import Aggregate
    from tpusystem_torch.models import DLRM
    from tpusystem_torch.services import Service
    from tpusystem_torch.train import (SGD, BCEWithLogitsLoss,
                                       build_train_step, init_state,
                                       module_apply)

    shape = plain.layout(config)
    module = DLRM(vocabs=config['num_embeddings_per_feature'],
                  dim=config['embedding_dim'],
                  dense_features=config['dense_in_features'],
                  bottom=shape['bottom'], top=shape['top'], device=device)
    optimizer = SGD(lr=config['optimizer']['lr'])
    step = build_train_step(module_apply(module), BCEWithLogitsLoss(),
                            optimizer)

    class Recommender(Aggregate):
        """The model, its train state and its step."""

        def __init__(self, network, state):
            super().__init__()
            self.network, self.state = network, state

        @property
        def id(self) -> str:
            return 'dlrm'

        def fit(self, features, labels):
            self.state, (_, loss) = step(self.state, features, labels)
            return loss

    model = Recommender(module, init_state(module, optimizer))
    return module, model, Service('portbench')


def prepare(ctx):
    from tpusystem_torch.data import Loader

    config, mix = ctx.config, ctx.traffic
    module, model, service = build_program(config, ctx.device)
    recipes = {recipe[0]: recipe for recipe in plain.recipes(config)}
    for name, param in module.named_parameters():
        weights.draw_into(param.data, ctx.seed, recipes[name])
    spans = ctx.spans

    @service.handler
    def train(model, batches):
        losses = []
        for features, labels in batches:
            with spans.span('step'):
                losses.append(model.fit(features, labels))
        return losses

    generator = harness.load_module('generators', mix['generator'], ctx.bench)
    pool = generator.pool(mix, config, ctx.seed, ctx.device)
    loader = Loader(pool, mix['batch'], shuffle=True, seed=ctx.seed,
                    device=ctx.device)
    return types.SimpleNamespace(
        ctx=ctx, model=model, service=service,
        feed=harness.Feed(loader, spans), recipes=recipes, first=[],
        batch=mix['batch'])


def warm(session) -> dict:
    """The first steps, through the window's handler and feed."""
    model, service, ctx = session.model, session.service, session.ctx
    lr = ctx.config['optimizer']['lr']
    losses, grads = [], None

    def distances():
        return {name: weights.distance_norm(param, ctx.seed,
                                            session.recipes[name])
                for name, param in model.state.params.items()}

    for index in range(FIRST_STEPS):
        batches = list(session.feed.take(count=1))
        features, labels = batches[0]
        session.first.append((features['dense'].clone(),
                              features['ids'].clone(), labels.clone()))
        losses += service.handle('train', model, iter(batches))
        if index == 0:
            grads = {name: norm / lr for name, norm in distances().items()}
    session.rows = touched_rows(session.first)
    return {'losses': [float(loss) for loss in losses], 'grads': grads,
            'changes': distances()}


def touched_rows(first: list) -> int:
    """Distinct ids a batch holds, summed over the tables: the mean over
    the first batches, which are drawn as every later one is."""
    total = 0
    for _, ids, _ in first:
        flat = ids.reshape(ids.shape[0], -1)
        total += sum(int(torch.unique(flat[:, table]).numel())
                     for table in range(flat.shape[1]))
    return total // len(first)


def window(session, deadline: float) -> dict:
    losses = session.service.handle('train', session.model,
                                     session.feed.take(deadline=deadline))
    steps = len(losses)
    finite = torch.isfinite(torch.stack(losses)).sum().item() if steps else 0
    config, batch, rows = session.ctx.config, session.batch, session.rows
    return {'attempted': steps, 'failed': steps - finite, 'counts': {
        'steps': steps, 'samples': steps * batch,
        'flops': steps * counts.train_step_flops(config, batch),
        'bytes': steps * counts.train_step_bytes(config, batch, rows),
        'lookup_bytes': steps * counts.lookup_bytes(config, batch, rows),
        'dtype': config['program']['dtype']}}


def release(session) -> None:
    session.feed.close()
    session.model = session.service = session.feed = None


def reference_readings(ctx, batches: list, precision: str = 'float32',
                       keep: int | None = None) -> dict:
    """The plain reference over the first batches from the seed's weights,
    the tables compacted to the rows the batches touch: its losses, its
    first gradient's norms and each leaf's change over the steps."""
    no_tf32()
    config = ctx.config
    rows, renumbered = plain.compact([ids for _, ids, _ in batches])
    params = {}
    for recipe in plain.recipes(config):
        drawn = weights.draw(ctx.seed, recipe, ctx.device)
        if plain.is_table(recipe[0]):
            table = int(recipe[0].split('_')[1].split('.')[0])
            drawn = drawn[rows[table]]
        params[recipe[0]] = drawn
    start = {name: leaf.clone() for name, leaf in params.items()}
    optimizer = reference_optim.optimizer(config['optimizer'])
    losses, grads = [], None
    for (dense, _, labels), ids in zip(batches, renumbered):
        loss, raw = plain.loss_and_grads(params, dense, ids, labels,
                                             config, precision, keep)
        optimizer.step(params, raw)
        if grads is None:
            grads = {name: float(g.norm()) for name, g in raw.items()}
        losses.append(loss)
    changes = {name: float((params[name] - start[name]).norm())
               for name in params}
    return {'losses': losses, 'grads': grads, 'changes': changes}


def kept(reference: dict) -> list:
    """The leaves whose first gradient in the reference is at least
    :data:`GRADIENT_FLOOR` of the median leaf's: a leaf under it moves by
    round-off alone."""
    typical = harness.median(reference['grads'].values())
    return [name for name, norm in reference['grads'].items()
            if norm >= GRADIENT_FLOOR * typical]


def reference(session, program: dict) -> dict:
    readings = reference_readings(session.ctx, session.first)
    leaves = kept(readings)
    readings['changes'] = {name: readings['changes'][name]
                           for name in leaves}
    return readings


checks = harness.train_checks


def planted(session, precision: str = 'float32',
            keep: int | None = None) -> dict:
    """The checks of the reference put in the program's place: at a lower
    ``precision`` (the control) or over the first ``keep`` rows alone (the
    fault of half a batch)."""
    stand_in = reference_readings(session.ctx, session.first, precision,
                                  keep)
    readings = reference(session, None)
    stand_in['changes'] = {name: stand_in['changes'][name]
                           for name in readings['changes']}
    return checks(stand_in, readings)
