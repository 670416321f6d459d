"""The language-model training path: GPT-2 through the program's host
layers.

The model is the program's ``GPT2`` (flash attention, bfloat16 compute,
float32 master weights, features for the chunked loss) carrying the
benchmark's weights, drawn from the seed. An ``Aggregate`` holds it with
its train state; its step is ``build_train_step`` over the configuration's
``ChunkedNextTokenLoss`` and ``AdamW``. A ``Service``'s ``train`` handler
iterates the batches it is given, which the program's ``Loader`` makes from
the mix's token pool.

Set-up runs the first three steps through that handler, one call each, and
keeps what the correctness check reads: the losses, the first gradient's
norm by leaf (from AdamW's first moment after one step) and the weights
after the three, copied to the host. The window then calls the handler
once with the batches that start before its deadline.

Each leaf's change over the three steps is compared over the elements
whose first gradient in the reference is at least
:data:`GRADIENT_FLOOR` of the median leaf's gradient a element: AdamW moves
an element whose gradient is nought to rounding (the key's part of the
fused qkv bias, under softmax) by about its learning rate whatever the
rounding was, so those elements measure round-off, not the program.
"""

from __future__ import annotations

import types

import torch

from portbench import harness, weights
from portbench.counts import gpt2 as counts
from portbench.reference import gpt2 as plain
from portbench.reference import optim as reference_optim
from portbench.reference.precision import no_tf32

FIRST_STEPS = 3
GRADIENT_FLOOR = 1e-3


def build_program(config: dict, device):
    """The program's model, state and ``train`` handler, weights unset."""
    from tpusystem_torch import Aggregate
    from tpusystem_torch.models import GPT2
    from tpusystem_torch.services import Service
    from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)

    program = config['program']
    settings = dict(config['optimizer'])
    settings.pop('name')
    dim = config['n_embd']
    module = GPT2(vocab_size=config['vocab_size'], layers=config['n_layer'],
                  dim=dim, heads=config['n_head'],
                  max_seq=config['n_positions'],
                  mlp_ratio=(config.get('n_inner') or 4 * dim) // dim,
                  dropout=config['resid_pdrop'], dtype=program['dtype'],
                  attention=program['attention'], return_features=True,
                  device=device)
    optimizer = AdamW(**settings)
    step = build_train_step(module_apply(module), ChunkedNextTokenLoss(
        chunks=program['loss_chunks']), optimizer)

    class LanguageModel(Aggregate):
        """The model, its train state and its step."""

        def __init__(self, network, state):
            super().__init__()
            self.network, self.state = network, state

        @property
        def id(self) -> str:
            return 'gpt2'

        def fit(self, tokens):
            self.state, (_, loss) = step(self.state, tokens, tokens)
            return loss

    service = Service('portbench')
    return module, optimizer, LanguageModel, init_state, service


def prepare(ctx):
    from tpusystem_torch.data import ArrayDataset, Loader

    config, mix = ctx.config, ctx.traffic
    module, optimizer, LanguageModel, init_state, service = build_program(
        config, ctx.device)
    recipes = {recipe[0]: recipe for recipe in plain.recipes(config)}
    for name, param in module.named_parameters():
        weights.draw_into(param.data, ctx.seed, recipes[name])
    model = LanguageModel(module, init_state(module, optimizer,
                                             rng=ctx.seed))
    spans = ctx.spans

    @service.handler
    def train(model, batches):
        losses = []
        for (tokens,) in batches:
            with spans.span('step'):
                losses.append(model.fit(tokens))
        return losses

    generator = harness.load_module('generators', mix['generator'], ctx.bench)
    pool = generator.pool(mix, config, ctx.seed, ctx.device).numpy()
    loader = Loader(ArrayDataset(pool), mix['batch'], shuffle=True,
                    seed=ctx.seed, device=ctx.device)
    return types.SimpleNamespace(
        ctx=ctx, model=model, service=service, optimizer=optimizer,
        feed=harness.Feed(loader, spans), first=[],
        batch=mix['batch'], length=mix['length'])


def warm(session) -> dict:
    """The first steps, through the window's handler and feed."""
    model, service = session.model, session.service
    losses, grads, b1 = [], None, session.optimizer.b1
    for index in range(FIRST_STEPS):
        batches = list(session.feed.take(count=1))
        session.first.append(batches[0][0].clone())
        losses += service.handle('train', model, iter(batches))
        if index == 0:
            moments = model.state.opt_state['mu']
            grads = {name: float(moment.float().norm()) / (1 - b1)
                     for name, moment in moments.items()}
    session.after = {}
    for name, param in model.state.params.items():
        host = torch.empty(param.shape, dtype=param.dtype,
                           pin_memory=param.is_cuda)
        session.after[name] = host.copy_(param.detach())
    return {'losses': [float(loss) for loss in losses], 'grads': grads}


def window(session, deadline: float) -> dict:
    losses = session.service.handle('train', session.model,
                                     session.feed.take(deadline=deadline))
    steps = len(losses)
    finite = torch.isfinite(torch.stack(losses)).sum().item() if steps else 0
    config = session.ctx.config
    batch, length = session.batch, session.length
    attention_flops, attention_bytes = counts.train_attention(
        config, batch, length)
    return {'attempted': steps, 'failed': steps - finite, 'counts': {
        'steps': steps, 'tokens': steps * batch * length,
        'flops': steps * counts.train_step_flops(config, batch, length),
        'attention_flops': steps * attention_flops,
        'attention_bytes': steps * attention_bytes,
        'dtype': config['program']['dtype']}}


def release(session) -> None:
    session.feed.close()
    session.model = session.service = session.optimizer = None
    session.feed = None


def reference_readings(ctx, batches: list, precision: str = 'float32',
                       keep: int | None = None) -> dict:
    """The plain reference over the first batches from the seed's weights:
    its losses, its first gradient after the clip (``first``, by element,
    and its norms by leaf) and its weights after the steps."""
    no_tf32()
    config = ctx.config
    params = {recipe[0]: weights.draw(ctx.seed, recipe, ctx.device)
              for recipe in plain.recipes(config)}
    optimizer = reference_optim.optimizer(config['optimizer'])
    losses, first = [], None
    for tokens in batches:
        loss, raw = plain.loss_and_grads(
            params, tokens.long(), config, config['reference_rows'],
            precision, keep)
        used = optimizer.step(params, raw)
        if first is None:
            first = used
        losses.append(loss)
        del raw, used
    return {'losses': losses, 'first': first, 'after': params,
            'grads': {name: float(g.norm()) for name, g in first.items()}}


def change_norms(ctx, after: dict, first: dict) -> dict:
    """Each leaf's change from the seed's weights, over the elements whose
    first gradient ``first`` is at least :data:`GRADIENT_FLOOR` of the
    median leaf's gradient a element; leaves with none are left out."""
    scale = harness.median([float(g.norm()) / g.numel() ** 0.5
                            for g in first.values()])
    norms = {}
    for recipe in plain.recipes(ctx.config):
        name = recipe[0]
        kept = first[name].abs() >= GRADIENT_FLOOR * scale
        if kept.any():
            moved = after[name].to(ctx.device) - weights.draw(
                ctx.seed, recipe, ctx.device)
            norms[name] = float(moved[kept].norm())
    return norms


def judged(ctx, program: dict, reference: dict) -> tuple:
    """Both readings with their changes, over the reference's elements."""
    first = reference['first']
    program = dict(program, changes=change_norms(ctx, program['after'],
                                                 first))
    reference = dict(reference, changes=change_norms(
        ctx, reference['after'], first))
    return program, reference


def reference(session, program: dict) -> dict:
    readings = reference_readings(session.ctx, session.first)
    program['after'] = session.after
    program['changes'], readings['changes'] = (
        side['changes'] for side in judged(session.ctx, program, readings))
    return readings


def checks(program: dict, reference: dict) -> dict:
    """The gradient and change gaps of :func:`harness.train_checks`. The
    loss is not compared: at its third step it swings from seed to seed
    (AdamW's first update moves each weight by about its learning rate
    whatever the size of its gradient, so the bf16 rounding of the first
    gradient reaches the later losses magnified), and at its first step
    neither the control nor a fault reads three times what sound runs
    do."""
    gaps = harness.train_checks(program, reference)
    return {name: gaps[name] for name in ('grad_gap', 'change_gap')}


def planted(session, precision: str = 'float32',
            keep: int | None = None) -> dict:
    """The checks of the reference put in the program's place: at a lower
    ``precision`` (the control) or over the first ``keep`` rows alone (the
    fault of half a batch)."""
    ctx = session.ctx
    stand_in = reference_readings(ctx, session.first, precision, keep)
    readings = reference_readings(ctx, session.first)
    return checks(*judged(ctx, stand_in, readings))
