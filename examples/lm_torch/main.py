"""Language-model pretraining system on the PyTorch port (the twin of
``examples/lm/main.py``): the tinysys architecture at LM scale.

The same message-driven stack as ``examples/tinysys_torch`` (compiler
pipeline, named service handlers, event consumers, resume-by-identity),
applied to a GPT-2 aggregate trained with the fused chunked LM loss under
the FSDP policy on the job's mesh — one device in the port, so the policy
places the state on it. Every piece is a DI seam: swap the mesh, the policy,
the dataset (``MemmapTokens('corpus.bin')`` for a real corpus), or the
preset from this composition root without touching the system.

Run: ``python main.py [epochs]``  (tiny preset; ``--full`` for 125M; the
CUDA card unless ``--device`` says otherwise).
"""

from __future__ import annotations

import contextlib
import logging
import pathlib

import torch

from tpusystem_torch import Aggregate, Compiler, Depends, Runtime
from tpusystem_torch.checkpoint import Repository
from tpusystem_torch.data import Loader, MemmapTokens, SyntheticTokens
from tpusystem_torch.depends import Provider
from tpusystem_torch.models import GPT2, gpt2_tiny
from tpusystem_torch.observe import (checkpoint_consumer, logging_consumer,
                                     tracking)
from tpusystem_torch.observe.events import Iterated, Trained, Validated
from tpusystem_torch.observe.profile import StepTimer
from tpusystem_torch.parallel import (FullyShardedDataParallel, MeshSpec,
                                      batch_sharding, stacked_batch_sharding)
from tpusystem_torch.registry import gethash
from tpusystem_torch.services import Producer, Service
from tpusystem_torch.storage import (DocumentIterations, DocumentMetrics,
                                     DocumentModels, DocumentModules,
                                     DocumentStore)
from tpusystem_torch.train import (AdamW, ChunkedNextTokenLoss, Mean,
                                   Perplexity, build_eval_step,
                                   build_multi_eval_step, build_multi_step,
                                   build_train_step, grouped_batches,
                                   init_state, module_apply)

ROOT = pathlib.Path(__file__).parent / 'data'


# --------------------------------------------------------------------------
# aggregate

class LanguageModel(Aggregate):
    """Network + criterion + optimizer as one identity-bearing unit; the
    math is the port's train and eval steps over a TrainState on the mesh's
    device."""

    def __init__(self, network, criterion, optimizer, accumulate: int = 1):
        super().__init__()
        self.network = network
        self.criterion = criterion
        self.optimizer = optimizer
        self.state = None
        self.mesh = None
        self.epoch = 0
        self.accumulate = accumulate
        self._build_steps(network)

    def _build_steps(self, network) -> None:
        apply_fn = module_apply(network)
        self._train_step = build_train_step(apply_fn, self.criterion,
                                            self.optimizer,
                                            accumulate=self.accumulate)
        self._eval_step = build_eval_step(apply_fn, self.criterion)
        # N steps per host dispatch, their losses stacked on the device
        self._train_many = build_multi_step(self._train_step)
        self._eval_many = build_multi_eval_step(self._eval_step)

    @property
    def id(self) -> str:
        return gethash(self.network)

    def modules(self):
        return {'nn': self.network, 'criterion': self.criterion,
                'optimizer': self.optimizer}

    def place(self, sample_tokens, mesh, policy) -> None:
        """The train state on the mesh through ``policy``: the network's
        own parameters (moved to the mesh's device in place) and zeroed
        optimizer slots. A one-device mesh has nothing for the network to
        bind (the reference binds it into mesh-aware kernels);
        ``sample_tokens`` is the reference's shape sample."""
        self.mesh = mesh
        self.network.to(mesh.device)
        state = init_state(self.network, self.optimizer)
        self.state = policy.place(state, mesh)

    def shard_batch(self, tokens):
        return batch_sharding(self.mesh)(tokens)

    def shard_batches(self, tokens_stack):
        """Place a [steps, batch, ...] stack on the mesh's device."""
        return stacked_batch_sharding(self.mesh)(tokens_stack)

    def fit(self, tokens):
        self.state, (_, loss) = self._train_step(self.state, tokens, tokens)
        return loss

    def fit_many(self, tokens_stack):
        """Run ``tokens_stack.shape[0]`` train steps in one dispatch;
        returns the per-step loss vector (exact per-phase metrics)."""
        self.state, losses = self._train_many(self.state, tokens_stack,
                                              tokens_stack)
        return losses

    def evaluate_many(self, tokens_stack):
        return self._eval_many(self.state, tokens_stack, tokens_stack)

    def evaluate(self, tokens):
        _, loss = self._eval_step(self.state, tokens, tokens)
        return loss

    def onepoch(self) -> None:
        self.events.commit()


# --------------------------------------------------------------------------
# metrics

class LMMetrics:
    """Loss + perplexity, accumulated on the device, one read per phase."""

    def __init__(self):
        self.loss = Mean()
        self.perplexity = Perplexity()

    def update(self, loss) -> None:
        self.loss.update(loss)
        self.perplexity.update(loss)

    def compute(self) -> dict:
        return {'loss': self.loss.compute(),
                'perplexity': self.perplexity.compute()}

    def reset(self) -> None:
        self.loss.reset()
        self.perplexity.reset()


# --------------------------------------------------------------------------
# compilation pipeline

provider = Provider()
compiler = Compiler[LanguageModel](provider=provider)


def mesh():
    """FSDP over every device of the job (the card: a one-device mesh)."""
    return MeshSpec(fsdp=-1).build()


def policy():
    return FullyShardedDataParallel()


def sample_tokens():
    return torch.zeros((1, 8), dtype=torch.int32)


def accumulate() -> int:
    """Gradient-accumulation microsteps (override at the composition
    root when the target global batch does not fit)."""
    return 1


def steps_per_dispatch() -> int:
    """Train/validate steps per host dispatch (1 = a dispatch per batch;
    override at the composition root). Events/metrics keep phase cadence
    either way."""
    return 1


def models():
    raise NotImplementedError('override the models store dependency')


def repository():
    raise NotImplementedError('override the repository dependency')


def experiment() -> str:
    return 'lm'


@compiler.step
def build(network, criterion, optimizer,
          microsteps: int = Depends(accumulate)) -> LanguageModel:
    return LanguageModel(network, criterion, optimizer, accumulate=microsteps)


@compiler.step
def place_on_mesh(model: LanguageModel, device_mesh=Depends(mesh),
                  sharding=Depends(policy),
                  sample=Depends(sample_tokens)) -> LanguageModel:
    model.place(sample, device_mesh, sharding)
    return model


@compiler.step
def bring_epoch(model: LanguageModel, store=Depends(models),
                name: str = Depends(experiment)) -> LanguageModel:
    from tpusystem_torch.storage import ports
    row = store.read(str(model.id), name)
    if row is None:
        store.create(ports.Model(hash=str(model.id), experiment=name, epoch=0))
        return model
    if row.epoch < model.epoch:
        raise ValueError(f'epoch regression: store at {row.epoch}')
    model.epoch = row.epoch
    return model


@compiler.step
def restore_weights(model: LanguageModel,
                    weights=Depends(repository)) -> LanguageModel:
    if model.epoch > 0:
        weights.restore(model)
    return model


# --------------------------------------------------------------------------
# training service

service = Service(provider=provider)
producer = Producer()


@service.handler
def iterate(model, loaders, metrics) -> None:
    train(model, loaders['train'], metrics)
    metrics.reset()
    validate(model, loaders['evaluation'], metrics)
    metrics.reset()
    try:
        model.epoch += 1
    finally:
        producer.dispatch(Iterated(model, loaders))


@service.handler
def train(model, loader, metrics,
          dispatch: int = Depends(steps_per_dispatch)) -> None:
    model.phase = 'train'
    timer = StepTimer(producer).start()
    for (stack,) in grouped_batches(loader, dispatch):
        metrics.update(model.fit_many(model.shard_batches(stack)))
    results = metrics.compute()
    timer.stop(model, 'train', steps=len(loader))
    producer.dispatch(Trained(model, results))


@service.handler
def validate(model, loader, metrics,
             dispatch: int = Depends(steps_per_dispatch)) -> None:
    model.phase = 'evaluation'
    timer = StepTimer(producer).start()
    for (stack,) in grouped_batches(loader, dispatch):
        metrics.update(model.evaluate_many(model.shard_batches(stack)))
    results = metrics.compute()
    timer.stop(model, 'evaluation', steps=len(loader))
    producer.dispatch(Validated(model, results))


# --------------------------------------------------------------------------
# composition root

def main(epochs: int = 3, full: bool = False, corpus: str | None = None,
         holdout_corpus: str | None = None, microsteps: int = 1,
         dispatch_steps: int = 8, device=None) -> None:
    """Pretrain to ``epochs`` (resuming a stored run) on ``device``: the
    card of ``MeshSpec(fsdp=-1).build()`` when None, else that device."""
    global producer
    logging.basicConfig(level=logging.INFO, format='%(message)s', force=True)
    runtime = Runtime()
    store = DocumentStore(ROOT / 'experiments.json')
    weights = Repository(ROOT / 'weights')

    tracker = tracking.tracking_consumer()
    tracker.dependency_overrides.update({
        tracking.metrics_store: lambda: DocumentMetrics(store),
        tracking.models_store: lambda: DocumentModels(store),
        tracking.modules_store: lambda: DocumentModules(store),
        tracking.iterations_store: lambda: DocumentIterations(store),
        tracking.repository: lambda: weights,
        tracking.experiment: experiment,
    })
    runtime.producer.register(tracker, primary_only=True)
    saver = checkpoint_consumer()
    saver.dependency_overrides[tracking.repository] = lambda: weights
    runtime.producer.register(saver)
    runtime.producer.register(logging_consumer())
    producer = runtime.producer

    provider.override(models, lambda: DocumentModels(store))
    provider.override(repository, lambda: weights)
    provider.override(accumulate, lambda: microsteps)
    provider.override(steps_per_dispatch, lambda: dispatch_steps)
    device_mesh = MeshSpec(fsdp=-1).build(
        None if device is None else [torch.device(device)])
    provider.override(mesh, lambda: device_mesh)
    placed = device_mesh.device

    if full:
        # the headline recipe: flash attention, fused chunked LM loss,
        # padded vocab
        network = GPT2(vocab_size=50304, dropout=0.0, return_features=True,
                       attention='flash', device=placed)
        sequence, batch = 1024, 16
    else:
        network = gpt2_tiny(return_features=True, device=placed)
        sequence, batch = 128, 16
    model = compiler.compile(network, ChunkedNextTokenLoss(chunks=8),
                             AdamW(lr=3e-4, grad_clip=1.0))

    if corpus:
        # MemmapTokens windows are sequence_length + 1 (the loss shifts
        # inputs/targets out of one tensor): size them to the model's cap
        dataset = MemmapTokens(corpus, sequence_length=sequence - 1)
        # evaluate on a separate file, or reuse the training corpus when
        # none is given (then eval loss is training-distribution loss)
        holdout = (MemmapTokens(holdout_corpus, sequence_length=sequence - 1)
                   if holdout_corpus else dataset)
    else:
        dataset = SyntheticTokens(samples=64 * batch, sequence_length=sequence,
                                  vocab_size=min(network.vocab_size, 256))
        holdout = SyntheticTokens(samples=8 * batch, sequence_length=sequence,
                                  vocab_size=min(network.vocab_size, 256),
                                  train=False)  # same bigram table, unseen draws
    loaders = {'train': Loader(dataset, batch_size=batch, shuffle=True, seed=0,
                               device=placed),
               'evaluation': Loader(holdout, batch_size=batch, device=placed)}
    metrics = LMMetrics()

    print(f'pretraining {model.id} from epoch {model.epoch}')
    try:
        for _ in range(model.epoch, epochs):
            wants_stop = False
            try:
                service.handle('iterate', model, loaders, metrics)
            except StopIteration:
                wants_stop = True
            runtime.sync()
            if runtime.should_stop(wants_stop):
                break
    finally:
        with contextlib.ExitStack() as cleanup:
            cleanup.callback(runtime.close)
            cleanup.callback(store.close)
            weights.close()


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('epochs', nargs='?', type=int, default=3)
    parser.add_argument('--full', action='store_true',
                        help='125M preset instead of tiny')
    parser.add_argument('--corpus', help='flat binary token file '
                        '(MemmapTokens layout) instead of synthetic data')
    parser.add_argument('--holdout', help='separate corpus file for eval')

    def positive(value: str) -> int:
        steps = int(value)
        if steps < 1:
            raise argparse.ArgumentTypeError('must be >= 1')
        return steps

    parser.add_argument('--accumulate', type=positive, default=1,
                        help='gradient-accumulation microsteps per batch')
    parser.add_argument('--dispatch', type=positive, default=8,
                        help='train/validate steps per host dispatch')
    parser.add_argument('--device', default=None,
                        help="e.g. 'cpu' (default: the CUDA card)")
    args = parser.parse_args()
    main(args.epochs, full=args.full, corpus=args.corpus,
         holdout_corpus=args.holdout, microsteps=args.accumulate,
         dispatch_steps=args.dispatch, device=args.device)
