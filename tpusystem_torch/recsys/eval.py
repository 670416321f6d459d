"""Streaming recommender evaluation: the port of :mod:`tpusystem.recsys.eval`.

Recommender metrics are rank statistics: AUC needs every (positive,
negative) score pair, recall@k a per-query ranking. These evaluators keep
the repository's cadence anyway: ``update`` bins or counts a batch on its
own device without waiting for it, ``compute`` reads the result back once
per phase.

* :class:`StreamingAUC` — histogram-bucketed AUC over sigmoid scores. The
  buckets hold counts of 0/1 labels, exact in float32 in any order of adds.
* :class:`RecallAtK` — fraction of queries whose relevant item ranks in the
  top k of its score row (top-k accuracy over the two-tower ``[B, B]``
  in-batch scores).
* :class:`RecsysEvaluator` — drives a held-out loader (any iterable of
  ``(features, labels)``, the port's :class:`~tpusystem_torch.data.Loader`
  included) through the port's ``build_eval_step`` and both accumulators.
  Wire it to the bus with :func:`evaluation_consumer`: the consumer reacts
  to each :class:`~tpusystem_torch.observe.events.Trained` (phase cadence)
  and dispatches :class:`~tpusystem_torch.observe.events.RecsysEvaluated`
  with the materialized metric floats.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from tpusystem_torch.observe.events import RecsysEvaluated, Trained
from tpusystem_torch.services.prodcon import Consumer
from tpusystem_torch.train.metrics import Mean, TopKAccuracy


class StreamingAUC:
    """Streaming ROC-AUC from histogrammed sigmoid scores.

    ``update(logits, targets)`` bins one batch on its device (targets are
    0/1); ``compute`` reads the two ``[buckets]`` histograms once and
    returns the rank-sum AUC (0.5 when a class is absent)."""

    def __init__(self, buckets: int = 512):
        self.buckets = buckets
        self.reset()

    def reset(self) -> None:
        self._pos = torch.zeros((self.buckets,), dtype=torch.float32)
        self._neg = torch.zeros((self.buckets,), dtype=torch.float32)

    def update(self, logits, targets) -> None:
        scores = torch.sigmoid(logits.reshape(-1).float())
        index = torch.clamp((scores * self.buckets).to(torch.int32), 0,
                            self.buckets - 1)
        labels = targets.reshape(-1).float().to(scores.device)
        device = scores.device
        self._pos = self._pos.to(device).index_add(0, index, labels)
        self._neg = self._neg.to(device).index_add(0, index, 1.0 - labels)

    def compute(self) -> float:
        pos, neg = self._pos.cpu().numpy(), self._neg.cpu().numpy()
        positives, negatives = pos.sum(), neg.sum()
        if positives == 0 or negatives == 0:
            return 0.5
        below = np.cumsum(neg) - neg         # negatives strictly below
        wins = np.sum(pos * (below + 0.5 * neg))
        return float(wins / (positives * negatives))


class RecallAtK(TopKAccuracy):
    """Recall@k over score rows with one relevant item per query
    (``update(scores [B, C], relevant [B])``) — the retrieval reading of
    top-k accuracy, named for the recsys convention."""


class RecsysEvaluator:
    """Held-out streaming eval: AUC (and loss) for click models, recall@k
    for retrieval models.

    ``run(state)`` iterates the loader once, feeds every batch through the
    eval step (no gradients) and updates the accumulators on the device;
    the metrics are read back once at the end. Which metrics apply follows
    the model's output rank: ``[B]`` click logits feed AUC, a ``[B, B]``
    in-batch score matrix feeds recall@k against the diagonal.
    """

    def __init__(self, module, loader, criterion=None, k: int = 10,
                 buckets: int = 512):
        from tpusystem_torch.train import (BCEWithLogitsLoss, build_eval_step,
                                           module_apply)
        self.loader = loader
        self.k = k
        # the default BCE criterion only means anything for [B] click
        # logits: for a retrieval model pass the training criterion
        # explicitly, or no loss is reported
        self._explicit_criterion = criterion is not None
        self._step = build_eval_step(module_apply(module),
                                     criterion or BCEWithLogitsLoss())
        self.auc = StreamingAUC(buckets)
        self.recall = RecallAtK(k)
        self.loss = Mean()

    def run(self, state) -> dict[str, float]:
        self.auc.reset()
        self.recall.reset()
        self.loss.reset()
        ranked = False
        for features, labels in self.loader:
            outputs, loss = self._step(state, features, labels)
            self.loss.update(loss)
            if outputs.dim() == 2:            # [B, B] in-batch score matrix
                ranked = True
                self.recall.update(outputs, torch.arange(
                    outputs.shape[0], dtype=torch.int32,
                    device=outputs.device))
            else:
                self.auc.update(outputs, labels)
        if ranked:
            metrics = ({'loss': self.loss.compute()}
                       if self._explicit_criterion else {})
            metrics[f'recall@{self.k}'] = self.recall.compute()
        else:
            metrics = {'loss': self.loss.compute(),
                       'auc': self.auc.compute()}
        return metrics


def evaluation_consumer(evaluator: RecsysEvaluator,
                        state_of: Callable[[Any], Any] | None = None,
                        producer=None, subject: Any = None):
    """Consumer running the streaming eval at phase cadence.

    Reacts to :class:`~tpusystem_torch.observe.events.Trained` (the training
    service dispatches one per train phase), pulls the current
    ``TrainState`` off the aggregate (``state_of(model)``, default
    ``model.state``), runs the evaluator (its updates stay on the device,
    its ``compute`` is the phase's one read back), and — when ``producer``
    is given — dispatches
    :class:`~tpusystem_torch.observe.events.RecsysEvaluated` so downstream
    consumers (ledger, tensorboard) chart the metrics.

    ``subject`` scopes the handler on a shared bus: pass the aggregate
    instance (or its ``id``) this evaluator's module belongs to, and
    ``Trained`` events from *other* models are ignored — the evaluator's
    eval step is bound to one module, so another model's state would be
    a parameter mismatch. ``None`` (single-model buses) reacts to every
    ``Trained``."""
    state_of = state_of or (lambda model: model.state)
    consumer = Consumer('recsys-eval')

    @consumer.handler
    def on_trained(event: Trained) -> None:
        if subject is not None and event.model is not subject \
                and getattr(event.model, 'id', None) != subject:
            return
        metrics = evaluator.run(state_of(event.model))
        if producer is not None:
            producer.dispatch(RecsysEvaluated(event.model, metrics))

    return consumer
