"""Loss criteria as registered entities: the port of
:mod:`tpusystem.train.losses`.

Each criterion is a hashable hyperparameter recipe (its registry digest
equals the reference's) whose ``__call__`` takes tensors and returns a
scalar tensor that autograd differentiates. The formulas are optax's,
written out: cross-entropy is ``logsumexp(logits) - logits[label]``, the
binary one uses ``log_sigmoid`` of both signs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpusystem_torch.ops.precision import head_logits
from tpusystem_torch.registry import register


def _integer_cross_entropy(logits, targets):
    """Per-row ``logsumexp(logits) - logits[target]`` (optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    true = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, -1) - true


@register
class CrossEntropyLoss:
    """Softmax cross-entropy over integer labels, with optional smoothing."""

    def __init__(self, label_smoothing: float = 0.0):
        self.label_smoothing = label_smoothing

    def __call__(self, logits, targets):
        if self.label_smoothing:
            classes = logits.shape[-1]
            onehot = F.one_hot(targets.long(), classes).to(logits.dtype)
            smoothed = (onehot * (1.0 - self.label_smoothing)
                        + self.label_smoothing / classes)
            losses = -(smoothed * torch.log_softmax(logits, -1)).sum(-1)
        else:
            losses = _integer_cross_entropy(logits, targets)
        return losses.mean()


@register
class MSELoss:
    def __init__(self):
        ...

    def __call__(self, predictions, targets):
        return ((predictions - targets) ** 2).mean()


@register
class BCEWithLogitsLoss:
    """Binary cross-entropy on raw logits, per-example mean; targets are
    0/1 floats (or bools)."""

    def __init__(self):
        ...

    def __call__(self, logits, targets):
        logits = logits.float()
        labels = torch.as_tensor(targets, device=logits.device).float()
        losses = (-labels * F.logsigmoid(logits)
                  - (1.0 - labels) * F.logsigmoid(-logits))
        return losses.mean()


@register
class WithAuxLoss:
    """Wrap a criterion for models whose outputs are ``(predictions, aux)``,
    such as MoE models returning their router losses
    (:mod:`tpusystem_torch.ops.moe`). The aux term, already scaled by the
    model's coefficients, adds to the base loss; ``coef`` rescales it. The
    inner criterion's ``weight`` (its unmasked-token count) is forwarded,
    so accumulation weighs microbatches by tokens."""

    def __init__(self, criterion, coef: float = 1.0):
        self.criterion = criterion
        self.coef = coef
        if hasattr(criterion, 'weight'):  # forward the accumulation weight
            self.weight = criterion.weight

    def __call__(self, outputs, targets):
        predictions, aux = outputs
        return self.criterion(predictions, targets) + self.coef * aux


def _token_weight(tokens):
    return (tokens[:, 1:] >= 0).float().sum()


@register
class ChunkedNextTokenLoss:
    """Causal LM loss fused with the LM head, chunked over rows.

    Consumes ``(features, table)`` from a model built with
    ``return_features=True`` instead of logits. Rows are processed in
    ``chunks`` slices; each computes its ``[rows, vocab]`` float32 logits
    tile (:func:`~tpusystem_torch.ops.precision.head_logits`), reduces it to
    its loss terms and is recomputed in the backward pass
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``), so
    the ``[batch * seq, vocab]`` logits never form.

    Same semantics as :class:`NextTokenLoss`: logits[:, :-1] vs
    tokens[:, 1:], ids below 0 masked out, optional z-loss. Rows are padded
    with masked rows up to a multiple of ``chunks``. ``table`` may be
    ``[vocab, dim]`` (tied) or ``[dim, vocab]``; ``tied=None`` infers it
    and refuses a square table."""

    def __init__(self, chunks: int = 16, z_loss: float = 0.0,
                 tied: bool | None = None):
        self.chunks = chunks
        self.z_loss = z_loss
        self.tied = tied

    def _chunk(self, rows, labels, table):
        logits = head_logits(rows, table, tied=self.tied)
        logsumexp = torch.logsumexp(logits, -1)
        mask = (labels >= 0).float()
        true = logits.gather(1, labels.clamp(min=0)[:, None])[:, 0]
        return (((logsumexp - true) * mask).sum(),
                (logsumexp.square() * mask).sum(), mask.sum())

    def __call__(self, outputs, tokens):
        features, table = outputs
        dim = features.shape[-1]
        rows = features[:, :-1].reshape(-1, dim)
        labels = tokens[:, 1:].reshape(-1).long()
        padding = -rows.shape[0] % self.chunks
        if padding:
            rows = F.pad(rows, (0, 0, 0, padding))
            labels = F.pad(labels, (0, padding), value=-1)
        rows = rows.reshape(self.chunks, -1, dim)
        labels = labels.reshape(self.chunks, -1)
        terms = [checkpoint(self._chunk, rows[index], labels[index], table,
                            use_reentrant=False)
                 for index in range(self.chunks)]
        losses, z_terms, counts = (torch.stack(column) for column in
                                   zip(*terms))
        total = torch.clamp(counts.sum(), min=1.0)
        loss = losses.sum() / total
        if self.z_loss:
            loss = loss + self.z_loss * z_terms.sum() / total
        return loss

    def weight(self, tokens):
        """Unmasked-token count: the accumulation weight that makes
        microbatched means equal the full-batch mean under padding (see
        ``build_train_step(accumulate=...)``)."""
        return _token_weight(tokens)


@register
class NextTokenLoss:
    """Causal LM loss: cross-entropy of logits[:, :-1] vs tokens[:, 1:],
    with padding mask support (pad id < 0 excluded)."""

    def __init__(self, z_loss: float = 0.0):
        self.z_loss = z_loss

    def __call__(self, logits, tokens):
        shifted = logits[:, :-1].float()
        targets = tokens[:, 1:]
        mask = (targets >= 0).float()
        losses = _integer_cross_entropy(shifted, targets.clamp(min=0))
        total = torch.clamp(mask.sum(), min=1.0)
        loss = (losses * mask).sum() / total
        if self.z_loss:
            logsumexp = torch.logsumexp(shifted, -1)
            loss = loss + self.z_loss * (logsumexp ** 2 * mask).sum() / total
        return loss

    def weight(self, tokens):
        """Unmasked-token count (see :meth:`ChunkedNextTokenLoss.weight`)."""
        return _token_weight(tokens)
