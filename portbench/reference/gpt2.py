"""GPT-2 in plain float32 PyTorch: the yardstick of the GPT-2 cells.

It follows the published model (learned positions, pre-norm blocks, fused
qkv, tanh GELU, a tied head) and the configuration file's settings, with no
kernel, cache or batching of the program. Parameters are a dict of float32
tensors named as the flax layout names them (``h_0.attn.qkv.kernel`` is an
``[in, out]`` kernel), the names the program's modules use too, so one
set of drawn weights is handed to both.

Departure from the published model, stated in the configuration file:
layer norm's epsilon is ``layer_norm_epsilon`` as given there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import operand


def recipes(config: dict) -> list:
    """``(name, shape, kind, scale)`` of every leaf, GPT-2's initializer:
    normal ``initializer_range`` kernels and embeddings, the residual
    projections scaled by ``1 / sqrt(2 n_layer)``, zero biases, unit
    norm scales."""
    dim, layers = config['n_embd'], config['n_layer']
    hidden = config.get('n_inner') or 4 * dim
    std = config['initializer_range']
    residual = std / math.sqrt(2 * layers)
    leaves = [('wte.embedding', (config['vocab_size'], dim), 'normal', std),
              ('wpe.embedding', (config['n_positions'], dim), 'normal', std)]
    for layer in range(layers):
        prefix = f'h_{layer}.'
        leaves += [
            (prefix + 'ln_1.scale', (dim,), 'constant', 1.0),
            (prefix + 'ln_1.bias', (dim,), 'constant', 0.0),
            (prefix + 'attn.qkv.kernel', (dim, 3 * dim), 'normal', std),
            (prefix + 'attn.qkv.bias', (3 * dim,), 'constant', 0.0),
            (prefix + 'attn.out.kernel', (dim, dim), 'normal', residual),
            (prefix + 'attn.out.bias', (dim,), 'constant', 0.0),
            (prefix + 'ln_2.scale', (dim,), 'constant', 1.0),
            (prefix + 'ln_2.bias', (dim,), 'constant', 0.0),
            (prefix + 'fc.kernel', (dim, hidden), 'normal', std),
            (prefix + 'fc.bias', (hidden,), 'constant', 0.0),
            (prefix + 'proj.kernel', (hidden, dim), 'normal', residual),
            (prefix + 'proj.bias', (dim,), 'constant', 0.0)]
    leaves += [('ln_f.scale', (dim,), 'constant', 1.0),
               ('ln_f.bias', (dim,), 'constant', 0.0)]
    return leaves


def _norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def features(weights: dict, tokens, config: dict, precision='float32'):
    """The final norm's output ``[batch, length, dim]`` for ``tokens``."""
    cast = operand(precision)
    dim, heads = config['n_embd'], config['n_head']
    eps = config['layer_norm_epsilon']
    batch, length = tokens.shape
    head_dim = dim // heads
    positions = torch.arange(length, device=tokens.device)
    hidden = weights['wte.embedding'][tokens] + weights['wpe.embedding'][
        positions][None]
    causal = torch.ones(length, length, dtype=torch.bool,
                        device=tokens.device).tril()

    def dense(x, name):
        return cast(x) @ cast(weights[name + '.kernel']) + weights[
            name + '.bias']

    for layer in range(config['n_layer']):
        prefix = f'h_{layer}.'
        normed = _norm(hidden, weights[prefix + 'ln_1.scale'],
                       weights[prefix + 'ln_1.bias'], eps)
        qkv = dense(normed, prefix + 'attn.qkv')
        query, key, value = (t.reshape(batch, length, heads, head_dim)
                             .transpose(1, 2) for t in qkv.split(dim, -1))
        scores = cast(query) @ cast(key).transpose(-1, -2) / math.sqrt(
            head_dim)
        scores = scores.masked_fill(~causal, float('-inf'))
        context = cast(torch.softmax(scores, -1)) @ cast(value)
        context = context.transpose(1, 2).reshape(batch, length, dim)
        hidden = hidden + dense(context, prefix + 'attn.out')
        normed = _norm(hidden, weights[prefix + 'ln_2.scale'],
                       weights[prefix + 'ln_2.bias'], eps)
        grown = F.gelu(dense(normed, prefix + 'fc'), approximate='tanh')
        hidden = hidden + dense(grown, prefix + 'proj')
    return _norm(hidden, weights['ln_f.scale'], weights['ln_f.bias'], eps)


def logits(weights: dict, tokens, config: dict, precision='float32'):
    """``[batch, length, vocab]`` float32 logits through the tied head."""
    cast = operand(precision)
    return cast(features(weights, tokens, config, precision)) @ cast(
        weights['wte.embedding']).T


def loss_and_grads(weights: dict, tokens, config: dict, rows: int,
                   precision='float32', keep=None):
    """The mean next-token cross-entropy over ``tokens[:, 1:]`` and its
    gradient by leaf, taken ``rows`` rows at a time (the sums of the blocks
    are the whole batch's). ``keep`` (a row count) is the fault of half a
    batch: the mean over the first ``keep`` rows only."""
    tokens = tokens if keep is None else tokens[:keep]
    leaves = {name: leaf.detach().requires_grad_(True)
              for name, leaf in weights.items()}
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    total = 0.0
    for block in tokens.split(rows):
        out = logits(leaves, block, config, precision)[:, :-1]
        loss = F.cross_entropy(out.reshape(-1, out.shape[-1]),
                               block[:, 1:].reshape(-1), reduction='sum')
        (loss / count).backward()
        total += loss.item()
        del out, loss
    return total / count, {name: leaf.grad for name, leaf in leaves.items()}
