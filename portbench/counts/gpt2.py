"""Operations and bytes of GPT-2's work, from its shapes alone.

A forward counts 2 operations a weight of every product a token (the
blocks' qkv, out, fc and proj), the tied head on the positions whose next
token is a target, and 4 x head_dim a visible (query, key) pair, head and
layer (the scores and the weighted sum). Training is 3 x the forward:
recomputation is the program's choice and is not counted.
"""

from __future__ import annotations


def sizes(config: dict) -> dict:
    dim = config['n_embd']
    hidden = config.get('n_inner') or 4 * dim
    return dict(dim=dim, hidden=hidden, layers=config['n_layer'],
                heads=config['n_head'], head_dim=dim // config['n_head'],
                vocab=config['vocab_size'])


def block_weights(config: dict) -> int:
    """Weights of the products in all blocks."""
    s = sizes(config)
    return s['layers'] * (s['dim'] * 3 * s['dim'] + s['dim'] * s['dim']
                          + 2 * s['dim'] * s['hidden'])


def causal_pairs(batch: int, length: int) -> int:
    """Visible (query, key) pairs of a causal row of ``length``."""
    return batch * length * (length + 1) // 2


def train_step_flops(config: dict, batch: int, length: int) -> float:
    s = sizes(config)
    forward = (2 * block_weights(config) * batch * length
               + 2 * s['dim'] * s['vocab'] * batch * (length - 1)
               + 4 * s['head_dim'] * causal_pairs(batch, length)
               * s['heads'] * s['layers'])
    return 3.0 * forward


def train_attention(config: dict, batch: int, length: int,
                    element_bytes: int = 2) -> tuple:
    """``(flops, bytes)`` of a training step's attention, forward and
    backward, over all layers: 4 x head_dim operations a visible pair
    forward and 10 x head_dim backward (the scores again, the gradients of
    the probabilities, values, queries and keys); bytes are q, k, v, the
    output and its gradient, and q, k and v's gradients, each once, in the
    compute type, with a float32 log-sum-exp a query row."""
    s = sizes(config)
    pairs = causal_pairs(batch, length) * s['heads'] * s['layers']
    flops = 14.0 * s['head_dim'] * pairs
    tensor = batch * length * s['dim'] * element_bytes
    lse = batch * length * s['heads'] * 4
    moved = s['layers'] * (4 * tensor + lse          # forward: q k v, out
                           + 5 * tensor + lse        # backward reads
                           + 3 * tensor)             # dq dk dv
    return flops, float(moved)
