"""A pool of token rows for language-model training, from the seed.

The mix gives ``rows`` (the pool's size), ``length`` (tokens a row; a row
is one training sequence) and ``alpha`` (token ids are truncated Zipf over
the configuration's vocabulary, id 0 the most frequent). The driver's
loader shuffles the pool into batches epoch after epoch.
"""

from __future__ import annotations

import torch

from portbench.generators import zipf


def pool(mix: dict, config: dict, seed: int, device) -> torch.Tensor:
    """``[rows, length]`` int32 token ids on the host."""
    generator = torch.Generator(device).manual_seed(seed)
    ids = zipf.draw(config['vocab_size'], mix['alpha'],
                    (mix['rows'], mix['length']), generator)
    return ids.to(torch.int32).cpu()
