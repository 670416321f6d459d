"""A pool of click-log samples for recommender training, from the seed:
a copy, rewritten to draw on the device, of ``SyntheticClicks`` in the
program's data module.

The mix gives ``samples`` (the pool's size) and ``alpha``: every sample
holds the configuration's dense features (standard normal) and one id a
table, truncated Zipf over the table's rows. Labels come from a planted
logistic model: a normal weight an id (over the square root of the table
count) and a dense weight a feature (over the square root of the dense
width), so the clicks are learnable.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.generators import zipf


class Clicks:
    """Samples as the program's loader takes them: ``dataset[index]`` is
    ``({'dense': [n, dense], 'ids': [n, tables, 1]}, labels [n])``."""

    def __init__(self, dense: np.ndarray, ids: np.ndarray,
                 labels: np.ndarray) -> None:
        self.dense, self.ids, self.labels = dense, ids, labels

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, index) -> tuple:
        return ({'dense': self.dense[index], 'ids': self.ids[index]},
                self.labels[index])


def pool(mix: dict, config: dict, seed: int, device) -> Clicks:
    generator = torch.Generator(device).manual_seed(seed)
    count = mix['samples']
    vocabs = config['num_embeddings_per_feature']
    width = config['dense_in_features']
    dense = torch.randn((count, width), generator=generator, device=device)
    dense_weights = torch.randn(width, generator=generator,
                                device=device) / width ** 0.5
    logits = dense @ dense_weights
    ids = torch.empty((count, len(vocabs)), dtype=torch.int32, device=device)
    for table, rows in enumerate(vocabs):
        drawn = zipf.draw(rows, mix['alpha'], (count,), generator)
        weights = torch.randn(rows, generator=generator,
                              device=device) / len(vocabs) ** 0.5
        logits += weights[drawn]
        ids[:, table] = drawn.to(torch.int32)
        del weights
    labels = (torch.rand(count, generator=generator, device=device)
              < torch.sigmoid(logits)).float()
    return Clicks(dense.cpu().numpy(), ids[:, :, None].cpu().numpy(),
                  labels.cpu().numpy())
