"""Post-hoc experiment analysis (the twin of ``examples/tinysys/analysis.py``):
the document store that ``main.py`` writes, queried for every model's
curves.

Run after ``python main.py``:

    python analysis.py            # text report of every model's curves
    python analysis.py --plot     # also writes data/metrics.png (matplotlib)
"""

from __future__ import annotations

import pathlib
import sys
from collections import defaultdict

from tpusystem_torch.storage import (DocumentMetrics, DocumentModels,
                                     DocumentModules, DocumentStore)

ROOT = pathlib.Path(__file__).parent / 'data'


def curves(metrics_rows):
    """{(metric, phase): [(epoch, value), ...]} sorted by epoch."""
    series = defaultdict(list)
    for row in metrics_rows:
        series[(row.name, row.phase)].append((row.epoch, row.value))
    return {key: sorted(points) for key, points in series.items()}


def report(store: DocumentStore) -> list:
    models = DocumentModels(store).list('default')
    if not models:
        print('no experiments recorded — run main.py first')
        return []
    for model in models:
        print(f'model {model.hash}  (epoch {model.epoch})')
        for row in DocumentModules(store).list(model.hash):
            print(f'  {row.kind:10} {row.name} {row.arguments}')
        for (name, phase), points in sorted(curves(
                DocumentMetrics(store).list(model.hash)).items()):
            values = ' '.join(f'{value:.4f}' for _, value in points)
            print(f'  {name}/{phase:11} {values}')
    return models


def plot(store: DocumentStore, models, path: pathlib.Path) -> None:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    series = curves(DocumentMetrics(store).list(models[0].hash))
    names = sorted({name for name, _ in series})
    figure, axes = plt.subplots(1, len(names), figsize=(6 * len(names), 4))
    for axis, name in zip([axes] if len(names) == 1 else axes, names):
        for (metric, phase), points in sorted(series.items()):
            if metric == name:
                axis.plot(*zip(*points), marker='o', label=phase)
        axis.set_title(name)
        axis.set_xlabel('epoch')
        axis.legend()
    figure.tight_layout()
    figure.savefig(path)
    print(f'wrote {path}')


def main() -> None:
    store = DocumentStore(ROOT / 'experiments.json')
    try:
        models = report(store)
        if models and '--plot' in sys.argv:
            plot(store, models, ROOT / 'metrics.png')
    finally:
        store.close()


if __name__ == '__main__':
    main()
