"""Recommender tier of the port: embedding tables and the rank-statistic
evaluation. The models live with the rest (:class:`tpusystem_torch.models.
DLRM`, :class:`~tpusystem_torch.models.TwoTower`)."""

from tpusystem_torch.recsys.embedding import (ShardedEmbedding, dedup_ids,
                                              lookup, route_plan)
from tpusystem_torch.recsys.eval import (RecallAtK, RecsysEvaluator,
                                         StreamingAUC, evaluation_consumer)

__all__ = ['ShardedEmbedding', 'dedup_ids', 'lookup', 'route_plan',
           'StreamingAUC', 'RecallAtK', 'RecsysEvaluator',
           'evaluation_consumer']
