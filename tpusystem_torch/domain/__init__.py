from tpusystem_torch.domain.aggregate import Aggregate, Phase
from tpusystem_torch.domain.events import Event, Events

__all__ = ['Aggregate', 'Phase', 'Event', 'Events']
