from tpusystem_torch.depends import Depends
from tpusystem_torch.services.service import Service
from tpusystem_torch.services.prodcon import Consumer, Producer, event
from tpusystem_torch.services.pubsub import Publisher, Subscriber

__all__ = ['Service', 'Consumer', 'Producer', 'event', 'Publisher',
           'Subscriber', 'Depends']
