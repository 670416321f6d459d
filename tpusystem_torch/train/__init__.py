from tpusystem_torch.train.generate import generate

__all__ = ['generate']
