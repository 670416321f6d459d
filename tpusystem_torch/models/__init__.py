from tpusystem_torch.models.gpt2 import GPT2, gpt2_small, gpt2_tiny

__all__ = ['GPT2', 'gpt2_small', 'gpt2_tiny']
