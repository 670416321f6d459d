from tpusystem_torch.models.dlrm import (DLRM, TwoTower, dlrm_tiny,
                                         two_tower_tiny)
from tpusystem_torch.models.gpt2 import GPT2, gpt2_small, gpt2_tiny
from tpusystem_torch.models.llama import Llama, llama3_8b, llama_tiny

__all__ = ['GPT2', 'gpt2_small', 'gpt2_tiny', 'DLRM', 'TwoTower', 'dlrm_tiny',
           'two_tower_tiny', 'Llama', 'llama3_8b', 'llama_tiny']
