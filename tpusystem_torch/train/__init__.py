from tpusystem_torch.train.generate import generate, speculative_generate
from tpusystem_torch.train.losses import (BCEWithLogitsLoss,
                                          ChunkedNextTokenLoss,
                                          CrossEntropyLoss, MSELoss,
                                          NextTokenLoss, WithAuxLoss)
from tpusystem_torch.train.metrics import (Accuracy, Mean, Perplexity,
                                           TopKAccuracy)
from tpusystem_torch.train.optim import (SGD, Adam, AdamW, Optimizer,
                                         masked_update)
from tpusystem_torch.train.sentinel import Guard, Sentinel
from tpusystem_torch.train.state import HealthStats, TrainState, resume_extras
from tpusystem_torch.train.step import (build_1f1b_train_step, build_eval_step,
                                        build_multi_eval_step,
                                        build_multi_step, build_train_step,
                                        grouped_batches, init_state,
                                        module_apply)

__all__ = ['generate', 'speculative_generate', 'TrainState', 'HealthStats',
           'resume_extras', 'build_train_step', 'build_eval_step',
           'build_multi_step', 'build_multi_eval_step', 'grouped_batches',
           'build_1f1b_train_step', 'init_state', 'module_apply',
           'Optimizer', 'SGD', 'Adam', 'AdamW', 'masked_update', 'Guard',
           'Sentinel', 'CrossEntropyLoss', 'MSELoss', 'BCEWithLogitsLoss',
           'NextTokenLoss', 'ChunkedNextTokenLoss', 'WithAuxLoss', 'Mean',
           'Accuracy', 'TopKAccuracy', 'Perplexity']
