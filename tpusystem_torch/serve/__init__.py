"""Serving tier of the port: the paged continuous-batching
:class:`Engine` over the host-side :class:`PagedKVCache`."""

from tpusystem_torch.serve.engine import (Admission, Engine, SamplingParams,
                                          Saturated, StepReport,
                                          engine_unsupported_reason,
                                          prefill_bucket)
from tpusystem_torch.serve.kvcache import (TRASH_BLOCK, PagedKVCache,
                                           adopt_prefill, write_tables)

__all__ = ['Admission', 'Engine', 'PagedKVCache', 'SamplingParams',
           'Saturated', 'StepReport', 'TRASH_BLOCK', 'adopt_prefill',
           'engine_unsupported_reason', 'prefill_bucket', 'write_tables']
