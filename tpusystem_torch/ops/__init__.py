"""Operators of the port: attention, the head's precision rule, the
mixture-of-experts FFN (:mod:`tpusystem_torch.ops.moe`), and the
hand-written CUDA kernels under :mod:`tpusystem_torch.ops.cuda`."""
