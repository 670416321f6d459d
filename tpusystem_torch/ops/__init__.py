"""Operators of the port: attention, the head's precision rule, and the
hand-written CUDA kernels under :mod:`tpusystem_torch.ops.cuda`."""
