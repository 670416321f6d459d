"""Operators of the port: attention, the precision rules (the head's, and
the streamed int8/fp8 weights of decoding), the mixture-of-experts FFN
(:mod:`tpusystem_torch.ops.moe`), JAX's threefry keys and draws
(:mod:`tpusystem_torch.ops.threefry`), and the hand-written CUDA kernels
under :mod:`tpusystem_torch.ops.cuda`."""
