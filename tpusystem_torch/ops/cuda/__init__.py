"""Hand-written CUDA kernels for Hopper (sm_90a), one module per TPU kernel
family: ``decode_matmul`` (decode_matmul, decode_ffn) and ``flash`` (flash
attention forward). Sources live in ``csrc/`` and build on first use
(:mod:`tpusystem_torch.ops.cuda._build`)."""
