"""Hand-written CUDA kernels for Hopper (sm_90a), one module per TPU kernel
family: ``decode_matmul`` (decode_matmul, decode_ffn; bf16, int8 and fp8
weights), ``flash`` (flash attention forward, and its fused and split
backward behind a ``torch.autograd.Function``, with the positional dropout
hash in every kernel), ``grouped_matmul`` (the MoE grouped gather-matmul
and matmul-scatter), ``embedding_lookup`` (the recommender's row gather and
ordered row scatter-add, behind a ``torch.autograd.Function``), and
``threefry`` (the dropout keep mask, ``jax.random.bernoulli``'s bits; no
TPU kernel: XLA's in the reference).
Sources live in ``csrc/`` and build on first use
(:mod:`tpusystem_torch.ops.cuda._build`)."""
