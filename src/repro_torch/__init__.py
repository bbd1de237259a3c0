"""PyTorch + CUDA port of the LookaheadKV serving system.

Mirrors ``src/repro/`` module by module (the JAX package stays the
reference and is never imported from here).  Slice 1 serves the paper's
method through the paged continuous-batching engine: chunked prefill,
the lookahead observation pass with scoring and eviction at prompt end,
and paged greedy decode out of a shared block pool.  Its three
attention kernels are hand-written CUDA for Hopper (``csrc/``), each
with a plain PyTorch version that CPU tensors take.
"""
