"""PyTorch + CUDA port of the Praos header-replay hot path.

The JAX package (`ouroboros_consensus_tpu`) stays the reference; this
package is an independent twin that imports torch, numpy and the standard
library only. Its device entry points run on a CUDA card unless the caller
asks for the CPU explicitly (`device="cpu"`), where every kernel wrapper
takes the plain PyTorch version of its kernel.

Slice 1 covers the per-lane Praos replay: ImmutableDB -> header views ->
packed staging -> the five stage kernels (ed, kes, vrf-bc prep, vrf
ladders, finish) -> the sequential epilogue (`tools.db_analyser.revalidate`).
"""
