"""PyTorch + CUDA port of the Praos header-replay hot path.

The JAX package (`ouroboros_consensus_tpu`) stays the reference; this
package is an independent twin that imports torch, numpy and the standard
library only. Its device entry points run on a CUDA card unless the caller
asks for the CPU explicitly (`device="cpu"`), where every kernel wrapper
takes the plain PyTorch version of its kernel.

The replay: ImmutableDB -> a native chunk scan (CRC, header columns,
body hashes) -> ViewColumns windows -> columnar prechecks and packed
staging -> the `unpack` kernel, the five stage kernels (ed, kes, the VRF
prep of the proof format, vrf ladders, finish) and the `nonce_fold`
kernel beside them -> the columnar epilogue
(`tools.db_analyser.revalidate`; `tools.bench` times it end to end).

The stores a node opens at every restart: `storage.open.open_chaindb` ->
the ImmutableDB, the VolatileDB and the LedgerDB (a snapshot and its
replay) -> chain selection (`storage/chaindb.py`), whose runs of fresh
blocks go through `PraosProtocol.validate_batch(collect_states=True)`:
one packed window an epoch segment through the same kernels.
"""
