"""The port's lane-wise SHA-512 and Blake2b (ouroboros_consensus_tpu_torch
ops/pk/hashes.py) against hashlib and the JAX package's pk hashes."""

import hashlib

import numpy as np
import pytest
import torch
from jax import numpy as jnp

from ouroboros_consensus_tpu.ops.pk import hashes as jhashes
from ouroboros_consensus_tpu_torch.ops.pk import hashes as ph

torch.set_num_threads(1)


def _cols(msgs):
    return torch.tensor([list(m) for m in msgs]).T


@pytest.mark.parametrize("n", [0, 1, 66, 111, 112, 130, 239])
def test_sha512_fixed_lengths(n):
    rng = np.random.default_rng(n)
    msgs = [rng.bytes(n) for _ in range(3)]
    data = _cols(msgs) if n else torch.zeros(0, 3, dtype=torch.int64)
    out = ph.sha512_fixed(data)
    for i, m in enumerate(msgs):
        assert bytes(out[:, i].tolist()) == hashlib.sha512(m).digest()


def test_sha512_per_lane_block_counts():
    """Lanes of one block tensor with different message lengths: each
    lane's digest covers exactly its own block count."""
    rng = np.random.default_rng(5)
    lens = [3, 120, 200, 300, 17]
    msgs = [rng.bytes(n) for n in lens]
    nb_max = max((n + 17 + 127) // 128 for n in lens)
    blocks = torch.zeros(nb_max, 128, len(lens), dtype=torch.int64)
    counts = []
    for i, m in enumerate(msgs):
        b, nb = ph.pad_sha512(_cols([m]))
        blocks[:nb, :, i] = b[:, :, 0]
        counts.append(nb)
    out = ph.sha512_blocks(blocks, torch.tensor(counts))
    for i, m in enumerate(msgs):
        assert bytes(out[:, i].tolist()) == hashlib.sha512(m).digest()
    assert len(set(counts)) > 1


@pytest.mark.parametrize("n", [1, 32, 40, 64, 65, 127, 128])
def test_blake2b_single_block(n):
    rng = np.random.default_rng(100 + n)
    msgs = [rng.bytes(n) for _ in range(3)]
    out = ph.blake2b_fixed(_cols(msgs), 32)
    for i, m in enumerate(msgs):
        assert bytes(out[:, i].tolist()) == hashlib.blake2b(m, digest_size=32).digest()


def test_matches_jax_pk_hashes():
    rng = np.random.default_rng(9)
    msgs = [rng.bytes(130) for _ in range(2)]
    data = _cols(msgs)
    want = np.asarray(jhashes.sha512_fixed(jnp.asarray(data.numpy(), jnp.int32)))
    assert (ph.sha512_fixed(data).numpy() == want).all()
    want = np.asarray(jhashes.blake2b_fixed(jnp.asarray(data[:65].numpy(), jnp.int32), 65, 32))
    assert (ph.blake2b_fixed(data[:65], 32).numpy() == want).all()
