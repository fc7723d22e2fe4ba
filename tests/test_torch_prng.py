"""Threefry of the PyTorch port (``lightgbm_tpu_torch/prng.py``) against
``jax.random`` on the CPU: keys, fold_in, raw bits and uniform floats equal
bit for bit, over seeds, data and shapes, including draws that start at a
flat offset of a larger draw (the quantization dither's guard offset)."""
import numpy as np
import pytest
import torch

import jax

from lightgbm_tpu_torch import prng

SEEDS = [0, 1, 3, 42, 987123, 2 ** 31 - 1, -5]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def test_partitionable_threefry_is_the_reference():
    """The port draws JAX's partitionable counter scheme; a JAX that
    changes the default must fail here, not in a parity test."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    key = prng.PRNGKey(seed)
    assert key == tuple(np.asarray(_jkey(seed)).tolist())
    for data in (0, 1, 555, 7000 + 9, 9000, 987123, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(_jkey(seed), data)).tolist()
        assert prng.fold_in(key, data) == tuple(want), data
    # a chain, as the samplers and the per-tree keys build them
    j, p = _jkey(seed), key
    for data in (131, 7, 987123):
        j, p = jax.random.fold_in(j, data), prng.fold_in(p, data)
    assert p == tuple(np.asarray(j).tolist())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (1000,), (33, 2), (4, 5, 3)])
def test_bits_and_uniform(seed, shape):
    jk = jax.random.fold_in(_jkey(seed), 9000)
    pk = prng.fold_in(prng.PRNGKey(seed), 9000)
    bits = prng.random_bits(pk, shape)
    assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
    want = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    assert np.array_equal(bits.numpy(), want)
    u = prng.uniform(pk, shape)
    ju = np.asarray(jax.random.uniform(jk, shape))
    assert u.dtype == torch.float32
    assert np.array_equal(u.numpy().view(np.uint32), ju.view(np.uint32))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


@pytest.mark.parametrize("start,n", [(0, 10), (4096 * 2, 600), (12345, 1)])
def test_draw_from_an_offset(start, n):
    """Elements [start, start + n) of a flat draw, without the rest."""
    jk = jax.random.fold_in(_jkey(11), 987123)
    full = np.asarray(jax.random.uniform(jk, ((start + n) // 2 + 1, 2)))
    full = full.reshape(-1)[start:start + n]
    part = prng.uniform(prng.fold_in(prng.PRNGKey(11), 987123), (n,),
                        start=start)
    assert np.array_equal(part.numpy().view(np.uint32), full.view(np.uint32))
