"""Threefry-2x32 counter-based random bits, bit for bit with ``jax.random``
(PyTorch port of the parts of ``jax/_src/prng.py`` and ``jax/_src/random.py``
that the JAX package's samplers, its quantization dither and the
``rank_xendcg`` objective's Gumbel noise use).

A key is a pair of unsigned 32-bit words, held here as a tuple of two
Python ints: deriving keys (:func:`PRNGKey`, :func:`fold_in`) is a handful
of integer operations on the host and never touches a device. Drawing bits
(:func:`random_bits`, :func:`uniform`, :func:`gumbel`) runs as torch
operations on the device asked for, so a draw on the card neither
synchronises it nor copies anything from the host. A draw also takes its
key as a (2,) int64 device tensor of the two words (:func:`key_words`): a
CUDA graph that draws then reads the key from that buffer at every
replay, where two Python ints would be frozen into the graph at capture.

The counter scheme is JAX's *partitionable* one (``jax_threefry_
partitionable``, on by default in JAX 0.9): element ``i`` of the flat
output is ``bits1 ^ bits2`` of threefry over the 64-bit counter ``i`` split
into ``(hi, lo)`` words, so an element's bits depend only on its flat
index. That is what lets :func:`random_bits` start at a flat offset: a
slice of a larger draw costs only the slice.

torch has no full uint32 arithmetic on CUDA, so words are int64 tensors
with values in ``[0, 2^32)`` and every add and shift is masked back to 32
bits; a rotate's left shift by at most 29 stays inside int64.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
Key = Tuple[int, int]
_Word = Union[int, torch.Tensor]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: _Word, r: int) -> _Word:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(key, x0: _Word, x1: _Word) -> Tuple[_Word, _Word]:
    """The Threefry-2x32 hash of the counter pair ``(x0, x1)`` under
    ``key`` (20 rounds; ``jax._src.prng._threefry2x32_lowering``). The
    counters are Python ints or int64 tensors of 32-bit values; the key is
    a :data:`Key` or a (2,) int64 tensor of its words (then the counters
    are tensors on its device)."""
    if isinstance(key, torch.Tensor):
        k0, k1 = key[0:1] & MASK32, key[1:2] & MASK32
    else:
        k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [(x0 + ks[0]) & MASK32, (x1 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits (JAX's
    default int32 seeds): the key ``(0, seed mod 2^32)``."""
    return (0, int(seed) & MASK32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    ``(0, data)``, the seed-key of ``data``."""
    a, b = threefry2x32(key, 0, int(data) & MASK32)
    return (int(a), int(b))


def key_words(key: Key, out: torch.Tensor) -> torch.Tensor:
    """Write ``key``'s two words into the (2,) int64 tensor ``out`` with
    fills (no host-to-device copy, so the host does not wait for the card)
    and return it."""
    out[0:1].fill_(int(key[0]) & MASK32)
    out[1:2].fill_(int(key[1]) & MASK32)
    return out


def random_bits(key, shape: Sequence[int], *,
                device: Optional[torch.device] = None,
                start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of 32-bit
    values. ``start`` draws elements ``[start, start + prod(shape))`` of a
    larger draw's flat index instead of ``[0, prod(shape))``. ``key`` is a
    :data:`Key` or its (2,) int64 device tensor (:func:`key_words`)."""
    numel = 1
    for d in shape:
        numel *= int(d)
    idx = torch.arange(start, start + numel, dtype=torch.int64,
                       device=device)
    hi, lo = threefry2x32(key, idx >> 32, idx & MASK32)
    return (hi ^ lo).reshape(tuple(shape))


def uniform(key, shape: Sequence[int], *,
            device: Optional[torch.device] = None, start: int = 0,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32:
    the top 23 bits as a mantissa under exponent 0, minus one, scaled to
    ``max(minval, u * (maxval - minval) + minval)`` in float32, op for op
    (``jax._src.random._uniform``). XLA may contract the multiply-add into
    an FMA (its CPU backend does), so under other bounds than (0, 1) and
    (tiny, 1), where both roundings are exact, a value may lie an ulp
    from JAX's. ``start`` as in :func:`random_bits`."""
    bits = random_bits(key, shape, device=device, start=start)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats   # (maxval - minval) = 1 and + 0: exact as it is
    lo = torch.full((), minval, dtype=torch.float32, device=floats.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape: Sequence[int], *,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, JAX 0.9's default
    ``"low"`` mode: ``-log(-log(uniform(minval=tiny, maxval=1)))`` with
    ``tiny`` the smallest normal float32 (``jax._src.random._gumbel``).
    The bits and the uniforms are JAX's bit for bit; torch's ``log`` may
    round an ulp away from XLA's, so the values agree to a few ulps."""
    u = uniform(key, shape, device=device,
                minval=float(torch.finfo(torch.float32).tiny), maxval=1.0)
    return -torch.log(-torch.log(u))
