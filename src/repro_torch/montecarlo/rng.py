"""Counter-based keys: one ``torch.Generator`` for each (seed, domain, index).

A key is a plain 63-bit integer.  ``derive(key, domain, index)`` hashes the
triple with splitmix64, so keys of different domains never share a stream
for any indices (a collision needs a 63-bit hash collision).  The domains:

  ``CHUNK_DOMAIN``        chunk c of a streamed pass
  ``PASS_DOMAIN``         the fast / race pass of one scoring run
  ``SPLIT_DOMAIN``        a scenario's racing and conflict-free parts
                          (``RACE_SPLIT`` / ``FREE_SPLIT``; JAX splits the
                          key in two there)
  ``DEVICE_FOLD_DOMAIN``  domain d's key in a sharded stream (``shard=``)
  ``REGIME_FOLD_DOMAIN``  epoch e of the Markov regime chain (``uniform``)

The last two keep the JAX package's tag values (``streaming.py:75``,
``regimes.py:76``).  A generator is seeded with the key itself, so
``generator(key).initial_seed() == key``: a test that injects reference
draws maps a generator back to the chunk it belongs to.
"""
from __future__ import annotations

import torch

CHUNK_DOMAIN = 0
PASS_DOMAIN = 1
SPLIT_DOMAIN = 2
DEVICE_FOLD_DOMAIN = 0x7FFFFFFF
REGIME_FOLD_DOMAIN = 0x7FFFFFFE

FAST_PASS = 0
RACE_PASS = 1

RACE_SPLIT = 0
FREE_SPLIT = 1

_M64 = (1 << 64) - 1
_M63 = (1 << 63) - 1


def _mix(z: int) -> int:
    """splitmix64 finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def root(seed: int) -> int:
    """The key of a run seeded with ``seed``."""
    return _mix(int(seed) & _M64) & _M63


def derive(key: int, domain: int, index: int) -> int:
    """Key of entry ``index`` of ``domain`` under ``key``."""
    z = _mix((int(key) & _M64) ^ _mix(int(domain) & _M64))
    return _mix(z ^ (int(index) & _M64)) & _M63


def generator(key: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return g


def uniform(key: int) -> float:
    """A uniform float in [0, 1) from the key's top 24 bits: exact in f32,
    computed on the host without a generator."""
    return (int(key) >> 39) / float(1 << 24)
