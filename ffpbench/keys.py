"""Request keys from ``--seed``, and the chunk keys a stream derives.

``request_key(seed, i)`` is the key of the i-th request of a run: the
harness's own arithmetic, so a seed fixes every request of the window.
``chunk_key(key, c)`` is what the program derives for chunk ``c`` of a
stream on ``key`` (splitmix64 over the triple (key, domain 0, c), and the
chunk's ``torch.Generator`` seeded with it); the reference works it out
again here rather than asking the program.
"""
from __future__ import annotations

_M64 = (1 << 64) - 1
_M63 = (1 << 63) - 1

REQUEST_DOMAIN = 0x6666_7062        # "ffpb"
WARMUP_DOMAIN = 0x7761_726D         # "warm"
CHUNK_DOMAIN = 0


def _mix(z: int) -> int:
    """splitmix64 finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def derive(key: int, domain: int, index: int) -> int:
    """63-bit key of entry ``index`` of ``domain`` under ``key``."""
    z = _mix((int(key) & _M64) ^ _mix(int(domain) & _M64))
    return _mix(z ^ (int(index) & _M64)) & _M63


def root(seed: int) -> int:
    """The 63-bit key of a run seeded with any whole number."""
    return _mix(int(seed) & _M64) & _M63


def request_key(seed: int, i: int) -> int:
    return derive(root(seed), REQUEST_DOMAIN, i)


def warmup_key(seed: int) -> int:
    return derive(root(seed), WARMUP_DOMAIN, 0)


def chunk_key(key: int, c: int) -> int:
    return derive(key, CHUNK_DOMAIN, c)
