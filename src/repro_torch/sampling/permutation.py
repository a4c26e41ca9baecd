"""Keyed bijective permutations over ``[0, M)`` via a balanced Feistel network
(counterpart of ``repro.sampling.permutation``; integer-identical to it).

The reference computes in uint32.  PyTorch has no CPU right shift for
uint32, so every value here is an int64 tensor holding a 32-bit pattern,
masked back to 32 bits after each operation that can carry out of them.  A
32 x 32-bit product can exceed 2^63, so :func:`_mulc` splits the constant
into 16-bit halves and never relies on int64 overflow.
"""

from __future__ import annotations

import numpy as np
import torch

_NUM_ROUNDS = 4
# SplitMix32 / Murmur3 finalizer constants.
_C1 = 0x9E3779B9
_C2 = 0x85EBCA6B
_C3 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def _mulc(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2^32`` for 32-bit ``x`` (int64 holder) and constant ``c``."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """SplitMix32 finalizer on 32-bit patterns held in int64."""
    x = _mulc(x ^ (x >> 16), _C1)
    x = _mulc(x ^ (x >> 13), _C2)
    return x ^ (x >> 16)


def _u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def chunk_seed(master_seed, chunk_id) -> torch.Tensor:
    """Independent per-chunk permutation key (32-bit pattern, int64)."""
    cid = _u32(chunk_id)
    return _mix32(_u32(master_seed, cid.device) ^ ((_mix32(cid) + _C3) & _M32))


def _round_keys(seed: torch.Tensor) -> torch.Tensor:
    """(..., NUM_ROUNDS) round keys derived from seeds of shape (...)."""
    r = torch.arange(1, _NUM_ROUNDS + 1, dtype=torch.int64, device=seed.device)
    return _mix32((_u32(seed)[..., None] + _mulc(r, _C2)) & _M32)


def _half_bits(domain_m: int) -> int:
    """Half-width (in bits) of the smallest even-width Feistel domain >= M."""
    m = max(int(domain_m), 2)
    total = max(2, int(np.ceil(np.log2(m))))
    total += total % 2  # balanced network needs an even bit count
    return total // 2


def _feistel_round_trip(x: torch.Tensor, keys: torch.Tensor,
                        hb: int) -> torch.Tensor:
    """One 4-round Feistel pass over the 2·hb-bit domain.  ``keys`` is
    (..., NUM_ROUNDS), broadcasting against ``x``'s leading dims."""
    mask = (1 << hb) - 1
    left = (x >> hb) & mask
    right = x & mask
    for r in range(_NUM_ROUNDS):
        f = _mix32(right ^ keys[..., r:r + 1]) & mask
        left, right = right, left ^ f
    return (left << hb) | right


def feistel_permute_dyn(seed, index, m_dynamic, width_m: int) -> torch.Tensor:
    """``perm_seed(index)`` restricted to ``[0, m_dynamic)``.

    ``seed`` and ``m_dynamic`` have shape (...); ``index`` has shape
    (..., K).  The Feistel width is fixed by ``width_m`` (>= any
    ``m_dynamic``); cycle walking re-encrypts every lane still >= its
    ``m_dynamic`` until none is (each ``.any()`` is a host sync on the card,
    and no pass runs when the domain equals the width exactly).
    Returns int64 indices of ``index``'s shape."""
    hb = _half_bits(max(int(width_m), 2))
    seed = torch.as_tensor(seed, dtype=torch.int64)
    keys = _round_keys(seed)
    mj = torch.clamp(torch.as_tensor(m_dynamic, dtype=torch.int64,
                                     device=seed.device), min=1)[..., None]
    v = _feistel_round_trip(_u32(index), keys, hb)
    need = v >= mj
    while bool(need.any()):
        v = torch.where(need, _feistel_round_trip(v, keys, hb), v)
        need = v >= mj
    return v


def feistel_permute(seed, index, domain_m: int) -> torch.Tensor:
    """``perm_seed(index)`` for ``index in [0, M)``: a bijection on
    ``[0, M)`` (the reference's static-width ``feistel_permute``).

    It is :func:`feistel_permute_dyn` with ``m_dynamic = width_m = M``, the
    same bijection: both fix the Feistel width by ``_half_bits(max(M, 2))``,
    encrypt once and cycle-walk every value still ``>= M``; for ``M <= 1``
    the reference returns zeros and the walk down to ``[0, 1)`` ends at 0
    too.  ``index`` may have any shape; ``seed`` is one key.  Returns int64
    indices of ``index``'s shape."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    index = torch.as_tensor(index, dtype=torch.int64, device=seed.device)
    domain_m = int(domain_m)
    if domain_m <= 1:
        return torch.zeros_like(index)
    flat = feistel_permute_dyn(seed, index.reshape(-1), domain_m, domain_m)
    return flat.reshape(index.shape)


def permutation_window(seed, start, count: int, domain_m: int) -> torch.Tensor:
    """Positions ``perm[start : start+count]`` of a chunk's random order,
    wrapping circularly (the Section 6.2 circular random scan): ``(count,)``
    int64 tuple indices for one key."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    domain_m = int(domain_m)
    offs = (torch.as_tensor(start, dtype=torch.int64, device=seed.device)
            + torch.arange(count, dtype=torch.int64, device=seed.device))
    return feistel_permute(seed, offs % max(domain_m, 1), domain_m)


def permutation_window_dyn(seed, start, count: int, m_dynamic,
                           width_m: int) -> torch.Tensor:
    """Circular window ``perm[start : start+count] mod M_j`` per leading
    index: ``seed``/``start``/``m_dynamic`` of shape (...) -> (..., count)."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    dev = seed.device
    start = torch.as_tensor(start, dtype=torch.int64, device=dev)
    mj = torch.as_tensor(m_dynamic, dtype=torch.int64, device=dev)
    offs = start[..., None] + torch.arange(count, dtype=torch.int64, device=dev)
    offs = offs % torch.clamp(mj, min=1)[..., None]
    return feistel_permute_dyn(seed, offs, mj, width_m)


def random_chunk_order(master_seed: int, num_chunks: int) -> np.ndarray:
    """The predetermined random chunk processing order (Section 3),
    committed before execution starts.  Host-side numpy, as in the
    reference, so the schedules are identical."""
    rng = np.random.default_rng(np.uint32(master_seed))
    return rng.permutation(num_chunks).astype(np.int32)
