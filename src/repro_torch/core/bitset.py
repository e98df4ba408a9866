"""Packed per-query visited bitset for the search loops.

Every node is marked when it first enters a lane's beam, so the "seen?"
test of a candidate is one bit probe. A bitset is ``(W,)`` (shared) or
``(Q, W)`` (one row per lane) of int32 words with the reference's uint32
bit layout: bit ``b`` of word ``w`` is slot ``32 * w + b``. (PyTorch has no
shifts, adds or scatter-adds for uint32, so the words are int32; bit 31 is
the sign bit.)

Sizing: ``W = ceil(min(N, cap_bits) / 32)``. Below ``cap_bits`` the filter is
exact (slot == node id); above it ids hash into ``id mod (W * 32)`` — a
false "seen" only skips a candidate.

``bitset_add`` updates in place with a scatter-add, which is exact when the
marked slots are distinct and currently clear: callers probe with
``bitset_contains`` first and dedup the tile. Under that convention no
partial sum can overflow int32 (each add sets a clear bit, carry-free).
"""
from __future__ import annotations

import torch

from ..utils import cdiv

# Per-query filter memory bound: 2^20 bits == 128 KiB.
DEFAULT_BITSET_CAP_BITS = 1 << 20


def bitset_num_words(n_nodes: int, cap_bits: int = DEFAULT_BITSET_CAP_BITS) -> int:
    return cdiv(min(max(int(n_nodes), 1), int(cap_bits)), 32)


def bitset_exact(n_nodes: int, num_words: int) -> bool:
    """True when every node id gets its own bit (no hash bucketing)."""
    return int(n_nodes) <= num_words * 32


def bitset_init(num_words: int, n_lanes: int | None = None,
                device="cpu") -> torch.Tensor:
    shape = (num_words,) if n_lanes is None else (n_lanes, num_words)
    return torch.zeros(shape, dtype=torch.int32, device=device)


def _bit_values(device) -> torch.Tensor:
    # 1 << b as int32; b == 31 is the sign bit (-2^31)
    v = torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        32, device=device)
    return v.to(torch.int32)


def _slots(bits: torch.Tensor, ids: torch.Tensor):
    nb = bits.shape[-1] * 32
    slot = ids % nb  # identity when the filter is exact (ids < nb)
    return (slot // 32).long(), slot % 32


def bitset_contains(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Membership probe of ``ids`` (Q, T) against ``bits`` (Q, W) or a
    shared (W,). ``ids`` must be non-negative; callers mask INVALID lanes."""
    w, b = _slots(bits, ids)
    word = bits[w] if bits.dim() == 1 else torch.gather(bits, 1, w)
    return ((word >> b) & 1).bool()


def bitset_add(bits: torch.Tensor, ids: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Set, in place, the bits of ``ids`` (Q, T) where ``mask``; returns
    ``bits`` (Q, W)."""
    w, b = _slots(bits, torch.where(mask, ids, torch.zeros_like(ids)))
    m = torch.where(mask, _bit_values(bits.device)[b.long()],
                    torch.zeros_like(b))
    return bits.scatter_add_(1, w, m)


def first_slot_occurrence(bits: torch.Tensor, ids: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Mask of entries that are the first occurrence of their *slot* in each
    row of the (Q, T) tile. Needed before ``bitset_add`` in the hashed
    regime, where distinct ids can share a bucket. Stable slot sort: each
    run's head is its first occurrence."""
    nb = bits.shape[-1] * 32
    slot = torch.where(valid, ids % nb, torch.full_like(ids, nb))
    order = torch.argsort(slot, dim=1, stable=True)
    s = torch.gather(slot, 1, order)
    head = torch.ones_like(valid)
    head[:, 1:] = s[:, 1:] != s[:, :-1]
    return torch.zeros_like(valid).scatter(1, order, head) & valid
