"""MASJ duplicate elimination (the paper's query phase E), torch twin
of ``repro.query.dedup``.

``unique_pairs`` gathers all candidate (r, s) id pairs, sorts them
lexicographically and keeps first occurrences.  The reference sorts
with two stable int32 argsorts; here one stable sort of the int64 key
``rid * 2**32 + (sid + 2**31)`` gives the same permutation (the key
orders as ``(rid, sid)`` for any int32 pair, padding included).
"""
from __future__ import annotations

import torch


def lexsort_pairs(rid: torch.Tensor, sid: torch.Tensor) -> torch.Tensor:
    """(P,) x (P,) -> (P,) permutation sorting (rid, sid)
    lexicographically, stable."""
    key = (rid.long() << 32) + (sid.long() + 2**31)
    return torch.sort(key, stable=True).indices


def unique_pairs(rid: torch.Tensor, sid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Count + mark unique non-padding pairs.

    rid, sid: (P,) int32 candidate pair ids, (-1, -1) in padding slots
    -> ``(n_unique 0-d int64, uniq[P] bool)``, ``uniq`` marking the
    first occurrence of each real pair in the original order.
    """
    order = lexsort_pairs(rid, sid)
    r_s, s_s = rid[order], sid[order]
    first = torch.ones_like(r_s, dtype=torch.bool)
    first[1:] = (r_s[1:] != r_s[:-1]) | (s_s[1:] != s_s[:-1])
    uniq_sorted = first & (r_s >= 0)
    uniq = torch.empty_like(uniq_sorted)
    uniq[order] = uniq_sorted
    return uniq_sorted.sum(), uniq
