"""The paper's query-processing cost model (section 2.3), torch twin of
``repro.core.cost_model``.

    C(R join S) = (1+alpha)^2 * |R||S| / k  +  beta(|R| + |S|)

alpha -- boundary-object replication fraction, beta -- per-object
de-duplication cost, k -- partition count.  ``optimal_k`` sweeps the
trade-off given an empirical alpha(k).  Arithmetic is float32 as in the
reference; operands are combined in the same order, and results agree
with it to a relative 1e-6.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CostParams:
    beta: float = 1.0          # dedup cost per object, in pair-test units
    c_pair: float = 1.0        # cost of one pair predicate test


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def join_cost(n_r, n_s, k, alpha, params: CostParams = CostParams()):
    part = (params.c_pair * (1.0 + alpha) ** 2 * n_r * n_s
            / torch.clamp_min(_f32(k), 1.0))
    dedup = params.beta * (n_r + n_s)
    return part + dedup


def straggler_cost(n_r, n_s, k, alpha, skew,
                   params: CostParams = CostParams()):
    """Lock-step refinement: time is gated by the *largest* tile, i.e.
    the mean per-tile cost times the skew ratio."""
    return (join_cost(n_r, n_s, k, alpha, params)
            * torch.clamp_min(_f32(skew), 1.0))


def optimal_k(n_r, n_s, ks, alphas, params: CostParams = CostParams()):
    """-> ``(index of the cheapest k, costs)``."""
    costs = join_cost(_f32(n_r), _f32(n_s), _f32(ks), _f32(alphas), params)
    return torch.argmin(costs), costs
