"""Batched Levenberg-Marquardt on SE(3) with Huber IRLS.

Replaces the reference's per-frame Ceres solves (HuberLoss(0.1) +
EigenQuaternionManifold + DENSE_QR, max_num_iterations=4;
src/laserOdometry.cpp:475-482,819-826 and src/laserMapping.cpp:1864-1872,
2080-2087).  The 6-dof normal equations are accumulated over all factors
with one fused einsum per factor family — the per-correspondence work is
matmul-shaped; the 6×6 solve is negligible.

Loss handling matches Ceres' corrector to first order: each residual block
is scaled by sqrt(ρ'(‖r‖²)), ρ the Huber loss, and the cost reported is
0.5 Σ ρ(‖r‖²).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from light_loam_tpu.core import quaternion as quat
from light_loam_tpu.solver import residuals as res


class FactorSet(NamedTuple):
    """All factor families for one solve; any entry may be None.

    edge/plane/plane_norm are the live-path families; edge_scalar,
    plane_component and distance are the reference's latent factor types
    (see solver.residuals)."""

    edge: Optional[res.EdgeFactors] = None
    plane: Optional[res.PlaneFactors] = None
    plane_norm: Optional[res.PlaneNormFactors] = None
    edge_scalar: Optional[res.EdgeScalarFactors] = None
    plane_component: Optional[res.PlaneComponentFactors] = None
    distance: Optional[res.DistanceFactors] = None


# (field name, residual fn) registry driving the accumulation loops
_FAMILIES = (
    ("edge", res.edge_residuals),
    ("plane", res.plane_residuals),
    ("plane_norm", res.plane_norm_residuals),
    ("edge_scalar", res.edge_scalar_residuals),
    ("plane_component", res.plane_component_residuals),
    ("distance", res.distance_residuals),
)


def _huber_rho(s2: jnp.ndarray, delta: float):
    """Ceres HuberLoss: ρ(s) = s for s ≤ δ², else 2δ√s − δ²; returns
    (ρ(s), ρ'(s))."""
    d2 = delta * delta
    small = s2 <= d2
    sqrt_s = jnp.sqrt(jnp.maximum(s2, 1e-24))
    rho = jnp.where(small, s2, 2.0 * delta * sqrt_s - d2)
    drho = jnp.where(small, 1.0, delta / sqrt_s)
    return rho, drho


def _accumulate(r, J, mask, delta):
    """Robustified contributions of one factor family.

    r: (N, D), J: (N, D, 6), mask: (N,) → (H (6,6), g (6,), cost scalar).
    """
    m = mask.astype(r.dtype)
    s2 = jnp.sum(r * r, axis=-1)
    rho, w = _huber_rho(s2, delta)
    w = w * m
    H = jnp.einsum("nid,nie->de", J * w[:, None, None], J)
    g = jnp.einsum("nid,ni->d", J * w[:, None, None], r)
    cost = 0.5 * jnp.sum(rho * m)
    return H, g, cost


def _residuals_all(q, t, factors: FactorSet, delta):
    H = jnp.zeros((6, 6), jnp.float32)
    g = jnp.zeros((6,), jnp.float32)
    cost = jnp.float32(0.0)
    for name, res_fn in _FAMILIES:
        fac = getattr(factors, name)
        if fac is not None:
            r, J = res_fn(q, t, fac)
            h, gg, c = _accumulate(r, J, fac.mask, delta)
            H, g, cost = H + h, g + gg, cost + c
    return H, g, cost


def _cost_only(q, t, factors: FactorSet, delta):
    cost = jnp.float32(0.0)
    for name, res_fn in _FAMILIES:
        fac = getattr(factors, name)
        if fac is not None:
            r, _ = res_fn(q, t, fac)
            rho, _d = _huber_rho(jnp.sum(r * r, axis=-1), delta)
            cost = cost + 0.5 * jnp.sum(rho * fac.mask)
    return cost


def lm_solve(
    q0: jnp.ndarray,
    t0: jnp.ndarray,
    factors: FactorSet,
    n_iterations: int = 4,
    huber_delta: float = 0.1,
    lambda_init: float = 1e-4,
    min_factors: int = 1,
    axis_name: str | None = None,
):
    """Run ``n_iterations`` LM steps from (q0, t0).

    Mirrors Ceres' trust-region loop at small scale: damped normal
    equations (H + λ·diag(H)) δ = −g, step accepted only if the robust
    cost decreases (λ ↓ ×1/3 on accept, ↑ ×4 on reject).  If fewer than
    ``min_factors`` factors are active the pose is returned unchanged
    (the reference warns and solves anyway at <10 correspondences,
    laserOdometry.cpp:814-817 — we keep its behavior by defaulting to 1).
    """

    def _allreduce(x):
        # When solving inside a shard_map with factors sharded across
        # ``axis_name``, normal equations and costs are partial sums —
        # psum makes every device solve the identical global 6×6 system
        # (the SURVEY §5/§2.7 distributed-GN design: collectives ride ICI).
        return x if axis_name is None else jax.lax.psum(x, axis_name)

    n_active = jnp.float32(0.0)
    for f in factors:
        if f is not None:
            n_active = n_active + jnp.sum(f.mask.astype(jnp.float32))
    n_active = _allreduce(n_active)
    solvable = n_active >= min_factors

    def step(carry, _):
        q, t, lam, cost = carry
        H, g, _ = _residuals_all(q, t, factors, huber_delta)
        H, g = _allreduce(H), _allreduce(g)
        damped = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
        delta = -jax.scipy.linalg.solve(damped, g, assume_a="pos")
        delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros(6))
        q_new = quat.quat_normalize(quat.quat_multiply(q, quat.quat_exp(delta[:3])))
        t_new = t + delta[3:]
        new_cost = _allreduce(_cost_only(q_new, t_new, factors, huber_delta))
        accept = (new_cost < cost) & solvable
        q = jnp.where(accept, q_new, q)
        t = jnp.where(accept, t_new, t)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, lam * (1.0 / 3.0), lam * 4.0)
        return (q, t, lam, cost), None

    cost0 = _allreduce(_cost_only(q0, t0, factors, huber_delta))
    (q, t, _, cost), _ = jax.lax.scan(
        step, (q0, t0, jnp.float32(lambda_init), cost0), None, length=n_iterations
    )
    return q, t, cost
