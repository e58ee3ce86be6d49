"""Batched LiDAR registration residuals with analytic SE(3) Jacobians.

Batched replacement for the Ceres autodiff cost functors in
src/lidarFactor.hpp.  Each factor family is a struct-of-padded-arrays;
residual functions return (r, J) where J is the Jacobian with respect to
the 6-dim right tangent perturbation [δθ, δt]:

    q(δ) = q0 ⊗ Exp(δθ),  t(δ) = t0 + δt
    p' = R(q) p + t  ⇒  ∂p'/∂δθ = -R0 [p]×,  ∂p'/∂δt = I

Factor weights are baked into the residual (and hence the Jacobian), as in
the reference where e.g. LidarPlaneFactor_modify multiplies the residual by
its vote weight before the robust loss sees it (lidarFactor.hpp:233).

The motion-compensation fraction ``s`` (identity-slerp of the pose,
lidarFactor.hpp:26-27) is 1.0 on the live path (DISTORTION 0,
laserOdometry.cpp:23); for s≠1 the rotation Jacobian uses the standard
small-angle approximation (scaled tangent).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from light_loam_tpu.core import quaternion as quat


class EdgeFactors(NamedTuple):
    """Point-to-line factors (lidarFactor.hpp:9-52).

    residual (3-dim): ((p' - a) × (p' - b)) / ‖a - b‖
    """

    cp: jnp.ndarray      # (N, 3) current points
    a: jnp.ndarray       # (N, 3) line point 1
    b: jnp.ndarray       # (N, 3) line point 2
    s: jnp.ndarray       # (N,)  undistortion fraction
    weight: jnp.ndarray  # (N,)
    mask: jnp.ndarray    # (N,)  bool


class PlaneFactors(NamedTuple):
    """Point-to-plane via precomputed triangle normal
    (LidarPlaneFactor_modify, lidarFactor.hpp:203-251).

    residual (1-dim): ((p' - j) · n̂) * weight, with n̂ the unit normal of
    triangle (j, l, m) fixed at construction (lidarFactor.hpp:210-211).
    """

    cp: jnp.ndarray      # (N, 3)
    j: jnp.ndarray       # (N, 3) plane anchor
    n: jnp.ndarray       # (N, 3) unit normal (precomputed)
    s: jnp.ndarray       # (N,)
    weight: jnp.ndarray  # (N,)
    mask: jnp.ndarray    # (N,)


class PlaneNormFactors(NamedTuple):
    """Plane factors from fitted (n, d) (LidarPlaneNormFactor,
    lidarFactor.hpp:253-285): residual = n · p_w + d."""

    cp: jnp.ndarray    # (N, 3)
    n: jnp.ndarray     # (N, 3) unit normal
    d: jnp.ndarray     # (N,)  negative_OA_dot_norm
    weight: jnp.ndarray  # (N,)
    mask: jnp.ndarray  # (N,)


class EdgeScalarFactors(NamedTuple):
    """Weighted scalar point-to-line distance (LidarEdgeFactor_modify,
    lidarFactor.hpp:54-100): residual = ‖(p'−a)×(p'−b)‖/‖a−b‖ · w.
    Latent in the reference (commented call at laserOdometry.cpp:638);
    used by the full-graph-vote corner mode."""

    cp: jnp.ndarray
    a: jnp.ndarray
    b: jnp.ndarray
    s: jnp.ndarray
    weight: jnp.ndarray
    mask: jnp.ndarray


class PlaneComponentFactors(NamedTuple):
    """Componentwise weighted plane residual (LidarPlaneFactor_modify_test,
    lidarFactor.hpp:151-201): r_i = (p'−j)_i · n̂_i · w, with the z
    component additionally scaled ×1.1.  Experimental/latent in the
    reference — provided for capability parity."""

    cp: jnp.ndarray
    j: jnp.ndarray
    n: jnp.ndarray
    s: jnp.ndarray
    weight: jnp.ndarray
    mask: jnp.ndarray


class DistanceFactors(NamedTuple):
    """Point-to-point residual (LidarDistanceFactor, lidarFactor.hpp:288-319):
    r = p_w − target.  Dead code in the reference (only commented blocks,
    laserMapping.cpp:1923-1939) — provided for capability parity."""

    cp: jnp.ndarray
    target: jnp.ndarray
    weight: jnp.ndarray
    mask: jnp.ndarray


def make_plane_factors(cp, a, b, c, s, weight, mask) -> PlaneFactors:
    """Build PlaneFactors from a point triangle, normalizing
    (j-l)×(j-m) once like the reference constructor."""
    n = jnp.cross(a - b, a - c)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    return PlaneFactors(cp=cp, j=a, n=n, s=s, weight=weight, mask=mask)


def _transform_with_jac(pose_q, pose_t, cp, s):
    """p' = slerp(I, q, s) cp + s·t and its Jacobian wrt [δθ, δt].

    Returns p' (N,3) and Jp (N,3,6).
    """
    # Exact per-point interpolated transform: slerp broadcasts over the
    # per-point fraction, so the undistortion hook costs nothing extra when
    # s ≡ 1 (the live configuration).
    qb = jnp.broadcast_to(pose_q, cp.shape[:1] + (4,))
    qs = quat.quat_slerp_identity(qb, s)  # (N, 4)
    p = quat.quat_rotate(qs, cp) + s[:, None] * pose_t[None, :]

    R = quat.quat_to_matrix(qs)  # (N, 3, 3)
    # -R [cp]× : Jacobian of the rotated point wrt the (scaled) tangent.
    zero = jnp.zeros_like(cp[:, 0])
    cx = jnp.stack(
        [
            jnp.stack([zero, -cp[:, 2], cp[:, 1]], axis=-1),
            jnp.stack([cp[:, 2], zero, -cp[:, 0]], axis=-1),
            jnp.stack([-cp[:, 1], cp[:, 0], zero], axis=-1),
        ],
        axis=-2,
    )  # (N, 3, 3) = [cp]×
    Jrot = -jnp.einsum("nij,njk->nik", R, cx) * s[:, None, None]
    Jt = jnp.broadcast_to(jnp.eye(3, dtype=cp.dtype), Jrot.shape) * s[:, None, None]
    return p, jnp.concatenate([Jrot, Jt], axis=-1)  # (N,3,6)


def edge_residuals(pose_q, pose_t, f: EdgeFactors):
    """(r, J): r (N,3), J (N,3,6)."""
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, f.s)
    u = p - f.a
    v = p - f.b
    de = f.a - f.b
    inv_norm = 1.0 / jnp.maximum(jnp.linalg.norm(de, axis=-1, keepdims=True), 1e-12)
    r = jnp.cross(u, v) * inv_norm
    # d(u×v)/dp' = [b - a]×  (since u - v = b - a)
    ba = f.b - f.a
    zero = jnp.zeros_like(ba[:, 0])
    bax = jnp.stack(
        [
            jnp.stack([zero, -ba[:, 2], ba[:, 1]], axis=-1),
            jnp.stack([ba[:, 2], zero, -ba[:, 0]], axis=-1),
            jnp.stack([-ba[:, 1], ba[:, 0], zero], axis=-1),
        ],
        axis=-2,
    )
    dr_dp = bax * inv_norm[..., None]
    J = jnp.einsum("nij,njk->nik", dr_dp, Jp)
    w = (f.weight * f.mask).astype(p.dtype)
    return r * w[:, None], J * w[:, None, None]


def plane_residuals(pose_q, pose_t, f: PlaneFactors):
    """(r, J): r (N,1), J (N,1,6)."""
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, f.s)
    r = jnp.sum((p - f.j) * f.n, axis=-1, keepdims=True)
    J = jnp.einsum("nj,njk->nk", f.n, Jp)[:, None, :]
    w = (f.weight * f.mask).astype(p.dtype)
    return r * w[:, None], J * w[:, None, None]


def edge_scalar_residuals(pose_q, pose_t, f: EdgeScalarFactors):
    """(r, J): r (N,1), J (N,1,6) — the scalar-norm edge variant."""
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, f.s)
    u = p - f.a
    v = p - f.b
    de = f.a - f.b
    inv_norm = 1.0 / jnp.maximum(jnp.linalg.norm(de, axis=-1, keepdims=True), 1e-12)
    nu = jnp.cross(u, v)
    nu_norm = jnp.sqrt(jnp.maximum(jnp.sum(nu * nu, axis=-1, keepdims=True), 1e-20))
    r = nu_norm * inv_norm
    # d‖nu‖/dp' = (nu/‖nu‖)ᵀ [b−a]×
    ba = f.b - f.a
    zero = jnp.zeros_like(ba[:, 0])
    bax = jnp.stack(
        [
            jnp.stack([zero, -ba[:, 2], ba[:, 1]], axis=-1),
            jnp.stack([ba[:, 2], zero, -ba[:, 0]], axis=-1),
            jnp.stack([-ba[:, 1], ba[:, 0], zero], axis=-1),
        ],
        axis=-2,
    )
    dn_dp = jnp.einsum("nj,njk->nk", nu / nu_norm, bax) * inv_norm
    J = jnp.einsum("nj,njd->nd", dn_dp, Jp)[:, None, :]
    w = (f.weight * f.mask).astype(p.dtype)
    return r * w[:, None], J * w[:, None, None]


def plane_component_residuals(pose_q, pose_t, f: PlaneComponentFactors):
    """(r, J): r (N,3), J (N,3,6) — componentwise plane residual with the
    reference's z ×1.1 emphasis (lidarFactor.hpp:182-184)."""
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, f.s)
    scale = jnp.asarray([1.0, 1.0, 1.1], dtype=p.dtype)
    r = (p - f.j) * f.n * scale[None, :]
    J = f.n[:, :, None] * scale[None, :, None] * Jp
    w = (f.weight * f.mask).astype(p.dtype)
    return r * w[:, None], J * w[:, None, None]


def distance_residuals(pose_q, pose_t, f: DistanceFactors):
    """(r, J): r (N,3), J (N,3,6) — point-to-point."""
    s = jnp.ones(f.cp.shape[0], dtype=f.cp.dtype)
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, s)
    r = p - f.target
    w = (f.weight * f.mask).astype(p.dtype)
    return r * w[:, None], Jp * w[:, None, None]


def plane_norm_residuals(pose_q, pose_t, f: PlaneNormFactors):
    """(r, J): r (N,1), J (N,1,6)."""
    s = jnp.ones(f.cp.shape[0], dtype=f.cp.dtype)
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, s)
    r = (jnp.sum(p * f.n, axis=-1) + f.d)[:, None]
    J = jnp.einsum("nj,njk->nk", f.n, Jp)[:, None, :]
    w = (f.weight * f.mask).astype(p.dtype)
    return r * w[:, None], J * w[:, None, None]
