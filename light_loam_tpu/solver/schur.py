"""Block-sparse Gauss-Newton via Schur complement.

The bundle-adjustment-shaped system arising in windowed multi-keyframe
refinement (models/refine.py):

    [ Hpp  Hpl ] [δp]   [-g_p]
    [ Hplᵀ Hll ] [δl] = [-g_l]

with K 6-dof keyframe poses and M 3-dof plane landmarks.  Hpp is
block-diagonal (poses couple only through landmarks), Hll is
block-diagonal (3×3 per landmark) — the classic BA structure.  Landmarks
are eliminated:

    S = Hpp − Hpl Hll⁻¹ Hplᵀ          (dense 6K×6K, K ≤ ~32)
    S δp = −g_p + Hpl Hll⁻¹ g_l
    δl = −Hll⁻¹ (g_l + Hplᵀ δp)

Everything is batched einsum — the reduction is matmul work; the final dense
solve is 6K×6K and negligible.  This is the reference-free capability the
BASELINE north star adds on top of the Light-LOAM pipeline (distributed
refinement over psum/all-gather collectives — see parallel usage in
models/refine.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched 3×3 inverse via adjugate; singular blocks -> zeros (their
    landmarks contribute nothing)."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adjT = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    ok = jnp.abs(det) > 1e-12
    safe = jnp.where(ok, det, 1.0)
    inv = adjT / safe[..., None, None]
    return jnp.where(ok[..., None, None], inv, 0.0)


def schur_solve(
    Hpp: jnp.ndarray,  # (K, 6, 6) per-pose diagonal blocks
    g_p: jnp.ndarray,  # (K, 6)
    Hpl: jnp.ndarray,  # (K, M, 6, 3) pose-landmark coupling
    Hll: jnp.ndarray,  # (M, 3, 3) per-landmark diagonal blocks
    g_l: jnp.ndarray,  # (M, 3)
    damping: float = 1e-6,
    fix_first_pose: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (δp (K, 6), δl (M, 3)).

    ``fix_first_pose`` pins keyframe 0 (gauge freedom) by adding a large
    prior to its block.
    """
    K = Hpp.shape[0]
    M = Hll.shape[0]

    eye3 = jnp.eye(3, dtype=Hll.dtype)
    Hll_d = Hll + damping * eye3[None] + damping * jnp.einsum(
        "mii->m", Hll
    )[:, None, None] * eye3[None]
    Hll_inv = _inv3x3(Hll_d)

    eye6 = jnp.eye(6, dtype=Hpp.dtype)
    prior = jnp.zeros((K,), Hpp.dtype)
    if fix_first_pose:
        prior = prior.at[0].set(1e8)
    Hpp_d = (
        Hpp
        + damping * eye6[None]
        + damping * jnp.einsum("kii->k", Hpp)[:, None, None] * eye6[None]
        + prior[:, None, None] * eye6[None]
    )

    # W[k,m] = Hpl[k,m] @ Hll_inv[m]
    W = jnp.einsum("kmab,mbc->kmac", Hpl, Hll_inv)
    # S = blockdiag(Hpp) − Σ_m W[k,m] Hpl[k',m]ᵀ  (dense K×K of 6×6)
    S = -jnp.einsum("kmac,jmbc->kjab", W, Hpl)
    S = S.at[jnp.arange(K), jnp.arange(K)].add(Hpp_d)
    rhs = -g_p + jnp.einsum("kmac,mc->ka", W, g_l)

    S_flat = jnp.moveaxis(S, 2, 1).reshape(K * 6, K * 6)
    dp = jax.scipy.linalg.solve(
        S_flat + 1e-9 * jnp.eye(K * 6), rhs.reshape(K * 6), assume_a="gen"
    ).reshape(K, 6)

    # back-substitute landmarks
    dl = -jnp.einsum("mbc,mc->mb", Hll_inv,
                     g_l + jnp.einsum("kmab,ka->mb", Hpl, dp))
    dp = jnp.where(jnp.all(jnp.isfinite(dp)), dp, 0.0)
    dl = jnp.where(jnp.all(jnp.isfinite(dl)), dl, 0.0)
    return dp, dl
