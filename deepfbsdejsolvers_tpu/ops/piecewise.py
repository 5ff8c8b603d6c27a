"""Piecewise-polynomial collocation — short-chain table interpolant.

A degree-63 global Clenshaw recurrence is ~190 serial elementwise ops per
evaluation, x2 functions (compensator + pricer), x forward/backward, per SDE
step.  The same 64 degrees of freedom arranged as P=8 pieces x degree-(D-1)=7
local polynomials evaluate in

  ~10 elementwise ops (piece index + local coordinate)
  + one exact per-path select of the piece's coefficient row (``_select``)
  + a degree-7 local Clenshaw chain

— a far shorter dependency chain than global Clenshaw, while for analytic
integrands the piecewise fit is at least as accurate (each piece resolves 1/P
of the interval with 8 nodes; interpolation error decays like
(piece width)^D).

Fit: per piece, the function is sampled at D Chebyshev points of the piece
(no Runge issues, smooth extrapolation to the piece edges) and the local
monomial coefficients — in the piece-local coordinate t in [-1, 1], where
the degree-7 Vandermonde has condition ~257 (the same fit on [0, 1] is
~1.2e5-conditioned and loses ~1e-2 in float32) — are recovered with a
precomputed inverse.  Global monomial conversion at degree 63 would be
hopeless; degree 7 on [-1, 1] is fine (measured f32 sup error ~3e-5 on
exp over [0.3, 3], i.e. ~2e-6 relative).

Gradients flow exactly like the Clenshaw path: the fit is linear in the
nodal values, Horner is polynomial in the coefficients and the local
coordinate, and the piece index / interval ends are stop_gradient'ed
(piecewise-constant numerical devices).  Out-of-interval points clamp to the
boundary, matching ops/chebyshev.py's behavior.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _pw_tables(n_pieces: int, degree: int):
    """Sample points for a (P pieces) x (degree+1) piecewise fit: (P*D,) in
    the GLOBAL [0, 1] coordinate, D Chebyshev points per piece.  (The fit
    itself lives in pw_fit/_pw_cheb_fit — the original inverse-Vandermonde
    monomial fit matrix was dropped with the basis switch; see pw_fit's
    conditioning note.)"""
    d = degree + 1
    k = np.arange(d)
    # Chebyshev points of the piece, in piece-local [-1, 1]
    t_loc = -np.cos(np.pi * (k + 0.5) / d)                     # (D,)
    pieces = np.arange(n_pieces)
    t_glob = ((pieces[:, None] + 0.5 * (t_loc[None, :] + 1.0))
              / n_pieces).reshape(-1)
    return t_glob.astype(np.float32)


def pw_nodes(x_lo: jax.Array, x_hi: jax.Array, n_pieces: int,
             degree: int) -> jax.Array:
    """Sample points on [x_lo, x_hi] (last axis, P*D points); ends are
    gradient-stopped like cheb_nodes."""
    t = _pw_tables(n_pieces, degree)
    x_lo = jax.lax.stop_gradient(x_lo)
    x_hi = jax.lax.stop_gradient(x_hi)
    return x_lo[..., None] + (x_hi - x_lo)[..., None] * jnp.asarray(t)


def pw_fit(values: jax.Array, n_pieces: int, degree: int) -> jax.Array:
    """Local CHEBYSHEV coefficients (..., P, D) from values at the pw_nodes
    points (..., P*D).

    Basis note: originally a local-monomial fit (inverse Vandermonde,
    condition 257 at degree 7 -> a ~257*eps ~ 3e-5 absolute error floor in
    f32).  The Chebyshev collocation basis is sqrt(2)-conditioned at every
    degree, which removes that floor, matches the 2-D pw2_* fit, and is
    pw_eval's per-piece Clenshaw costs 2x the FMAs of the monomial
    Horner."""
    d = degree + 1
    fit = jnp.asarray(_pw_cheb_fit(degree))
    v = values.reshape(values.shape[:-1] + (n_pieces, d))
    # full-f32 matmul: a reduced-precision matmul (bf16 passes, or TF32's
    # 10-bit mantissa on a GPU) rounds the coefficients to ~1e-3..4e-3
    # relative — a direct per-step bias in the compensator that measurably
    # corrupts training (the round-3 gate failed at 4e-3..1.3e-2 before
    # this fix).
    return jnp.matmul(v, fit.T, precision=jax.lax.Precision.HIGHEST)


# Per-path coefficient select.  It must return the table rows EXACTLY: a
# one-hot matmul at DEFAULT or HIGH precision runs in TF32 on an H100
# (10-bit mantissa; measured ~900 f32 eps off at 2^17 points on an H100
# 80GB HBM3 at 700 W), which is the per-step compensator bias pw_fit's note
# describes.  HIGHEST makes the one-hot matmul exact (full f32 products of
# 1.0/0.0 with the row).  The other exact form, a gather coef[k] whose
# gradient is a scatter-add, measured 2.2e8 against 4.4e8 paths*steps/s for
# the one-hot matmul in the headline step on the same card (PERF.md).


def _select(coef: jax.Array, k: jax.Array) -> jax.Array:
    """Rows ``coef[k]`` of a (P, D) table for float piece indices k (B,)
    already clipped to [0, P-1]; returns (B, D), exact in f32."""
    onehot = (k[..., None] == jnp.arange(coef.shape[-2], dtype=k.dtype)
              ).astype(coef.dtype)
    return jnp.matmul(onehot, coef, precision=jax.lax.Precision.HIGHEST)


def pw_eval(coef: jax.Array, x: jax.Array, x_lo: jax.Array,
            x_hi: jax.Array) -> jax.Array:
    """Evaluate the piecewise Chebyshev interpolant at x.

    coef: (P, D) local Chebyshev coefficients (pw_fit); x: (B,); x_lo/x_hi
    scalars (one step's interval).  Out-of-interval x clamps to the
    boundary."""
    p, d = coef.shape[-2], coef.shape[-1]
    x_lo = jax.lax.stop_gradient(x_lo)
    x_hi = jax.lax.stop_gradient(x_hi)
    span = jnp.maximum(x_hi - x_lo, 1e-6)
    s = jnp.clip((x - x_lo) / span, 0.0, 1.0) * p              # global in [0, P]
    k = jax.lax.stop_gradient(jnp.clip(jnp.floor(s), 0, p - 1))
    t = 2.0 * (s - k) - 1.0                                    # local in [-1, 1]
    c = _select(coef, k)                                       # (B, D)
    b1 = jnp.zeros_like(t)
    b2 = b1
    for j in range(d - 1, 0, -1):          # Clenshaw, 2(D-1) FMAs
        b1, b2 = c[..., j] + 2.0 * t * b1 - b2, b1
    return c[..., 0] + t * b1 - b2


def pw_eval_with_deriv(coef: jax.Array, x: jax.Array, x_lo: jax.Array,
                       x_hi: jax.Array):
    """(value, d/dx value) of the piecewise Chebyshev interpolant at x,
    sharing one coefficient select.  Matches jax.grad(pw_eval) exactly:
    out-of-interval points clamp, so their derivative is 0 (the clip's
    subgradient)."""
    p, d = coef.shape[-2], coef.shape[-1]
    x_lo = jax.lax.stop_gradient(x_lo)
    x_hi = jax.lax.stop_gradient(x_hi)
    span = jnp.maximum(x_hi - x_lo, 1e-6)
    s_raw = (x - x_lo) / span
    inside = ((s_raw >= 0.0) & (s_raw <= 1.0)).astype(x.dtype)
    s = jnp.clip(s_raw, 0.0, 1.0) * p
    k = jax.lax.stop_gradient(jnp.clip(jnp.floor(s), 0, p - 1))
    t = 2.0 * (s - k) - 1.0
    c = _select(coef, k)
    b1 = jnp.zeros_like(t)
    b2 = b1
    db1 = jnp.zeros_like(t)
    db2 = db1
    for j in range(d - 1, 0, -1):          # Clenshaw for value + derivative
        b1, b2, db1, db2 = (c[..., j] + 2.0 * t * b1 - b2, b1,
                            2.0 * b1 + 2.0 * t * db1 - db2, db1)
    val = c[..., 0] + t * b1 - b2
    dval = b1 + t * db1 - db2
    # chain rule: dt/dx = 2p/span inside the interval, 0 when clamped
    return val, dval * (2.0 * p / span) * inside


@functools.lru_cache(maxsize=None)
def _pw_cheb_fit(degree: int):
    """Values-at-Chebyshev-points -> local CHEBYSHEV coefficients map (D, D).

    The 2-D tensor-product fit cannot use the monomial basis: the two
    inverse-Vandermonde maps compose, so the conditioning MULTIPLIES
    (257 x 19.6 ~ 5e3 at the default (deg 7) x (deg 4) — x f32 eps ~ 5e-4,
    which measured as a ~1e-3 floor on the fitted Γ table that no amount of
    piece refinement could cross).  The Chebyshev-basis collocation matrix
    T_k(t_i) at first-kind points has condition sqrt(2) at EVERY degree, so
    the tensor-product fit stays at O(eps)."""
    d = degree + 1
    k = np.arange(d)
    t_loc = -np.cos(np.pi * (k + 0.5) / d)
    T = np.cos(np.arange(d)[None, :] * np.arccos(np.clip(t_loc[:, None],
                                                         -1.0, 1.0)))
    return np.linalg.inv(T).astype(np.float32)


def _clenshaw(c: jax.Array, t: jax.Array) -> jax.Array:
    """Chebyshev series sum_k c[..., k] T_k(t) by Clenshaw recurrence.
    c: (..., D); t broadcastable to c[..., 0]."""
    d = c.shape[-1]
    b1 = jnp.zeros_like(c[..., 0])
    b2 = b1
    for k in range(d - 1, 0, -1):
        b1, b2 = c[..., k] + 2.0 * t * b1 - b2, b1
    return c[..., 0] + t * b1 - b2


def pw2_nodes(x_lo, x_hi, j_lo, j_hi, px: int, dx: int, pj: int, dj: int):
    """Tensor-product sample grid for a 2-D piecewise fit.

    Returns (xn, jn): xn (..., px*(dx+1)) and jn (..., pj*(dj+1)) sample
    points on [x_lo, x_hi] x [j_lo, j_hi]; the caller evaluates the target
    on the outer product xn[..., :, None] x jn[..., None, :]."""
    return (pw_nodes(x_lo, x_hi, px, dx), pw_nodes(j_lo, j_hi, pj, dj))


def pw2_fit(values: jax.Array, px: int, dx: int, pj: int, dj: int) -> jax.Array:
    """Local 2-D CHEBYSHEV coefficients (..., px*pj, (dx+1)*(dj+1)) from
    values on the pw2_nodes outer-product grid (..., px*(dx+1), pj*(dj+1)).

    Tensor-product fit: the two 1-D Chebyshev collocation inverses applied
    along their axes (full-f32 matmuls — see pw_fit's precision note; the
    basis choice is a conditioning requirement, see _pw_cheb_fit)."""
    ddx, ddj = dx + 1, dj + 1
    fx = jnp.asarray(_pw_cheb_fit(dx))                         # (ddx, ddx)
    fj = jnp.asarray(_pw_cheb_fit(dj))                         # (ddj, ddj)
    *lead, nx, nj = values.shape
    v = values.reshape(*lead, px, ddx, pj, ddj)
    hi = jax.lax.Precision.HIGHEST
    v = jnp.einsum("...aibj,xi->...abxj", v, fx, precision=hi)
    v = jnp.einsum("...abxj,yj->...abxy", v, fj, precision=hi)
    # flatten (px, pj, ddx, ddj) -> (piece = kx*pj + kj, coeff = x*ddj + y)
    # so pw2_eval selects rows with ONE select over the combined piece index
    return v.reshape(*lead, px * pj, ddx * ddj)


def pw2_eval(coef: jax.Array, x: jax.Array, j: jax.Array, x_lo, x_hi,
             j_lo, j_hi, px: int, dx: int, pj: int, dj: int) -> jax.Array:
    """Evaluate the 2-D piecewise Chebyshev interpolant at (x, j).

    coef: (px*pj, (dx+1)*(dj+1)) from pw2_fit (one step's table); x, j (B,).
    Piece selection is ONE exact row select over the combined index
    kx*pj + kj (like pw_eval); evaluation is a nested Clenshaw:
    dx+1 chains of 2*dj FMAs in t_j, then 2*dx in t_x (~2x the FMAs of the
    monomial Horner — bought back many times over by the conditioning, see
    _pw_cheb_fit).  Out-of-interval points clamp to the boundary (gradient 0
    past the edge, like pw_eval)."""
    ddx, ddj = dx + 1, dj + 1
    x_lo = jax.lax.stop_gradient(x_lo)
    x_hi = jax.lax.stop_gradient(x_hi)
    j_lo = jax.lax.stop_gradient(j_lo)
    j_hi = jax.lax.stop_gradient(j_hi)
    sx = jnp.clip((x - x_lo) / jnp.maximum(x_hi - x_lo, 1e-6), 0.0, 1.0) * px
    sj = jnp.clip((j - j_lo) / jnp.maximum(j_hi - j_lo, 1e-6), 0.0, 1.0) * pj
    kx = jax.lax.stop_gradient(jnp.clip(jnp.floor(sx), 0, px - 1))
    kj = jax.lax.stop_gradient(jnp.clip(jnp.floor(sj), 0, pj - 1))
    tx = 2.0 * (sx - kx) - 1.0                                 # local [-1, 1]
    tj = 2.0 * (sj - kj) - 1.0
    c = _select(coef, kx * pj + kj)                            # (B, ddx*ddj)
    c = c.reshape(c.shape[:-1] + (ddx, ddj))
    # inner Clenshaw in t_j for each x-degree, then outer Clenshaw in t_x
    acc_j = _clenshaw(c, tj[..., None])                        # (B, ddx)
    return _clenshaw(acc_j, tx)


def pw_interp_1d(fn, x: jax.Array, n_pieces: int = 8, degree: int = 7,
                 robust_sigmas=None) -> jax.Array:
    """Drop-in analogue of chebyshev.interp_1d with the piecewise evaluator:
    calls ``fn`` on P*(degree+1) points spanning the range of ``x``."""
    from deepfbsdejsolvers_tpu.ops.chebyshev import _range_of

    x_lo, x_hi = _range_of(x, robust_sigmas)
    nodes = pw_nodes(x_lo, x_hi, n_pieces, degree)
    coef = pw_fit(fn(nodes), n_pieces, degree)
    return pw_eval(coef, x, x_lo, x_hi)
