"""Chebyshev collocation for the compensator sweep.

Key observation: for every solver scheme the compensated-jump expectation
``comp(x) = E_J[Γ(t, x, J)]`` is a *one-dimensional smooth function of the
spot* — the jump node enters the Γ-head jointly with x, but the expectation
integrates it out, leaving a C^∞ composition of tanh MLPs in x.

So instead of sweeping all M quadrature nodes for every path
(O(M·B) head evaluations per step — the dominant cost of the whole
framework), evaluate the exact sweep at
C Chebyshev points spanning the batch's spot range (O(M·C), shared across
the batch), fit the degree-(C-1) Chebyshev interpolant by DCT, and evaluate
it per path with a Clenshaw recurrence (O(C) fused multiply-adds per path,
no per-path gathers).

Error decays geometrically in C for analytic integrands; C=32 puts the
interpolation error far below the 1e-3 Y0 gate (validated in
tests/test_chebyshev.py and the merton_cheb gate).  Gradients
flow exactly: the DCT fit is linear in the nodal values, Clenshaw is
polynomial in them, and the interval endpoints are stop_gradient'ed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _cheb_tables(n: int):
    """Chebyshev-Gauss points u_k on [-1, 1] and the DCT-II fit matrix F with
    coef = F @ f(u_nodes) giving  f(u) ≈ sum_j coef_j T_j(u).

    Cached as HOST numpy (a cached jnp array would leak tracers across jit
    traces); call sites convert, which jit folds into constants."""
    k = np.arange(n)
    u = np.cos(np.pi * (k + 0.5) / n)                       # (C,) nodes
    # T_j(u_k) = cos(j * pi * (k + 0.5) / n)
    T = np.cos(np.pi * np.outer(np.arange(n), (k + 0.5)) / n)  # (C, C)
    F = (2.0 / n) * T
    F[0] *= 0.5
    return u.astype(np.float32), F.astype(np.float32)


def cheb_nodes(x_lo: jax.Array, x_hi: jax.Array, n: int) -> jax.Array:
    """Chebyshev-Gauss points mapped to [x_lo, x_hi]; endpoints are
    gradient-stopped (the interval choice is a numerical device, not part of
    the function being differentiated)."""
    u = jnp.asarray(_cheb_tables(n)[0])
    x_lo = jax.lax.stop_gradient(x_lo)
    x_hi = jax.lax.stop_gradient(x_hi)
    return 0.5 * (x_lo + x_hi) + 0.5 * (x_hi - x_lo) * u


def cheb_fit(values: jax.Array) -> jax.Array:
    """Chebyshev coefficients from values at the cheb_nodes points (last
    axis), via the precomputed DCT matrix."""
    F = jnp.asarray(_cheb_tables(values.shape[-1])[1])
    # full-f32: a reduced-precision matmul (bf16 passes, TF32) rounds the
    # coefficients to ~1e-3 relative — measurably biases training through
    # the compensator (see ops/piecewise.pw_fit); this matmul is tiny.
    return jnp.matmul(values, F.T, precision=jax.lax.Precision.HIGHEST)


def cheb_eval(coef: jax.Array, x: jax.Array, x_lo: jax.Array,
              x_hi: jax.Array) -> jax.Array:
    """Evaluate sum_j coef_j T_j(u(x)) by Clenshaw recurrence — O(C) FMAs per
    point, fully vectorized over x, no gathers."""
    x_lo = jax.lax.stop_gradient(x_lo)
    x_hi = jax.lax.stop_gradient(x_hi)
    span = jnp.maximum(x_hi - x_lo, 1e-6)
    u = jnp.clip((2.0 * x - (x_lo + x_hi)) / span, -1.0, 1.0)
    n = coef.shape[-1]
    b1 = jnp.zeros_like(u)
    b2 = jnp.zeros_like(u)
    for j in range(n - 1, 0, -1):                           # static unroll
        b1, b2 = coef[j] + 2.0 * u * b1 - b2, b1
    return coef[0] + u * b1 - b2


def _range_of(x: jax.Array, robust_sigmas) -> tuple:
    """Collocation interval: full [min, max], or mean ± k·std intersected with
    it.  Heavy-tailed path distributions (e.g. gamma-subordinated VG) stretch
    the raw range with outliers, wasting polynomial resolution where no mass
    lives; the robust interval concentrates it (outliers are clamped to the
    boundary by cheb_eval, where saturating tanh heads are ~flat)."""
    x_lo, x_hi = jnp.min(x), jnp.max(x)
    if robust_sigmas is not None:
        mu, sd = jnp.mean(x), jnp.std(x)
        x_lo = jnp.maximum(x_lo, mu - robust_sigmas * sd)
        x_hi = jnp.minimum(x_hi, mu + robust_sigmas * sd)
    return x_lo, x_hi


def interp_1d(fn, x: jax.Array, n: int, robust_sigmas=None) -> jax.Array:
    """Approximate ``fn`` (vectorized, 1-D, smooth) on the range of ``x`` by a
    degree-(n-1) Chebyshev interpolant: calls ``fn`` on n points, evaluates
    everywhere in O(n) per path."""
    x_lo, x_hi = _range_of(x, robust_sigmas)
    nodes = cheb_nodes(x_lo, x_hi, n)
    coef = cheb_fit(fn(nodes))
    return cheb_eval(coef, x, x_lo, x_hi)
