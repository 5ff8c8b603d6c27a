"""Bias-free multiplicative-walk update in f32.

A device's f32 ``exp`` is an approximation; f32 multiply/add are exactly
rounded.  If the approximation's error near argument zero is BIASED (not
random-signed), an N-step multiplicative forward walk ``X ← X·exp(u_i)``
(the discretized asset dynamics of every pricing model,
pricingModels.py:53-54 and :184-185) compounds the per-step deficit
LINEARLY in N.  Round 4 diagnosed exactly that on the accelerator this
library was first tuned on (``scripts/vg_forward_diag.py`` --mode
chain/moment; history in ``git show 1858ddd:BASELINE.md``): E[X_N]
defects that grew with N and caused the V-shaped VG N-study error rise — a forward-LAW bias,
not optimization.  Whether the GPU's ``exp`` is biased is not yet measured;
``mul_exp`` removes the dependence either way.

The fix: carry the exact part of the factor exactly.  ``mul_exp(x, u)``
computes ``x·e^u`` as ``x + x·expm1_acc(u)`` where :func:`expm1_acc` is a
degree-7 Taylor polynomial in exactly-rounded f32 multiplies/adds on
|u| < 0.125 (truncation < 1.3e-11 relative; a device ``expm1`` is itself
an approximation, so it is not the small-branch primitive) with an
``exp(u)−1`` fallback for the rare large
increments, where exp's error is at the random-ulp relative level.  The
identity part of the factor never passes through an approximate
transcendental, so the walk's martingale property survives to the f32
rounding floor (round 4: both walks' E[X_N] defects collapsed below MC
noise).
"""

from __future__ import annotations

import jax.numpy as jnp

# Degree-7 Taylor radius: |u| < 1/8 keeps the truncation term u^7/8!
# below 1.3e-11 relative while covering ~all mass of every shipped
# increment law (VG default: std(u) ≈ 0.013 at N=240; Merton default:
# std ≈ σ√dt ≈ 0.042 at N=50).
_TAYLOR_CUT = 0.125


def expm1_taylor7(u: jnp.ndarray) -> jnp.ndarray:
    """Degree-7 Horner expm1, exactly-rounded f32 mul/add only.

    u·(1 + u/2·(1 + u/3·(⋯(1 + u/7)))) = Σ_{k=1..7} u^k/k!  — unbiased to
    ~1e-9 relative for |u| < 0.125.
    """
    p = u / 7.0
    for k in (6.0, 5.0, 4.0, 3.0, 2.0):
        p = (1.0 + p) * u / k
    return u * (1.0 + p)


def expm1_acc(u: jnp.ndarray) -> jnp.ndarray:
    """Accurate e^u − 1: Taylor on |u| < 0.125, exp(u)−1 beyond."""
    return jnp.where(jnp.abs(u) < _TAYLOR_CUT, expm1_taylor7(u),
                     jnp.exp(u) - 1.0)


def mul_exp(x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """x·e^u with the identity part of the factor carried exactly.

    Drop-in replacement for ``x * jnp.exp(u)`` in multiplicative walks;
    removes any f32 exp bias that would otherwise compound linearly in the
    step count (module docstring).  Differentiable in both arguments.
    """
    return x + x * expm1_acc(u)
