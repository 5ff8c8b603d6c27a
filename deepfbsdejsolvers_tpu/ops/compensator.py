"""Compensated-jump expectation  E_J[ Γ(t, X, J) ].

The reference estimates the compensator of the jump term by re-drawing an
*independent 5000-sample jump batch every timestep* and averaging the Γ-network
over it (SolversJumpDiff.py:34,38-39,41; SolversPureJump.py:32,35-36).  That is
a [5000, B] network sweep per step — the dominant cost of every solver.

This module provides two evaluation modes behind one spec:

* ``kind="mc"``    — faithful Monte-Carlo mode: ``n_mc`` samples drawn from the
  model's jump law each step, **shared across the batch** exactly like the
  reference (the 5000 draws are broadcast against the batch axis there).
* ``kind="quadrature"`` — deterministic quadrature over the *known* jump law
  (allowed by the north-star spec).  Each model exposes
  ``jump_quadrature(spec) -> (nodes, weights)``; the sweep shrinks from 5000
  random samples to O(30-130) fixed nodes with far lower variance.  Weights are
  renormalized to sum to one so a constant Γ is compensated exactly, matching
  the MC estimator's invariant  mean(const) == const.

Either way the inner sweep is an embarrassingly parallel [M, B] network
evaluation that XLA maps onto a single batched matmul; under a device mesh
the node axis can additionally be sharded (parallel/data_parallel.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class CompensatorSpec:
    """How to evaluate the inner jump expectation.

    ``n_mc``          MC sample count (reference hard-codes 5000).
    ``n_poisson_max`` Poisson mixture truncation for compound-Poisson laws
                      (Merton): terms k = 0..n_poisson_max.
    ``n_hermite``     Gauss-Hermite points for the Gaussian inner integral.
    ``n_laguerre``    generalized Gauss-Laguerre points for Gamma subordinators
                      (Variance Gamma).
    """

    kind: str = "quadrature"  # "mc" | "quadrature"
    n_mc: int = 5000
    n_poisson_max: int = 6
    n_hermite: int = 8
    n_laguerre: int = 12
    # How the node sweep is evaluated over the batch:
    # "direct"    — every (node, path) pair gets a head evaluation (reference
    #               semantics; O(M·B) per step).
    # "chebyshev" — exploit that comp(x) = E_J[Γ(t,x,J)] is 1-D and smooth in
    #               the spot: evaluate the exact sweep at n_cheb Chebyshev
    #               points spanning the batch range, reconstruct per path by
    #               Clenshaw (O(M·n_cheb + B·n_cheb); ops/chebyshev.py).
    x_interp: str = "direct"
    n_cheb: int = 32
    # Robust collocation interval (mean ± k·std) — None keeps the full
    # [min, max] range; set ~8 for heavy-tailed path laws (VG) where
    # outliers stretch the range and waste polynomial resolution.
    cheb_robust_sigmas: float | None = None
    # Node-axis chunking of the direct [M, B] sweep: the reference-exact
    # MC-5000 sweep materializes [5000, B, H] activations (tens of GB at
    # B=2^17 — OOM).  ``None`` = auto (chunk so one block's activations stay
    # ~1 GB: block = 2^24 // B, no-op when M·B is small); an int forces that
    # block size; 0 disables chunking.  Blocks run as a rematerialized
    # ``lax.map`` of weighted partial sums — same value/gradient, O(block·B)
    # peak memory.
    node_block: int | None = None

    def __post_init__(self):
        if self.kind not in ("mc", "quadrature"):
            raise ValueError(f"unknown compensator kind {self.kind!r}")
        if self.x_interp not in ("direct", "chebyshev"):
            raise ValueError(f"unknown x_interp {self.x_interp!r}")


def gauss_hermite(n: int):
    """Probabilists' Gauss-Hermite rule: nodes/weights for E[f(Z)], Z~N(0,1)."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    w = w / w.sum()
    return x.astype(np.float64), w.astype(np.float64)


def compound_poisson_quadrature(lam_dt: float, mu: float, sig: float, spec: CompensatorSpec):
    """Quadrature for J = dN*mu + sig*sqrt(dN)*Z with dN~Poisson(lam_dt), Z~N(0,1)
    (the Merton jump law, pricingModels.py:57-61).

    Mixture over k jumps: J | dN=k ~ N(k*mu, k*sig^2).  Returns flat
    (nodes, weights) with weights renormalized over the truncated mixture.
    """
    z, wz = gauss_hermite(spec.n_hermite)
    nodes = [np.zeros(1)]
    weights = [np.array([np.exp(-lam_dt)])]  # k = 0 -> J = 0 exactly
    pk = np.exp(-lam_dt)
    for k in range(1, spec.n_poisson_max + 1):
        pk = pk * lam_dt / k
        nodes.append(k * mu + sig * np.sqrt(float(k)) * z)
        weights.append(pk * wz)
    nodes = np.concatenate(nodes)
    weights = np.concatenate(weights)
    weights = weights / weights.sum()
    return nodes.astype(np.float32), weights.astype(np.float32)


def gamma_subordinated_quadrature(a: float, scale: float, theta: float, sig: float,
                                  spec: CompensatorSpec):
    """Quadrature for J = theta*G + sig*sqrt(G)*Z with G~Gamma(a, scale), Z~N(0,1)
    (the Variance-Gamma increment law, pricingModels.py:188-191).

    Substituting G = scale*s reduces the G-integral to a generalized
    Gauss-Laguerre rule with alpha = a-1 (valid for a > 0, weights / Γ(a)).
    """
    from scipy.special import roots_genlaguerre, gammaln

    s, ws = roots_genlaguerre(spec.n_laguerre, a - 1.0)
    ws = ws * np.exp(-gammaln(a))
    z, wz = gauss_hermite(spec.n_hermite)
    g = scale * s  # (L,)
    nodes = theta * g[:, None] + sig * np.sqrt(g)[:, None] * z[None, :]  # (L, H)
    weights = ws[:, None] * wz[None, :]
    nodes = nodes.reshape(-1)
    weights = weights.reshape(-1)
    weights = weights / weights.sum()
    return nodes.astype(np.float32), weights.astype(np.float32)


def compensated_mean(values: jax.Array, weights: jax.Array | None) -> jax.Array:
    """Weighted mean over the node axis (axis 0) of an [M, ...] sweep.

    ``weights=None`` means uniform (the MC mode — tf.reduce_mean at
    SolversJumpDiff.py:41).  Quadrature weights already sum to one.
    """
    if weights is None:
        return jnp.mean(values, axis=0)
    w = weights.reshape((-1,) + (1,) * (values.ndim - 1)).astype(values.dtype)
    return jnp.sum(w * values, axis=0)
