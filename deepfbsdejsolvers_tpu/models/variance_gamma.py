"""Variance-Gamma pure-jump pricing model (forward-backward coupled).

Behavioral parity with the reference's two VG classes
(coupledPricing/pricingModels.py:73-126 ``VGmodelinvfourier`` and :130-199
``VGmodel``): gamma-subordinated Brownian increments J = θΓ + σJ√Γ·Z with
martingale drift correction, forward step
X_{i+1} = X_i·exp((r-ω)dt + J) + func(Y - A(i,X))·dt, driver -rY, call payoff,
and two European-call pricers from the VG characteristic function:

* ``pricer="fft"``        — Carr-Madan 2^15-point FFT (:156-179).  The
  reference evaluates the FFT *and* a host-side scipy cubic spline through
  ``tf.numpy_function`` on every call — inside the per-step hot loop.  The
  price curve depends only on the step index, never on learned state, so here
  the (N, 2^15) log-moneyness table is built ONCE at model construction
  (numpy, float64) and per-step pricing is an O(1) uniform-grid cubic
  interpolation on device (ops/interp.py).
* ``pricer="invfourier"`` — Lewis/Gil-Pelaez trapezoid quadrature on a 10^3
  grid (:95-107), kept as an independent cross-check oracle.  The exercise
  probabilities Q1/Q2 depend only on log-moneyness, so they are likewise
  precomputed per step on a uniform k-grid (host numpy, complex128 — no
  complex arithmetic on the device) and evaluated on device by table
  interpolation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from deepfbsdejsolvers_tpu.ops.compensator import (
    CompensatorSpec,
    gamma_subordinated_quadrature,
)
from deepfbsdejsolvers_tpu.ops.interp import uniform_interp_cubic

_FFT_N = 2**15
_FFT_B = 500.0


@dataclasses.dataclass(frozen=True)
class VGModel:
    """Pure-functional Variance-Gamma model; all methods jit/scan-safe."""

    regime = "pure_jump"  # no Brownian term; BSDE driven by compensated jumps only

    T: float
    N: int
    r: float
    theta: float
    kappa: float
    sigJ: float
    K: float
    x0: float
    coupling: Callable[[jax.Array], jax.Array]
    pricer: str = "fft"
    # "direct" interpolates the price table per path (4 gathers/eval);
    # "chebyshev" collocates the table interpolant at 64 Chebyshev points over
    # the batch's spot range and evaluates per path by Clenshaw — gathers drop
    # from O(B) to O(64) per step.
    price_eval: str = "direct"
    n_cheb_price: int = 64
    # robust collocation interval (mean ± k·std); see ops/chebyshev.py.
    # Measured within training noise of the full range on the VG gate —
    # kept available for heavier-tailed parameterizations.
    cheb_robust_sigmas: float | None = None
    # "exact": jax.random.gamma for the subordinator — Marsaglia-Tsang
    # rejection, whose while-loop was measured to be ~80% of the VG speed
    # config's device time (round-3 trace).  "icdf": the subordinator's
    # shape is FIXED (dt/kappa), so its quantile function is precomputed on
    # host (scipy) as a piecewise-Chebyshev table indexed by a NORMAL draw,
    # G = kappa*F^{-1}(Phi(z)) — one normal + one gather-free pw_eval per
    # draw, no rejection loop.  Law-exact to the fit error (measured, see
    # tests/test_fast_paths.py): sup|table err| 2.4e-7 in f64 at the default
    # (16 pieces, degree 7, |z|<=5.5); f32 evaluation adds rounding to
    # ~1.6e-5 absolute (~1e-5 of the quantile's range).  Clipped tail mass
    # 2*Phi(-5.5) = 3.8e-8; the right-tail clamp loses ~2e-9 of E[G]
    # (~6e-8 relative).  Same class as the Merton icdf Poisson sampler
    # (models/merton.py).
    jump_sampler: str = "exact"
    icdf_pieces: int = 16
    icdf_degree: int = 7
    icdf_zmax: float = 5.5

    def __post_init__(self):
        if self.jump_sampler not in ("exact", "icdf"):
            raise ValueError(
                f"jump_sampler must be 'exact' or 'icdf', got {self.jump_sampler!r}")
        if self.pricer not in ("fft", "invfourier"):
            raise ValueError(f"pricer must be 'fft' or 'invfourier', got {self.pricer!r}")
        if self.price_eval not in ("direct", "chebyshev"):
            raise ValueError(
                f"price_eval must be 'direct' or 'chebyshev', got {self.price_eval!r}")
        dt = self.T / self.N
        # Martingale drift correction of the jump part (pricingModels.py:141).
        correction = -math.log(1.0 - self.theta * self.kappa
                               - 0.5 * self.kappa * self.sigJ**2) / self.kappa
        object.__setattr__(self, "_dt", float(dt))
        object.__setattr__(self, "_correction", float(correction))
        if self.pricer == "fft":
            table, ku0, dku = self._build_fft_tables()
            object.__setattr__(self, "_fft_table", jnp.asarray(table, jnp.float32))
            object.__setattr__(self, "_ku0", float(ku0))
            object.__setattr__(self, "_dku", float(dku))
        else:
            q1, q2, k0, dk = self._build_invfourier_tables()
            object.__setattr__(self, "_q1_table", jnp.asarray(q1, jnp.float32))
            object.__setattr__(self, "_q2_table", jnp.asarray(q2, jnp.float32))
            object.__setattr__(self, "_k0", float(k0))
            object.__setattr__(self, "_dk", float(dk))
        if self.jump_sampler == "icdf":
            object.__setattr__(self, "_g_coef",
                               jnp.asarray(self._build_gamma_icdf_table(),
                                           jnp.float32))

    def _build_gamma_icdf_table(self) -> np.ndarray:
        """(P, D+1) piecewise-Chebyshev coefficients of z -> kappa *
        GammaQuantile_{dt/kappa}(Phi(z)) on [-icdf_zmax, icdf_zmax],
        fit on host in float64 (scipy ppf at the pw_nodes grid)."""
        from scipy.special import ndtr
        from scipy.stats import gamma as _sp_gamma

        from deepfbsdejsolvers_tpu.ops.piecewise import (_pw_cheb_fit,
                                                         _pw_tables)

        p, deg = self.icdf_pieces, self.icdf_degree
        t_glob = _pw_tables(p, deg)                          # (P*(D+1),) in [0, 1]
        # float64 throughout: in f32, ndtr saturates to exactly 1.0 inside
        # |z| <= 5.5 and the quantile blows up to inf
        z = -self.icdf_zmax + 2.0 * self.icdf_zmax * np.asarray(t_glob,
                                                                np.float64)
        g = _sp_gamma.ppf(ndtr(z), self._dt / self.kappa) * self.kappa
        fit = np.asarray(_pw_cheb_fit(deg), np.float64)      # (D+1, D+1)
        return g.reshape(p, deg + 1) @ fit.T                 # (P, D+1)

    # ---- characteristic function --------------------------------------------
    def _phi_np(self, i_step: int, u: np.ndarray) -> np.ndarray:
        """φ(t_i, u) for complex u (pricingModels.py:152-154), numpy complex128."""
        tau = self.T - i_step * self._dt
        inner = 1.0 - 1j * self.theta * self.kappa * u \
            + 0.5 * self.kappa * self.sigJ**2 * u * u
        return np.exp(tau * (1j * (self.r - self._correction) * u
                             - np.log(inner) / self.kappa))

    def _build_fft_tables(self):
        """Precompute the Carr-Madan integral curve per step on the uniform
        log-moneyness grid ku = -b + lm*k (pricingModels.py:156-170)."""
        n, B = _FFT_N, _FFT_B
        du = B / n
        k = np.arange(n)
        u = k * du
        lm = 2.0 * np.pi / B
        b = n * lm / 2.0
        weight = 3.0 + (-1.0) ** (k + 1)
        weight[0] = 1.0
        weight[-1] = 1.0
        rows = []
        for i_step in range(self.N):
            integrand = (
                np.exp(-1j * b * u)
                * self._phi_np(i_step, u - 0.5j)
                / (u**2 + 0.25)
                * weight * du / 3.0
            )
            rows.append(np.real(np.fft.ifft(integrand) * n))
        return np.stack(rows).astype(np.float32), -b, lm

    # ---- forward dynamics -----------------------------------------------------
    @property
    def dt(self) -> float:
        return self._dt

    @property
    def correction(self) -> float:
        return self._correction

    @property
    def n_state_features(self) -> int:
        return 1

    def init_x(self, batch: int) -> jax.Array:
        return jnp.full((batch,), self.x0, jnp.float32)

    def sample_jumps(self, key: jax.Array, shape) -> jax.Array:
        """VG increment over one dt (pricingModels.py:188-191):
        J = θG + σJ√G·Z, G ~ Gamma(dt/κ, scale=κ)."""
        k_g, k_z = jax.random.split(key)
        z = jax.random.normal(k_z, shape, jnp.float32)
        if self.jump_sampler == "icdf":
            from deepfbsdejsolvers_tpu.ops.piecewise import pw_eval

            zg = jax.random.normal(k_g, shape, jnp.float32)
            flat = pw_eval(self._g_coef, zg.reshape(-1),
                           jnp.float32(-self.icdf_zmax),
                           jnp.float32(self.icdf_zmax))
            # the fit can wiggle ~1e-9 below zero on the flat left region;
            # sqrt demands g >= 0
            g = jnp.maximum(flat.reshape(shape), 0.0)
        else:
            g = jax.random.gamma(k_g, self._dt / self.kappa, shape,
                                 dtype=jnp.float32) * self.kappa
        return self.theta * g + self.sigJ * jnp.sqrt(g) * z

    def step(self, i: jax.Array, x: jax.Array, jump: jax.Array,
             y: jax.Array, price: Optional[jax.Array] = None) -> jax.Array:
        """One step of the coupled pure-jump forward SDE (pricingModels.py:184-185).
        Note: no Brownian term — the pure-jump regime drops dW.  ``price``
        optionally supplies a precomputed A(i, X) (hoisted solver tables)."""
        from deepfbsdejsolvers_tpu.ops.numerics import mul_exp

        a = self.price(i, x) if price is None else price
        # mul_exp, not x*exp(·): a biased f32 exp compounds linearly in N
        # (ops/numerics.py; the cause of the round-4 V-shaped N=960 error
        # rise).
        return mul_exp(x, (self.r - self._correction) * self._dt + jump) \
            + self.coupling(y - a) * self._dt

    def uncoupled_log_increments(self, dw: jax.Array, jump: jax.Array) -> jax.Array:
        """Per-step log-X increments of the UNcoupled dynamics (see the
        Merton twin): (r - omega) dt + J.  ``dw`` is the pure-jump regime's
        zero-width placeholder and is ignored."""
        del dw
        return (self.r - self._correction) * self._dt + jump

    # ---- pricers -----------------------------------------------------------------
    def price(self, i: jax.Array, x: jax.Array) -> jax.Array:
        if (self.price_eval == "chebyshev" and x.ndim == 1
                and x.shape[0] >= 4 * self.n_cheb_price):
            from deepfbsdejsolvers_tpu.ops.chebyshev import interp_1d

            return interp_1d(lambda xn: self._price_direct(i, xn), x,
                             self.n_cheb_price,
                             robust_sigmas=self.cheb_robust_sigmas)
        return self._price_direct(i, x)

    def _price_direct(self, i: jax.Array, x: jax.Array) -> jax.Array:
        if self.pricer == "fft":
            return self.price_fft(i, x)
        return self.price_invfourier(i, x)

    def price_fft(self, i: jax.Array, x: jax.Array) -> jax.Array:
        """Carr-Madan price via the precomputed table (pricingModels.py:156-179),
        cubic-interpolated at log(X/K) on device."""
        curve = self._fft_table[i]
        log_m = jnp.log(x / self.K)
        tau = self.T - i.astype(jnp.float32) * self._dt
        spline = uniform_interp_cubic(curve, log_m, self._ku0, self._dku)
        return x - jnp.sqrt(x * self.K) * jnp.exp(-self.r * tau) / jnp.pi * spline

    def _build_invfourier_tables(self, n_k: int = 4097, k_max: float = 4.0,
                                 n_grid: int = 1000, u_max: float = 5000.0):
        """Host precompute of the Gil-Pelaez probabilities Q1(i, k), Q2(i, k)
        on a uniform log-moneyness grid k = log(K/X) (pricingModels.py:100-106)."""
        k = np.linspace(-k_max, k_max, n_k)                    # (n_k,)
        u = np.linspace(1e-15, u_max, n_grid)[:, None]          # (n_grid, 1)
        # Reference avoids the exact -i pole with -1.0000000000001i (:103).
        q1_rows, q2_rows = [], []
        for i_step in range(self.N):
            denom = self._phi_np(i_step, np.array(-1.0000000000001j))
            phase = np.exp(-1j * u * k[None, :]) / (1j * u)
            int1 = np.real(phase * (self._phi_np(i_step, u - 1j) / denom))
            int2 = np.real(phase * self._phi_np(i_step, u))
            q1_rows.append(0.5 + np.trapezoid(int1, u[:, 0], axis=0) / np.pi)
            q2_rows.append(0.5 + np.trapezoid(int2, u[:, 0], axis=0) / np.pi)
        return (np.stack(q1_rows).astype(np.float32),
                np.stack(q2_rows).astype(np.float32),
                float(k[0]), float(k[1] - k[0]))

    def price_invfourier(self, i: jax.Array, x: jax.Array) -> jax.Array:
        """Gil-Pelaez trapezoid price via the precomputed Q1/Q2 tables
        (pricingModels.py:99-107), cubic-interpolated at k = log(K/X)."""
        tau = self.T - i.astype(jnp.float32) * self._dt
        k = jnp.log(self.K / x)
        q1 = uniform_interp_cubic(self._q1_table[i], k, self._k0, self._dk)
        q2 = uniform_interp_cubic(self._q2_table[i], k, self._k0, self._dk)
        return x * q1 - self.K * jnp.exp(-self.r * tau) * q2

    def price_at_origin(self) -> float:
        """Reference price A(0, x0) (mainVG.py:67-69)."""
        return float(self.price(jnp.asarray(0), jnp.asarray([self.x0]))[0])

    # ---- BSDE pieces ---------------------------------------------------------------
    def f(self, y: jax.Array) -> jax.Array:
        return -self.r * y

    def payoff(self, x: jax.Array) -> jax.Array:
        return jnp.maximum(x - self.K, 0.0)

    # ---- compensator quadrature -------------------------------------------------------
    def jump_quadrature(self, spec: CompensatorSpec):
        nodes, weights = gamma_subordinated_quadrature(
            self._dt / self.kappa, self.kappa, self.theta, self.sigJ, spec
        )
        return jnp.asarray(nodes), jnp.asarray(weights)


def make_vg_default(a_lin: float = 0.1, pricer: str = "fft",
                    jump_sampler: str = "exact") -> VGModel:
    """The mainVG.py:54 default configuration."""
    from deepfbsdejsolvers_tpu.models.merton import abs_coupling

    return VGModel(T=1.0, N=30, r=0.1, theta=-0.1, kappa=0.1, sigJ=0.2, K=1.0,
                   x0=1.0, coupling=abs_coupling(a_lin), pricer=pricer,
                   jump_sampler=jump_sampler)
