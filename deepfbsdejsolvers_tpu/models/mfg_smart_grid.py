"""Coupled McKean-Vlasov FBSDE for electricity demand response (smart grids).

Behavioral parity with the reference ``ModelCoupledFBSDE``
(coupledMFG/MFGModel.py): consumption Q (and its projection hQ on the common
noise) mean-reverts to a daily profile ``QAver`` under OU dynamics with common
noise σ0·dW0 and idiosyncratic σ·dW (:70-71); cumulative deviation S (and hS)
integrates the feedback controls (:62-63); the clock-since-jump R resets on
doubly-stochastic (Cox) Poisson jumps with intensity λ = β(e^{α·hQ}-1) (:47-54);
closed-form Pontryagin controls α̂(hY), α(hY, Y) gate tariff/incentive terms on
R ≤ θ (:83-89); driver f(U) = C·U (:92-93), terminal g(X) = h1 + h2·X (:97-98).
``coeff_equi`` switches MFG (1) vs aggregate-MFC (2) price internalization.

Redesign — and two reference defects fixed, not replicated:

* the reference model is *stateful* (init/oneStepFrom mutate attributes,
  :35-43,58-71), which only traces correctly because init runs inside
  tf.function.  Here the state is an explicit ``MFGState`` NamedTuple carried
  through ``lax.scan``.
* ``oneStepFrom`` reads a global ``QAver`` instead of ``self.QAver`` (:67-68 —
  NameError in a fresh interpreter).  Fixed; moreover the mean-projection
  ``meanhQ`` recursion depends only on the step index, so it is precomputed
  into an (N+1,) table at construction.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class MFGState(NamedTuple):
    """Explicit carry replacing the reference's mutable attributes
    (MFGModel.py:35-43)."""

    i: jax.Array    # scalar int32 — current step index
    hQ: jax.Array   # (B,) projected consumption
    Q: jax.Array    # (B,) consumption
    R: jax.Array    # (B,) time since last jump
    hS: jax.Array   # (B,) projected cumulative deviation
    S: jax.Array    # (B,) cumulative deviation


# The 48-point average daily consumption profile (mainMFGComparison.py:83-87).
Q_AVER_ONE_DAY = np.array([
    0.26759617, 0.24771933, 0.23588383, 0.221369, 0.21174, 0.2047625,
    0.20651067, 0.20098083, 0.20826067, 0.22095067, 0.24346833, 0.27283267,
    0.3382265, 0.42920433, 0.4875495, 0.50948433, 0.487712, 0.4537295,
    0.40911717, 0.3728925, 0.347346, 0.3419715, 0.32684, 0.320009,
    0.32065767, 0.32586567, 0.31492483, 0.31607417, 0.30411783, 0.29950567,
    0.307519, 0.33259367, 0.375465, 0.45608333, 0.599178, 0.70970583,
    0.7364855, 0.736731, 0.70612667, 0.67284583, 0.66692767, 0.64925583,
    0.604485, 0.55684567, 0.515597, 0.45097333, 0.3822625, 0.31841833,
])


def daily_profile(nb_days: int = 2, raf_coef: int = 1) -> np.ndarray:
    """QAver as the mains build it (mainMFGComparison.py:88-90)."""
    q = np.concatenate([Q_AVER_ONE_DAY] * nb_days, axis=-1)
    return np.tile(q[:, None], [1, raf_coef]).flatten()


@dataclasses.dataclass(frozen=True)
class SmartGridMFGModel:
    """Pure-functional MFG model; N = len(q_aver) - 1, dt = T/N
    (MFGModel.py:18-19)."""

    T: float
    q_aver: np.ndarray
    R0: float
    jump_factor: float
    alpha: float
    beta: float
    coeff_ou: float
    A: float
    K: float
    pi: float
    p0: float
    p1: float
    f0: float
    f1: float
    theta: float
    C: float
    S0: float
    h1: float
    h2: float
    sig0: float
    sig: float
    alpha_target: float
    jump_model: str = "stochastic"   # 'stochastic' (Cox) | 'constant'
    coeff_equi: float = 1.0          # 1 = MFG, 2 = aggregate MFC
    # "exact" uses jax.random.poisson (rejection loops — slow for the Cox
    # case where every path has its own rate); "icdf" is a static-depth
    # hybrid: paths with λ·dt ≤ ``icdf_switch`` invert the Poisson CDF via
    # the pmf recurrence p_k = p_{k-1}·λdt/k (depth derived at construction
    # so the truncated tail mass at the switch point is < ``icdf_tail_tol``);
    # paths above the switch use the normal (CLT) approximation
    # round(λdt + √λdt·Z)⁺ — necessary as well as adequate there, because
    # the f32 recurrence seed e^{-λdt} underflows beyond λdt ≈ 80 while the
    # CLT relative error shrinks like 1/√λdt.  The Cox intensity
    # β(e^{α·hQ}-1) spans orders of magnitude over the daily profile (λ·dt
    # ≈ 25 on the mean path at the consumption peak at the comparison
    # config), so a pure truncated recurrence cannot be made correct.
    # ``icdf_k_max`` is a floor on the derived recurrence depth.
    jump_sampler: str = "exact"
    icdf_k_max: int = 12
    icdf_switch: float = 32.0
    icdf_tail_tol: float = 1e-6

    def __post_init__(self):
        q = np.asarray(self.q_aver, np.float64)
        n = len(q) - 1
        dt = self.T / n
        # meanhQ table (MFGModel.py:67-68, fixed to use the member profile):
        # meanhQ(i) = e^{-c i dt} QAver[0] + c Σ_{j<i} QAver[j] e^{c (j-i) dt} dt
        c = self.coeff_ou
        mean_hq = np.empty(n + 1)
        mean_hq[0] = q[0]
        j = np.arange(n, dtype=np.float64)
        for i in range(1, n + 1):
            jj = j[:i]
            mean_hq[i] = (np.exp(-c * i * dt) * q[0]
                          + c * np.sum(q[:i] * np.exp(c * (jj - i) * dt)) * dt)
        object.__setattr__(self, "_N", int(n))
        object.__setattr__(self, "_dt", float(dt))
        object.__setattr__(self, "_q_aver", jnp.asarray(q, jnp.float32))
        object.__setattr__(self, "_mean_hq", jnp.asarray(mean_hq, jnp.float32))
        # Recurrence depth for the icdf sampler: smallest k whose Poisson
        # tail mass at the switch intensity is < tol (paths above the switch
        # take the CLT branch in sample_dN, so the switch bounds the
        # recurrence's λ·dt regardless of the Cox state).
        lam_dt_bound = max(float(self.icdf_switch), 0.0)
        # The recurrence seed e^{-λdt} is an f32 denormal past λdt ≈ 87 and
        # exactly 0 past ≈ 103: a switch that high silently corrupts the
        # counts of every sub-switch high-intensity path.  80 keeps the seed
        # a normal float with margin.
        if lam_dt_bound > 80.0:
            raise ValueError(
                f"icdf_switch={self.icdf_switch} exceeds the f32 exp(-λ·dt) "
                "underflow limit (~80): the pmf recurrence seed would "
                "underflow to 0 below the CLT switch. Use icdf_switch <= 80.")
        p = np.exp(-lam_dt_bound)
        cdf, k = p, 0
        while cdf < 1.0 - self.icdf_tail_tol and k < 1024:
            k += 1
            p *= lam_dt_bound / k
            cdf += p
        if cdf < 1.0 - self.icdf_tail_tol:
            raise ValueError(
                f"icdf recurrence depth hit the 1024 cap before reaching "
                f"tail tolerance {self.icdf_tail_tol} at icdf_switch="
                f"{self.icdf_switch} — lower the switch or loosen the tol.")
        object.__setattr__(self, "_icdf_k_eff", max(int(self.icdf_k_max), k))

    # ---- scalars ---------------------------------------------------------
    @property
    def N(self) -> int:
        return self._N

    @property
    def dt(self) -> float:
        return self._dt

    @property
    def mean_hq_table(self) -> jax.Array:
        return self._mean_hq

    # ---- state -----------------------------------------------------------
    def init_state(self, batch: int) -> MFGState:
        """MFGModel.py:35-43."""
        ones = jnp.ones((batch,), jnp.float32)
        return MFGState(
            i=jnp.asarray(0, jnp.int32),
            hQ=self._q_aver[0] * ones,
            Q=self._q_aver[0] * ones,
            R=self.R0 * ones,
            hS=self.S0 * ones,
            S=self.S0 * ones,
        )

    # ---- jumps -----------------------------------------------------------
    def intensity(self, state: MFGState) -> jax.Array:
        """Cox intensity λ = β(e^{α·hQ}-1) or constant (MFGModel.py:49-52)."""
        if self.jump_model == "stochastic":
            return self.beta * (jnp.exp(self.alpha * state.hQ) - 1.0)
        return self.jump_factor * jnp.ones_like(state.hQ)

    def sample_dN(self, key: jax.Array, state: MFGState) -> Tuple[jax.Array, jax.Array]:
        """dN ~ Poisson(λ dt) plus the analytic compensator λ dt
        (MFGModel.py:54).  The Cox case has a per-path rate, where
        jax.random.poisson runs a per-path rejection loop; the icdf sampler
        inverts the per-path CDF with a static-depth pmf recurrence."""
        lam_dt = self.intensity(state) * self._dt
        if self.jump_sampler == "icdf":
            ku, kz = jax.random.split(key)
            u = jax.random.uniform(ku, lam_dt.shape, jnp.float32)
            z = jax.random.normal(kz, lam_dt.shape, jnp.float32)
            return self.sample_dN_from(u, z, state)
        dn = jax.random.poisson(key, lam_dt).astype(jnp.float32)
        return dn, lam_dt

    def sample_dN_from(self, u: jax.Array, z: jax.Array,
                       state: MFGState) -> Tuple[jax.Array, jax.Array]:
        """icdf-mode dN from PRE-DRAWN uniforms/normals (the Cox rate depends
        on the state, so dN itself cannot be drawn ahead of the rollout — but
        its underlying u/z can, letting solvers hoist all RNG out of the
        scan).  Same hybrid law as :meth:`sample_dN`."""
        lam_dt = self.intensity(state) * self._dt
        # recurrence branch: λdt clipped at the switch so p never
        # underflows; those paths are overwritten by the CLT branch
        lam_rec = jnp.minimum(lam_dt, self.icdf_switch)
        p = jnp.exp(-lam_rec)                # P(N = 0)
        cdf = p
        dn = jnp.zeros_like(lam_dt)
        for k in range(1, self._icdf_k_eff + 1):
            dn = dn + (u > cdf)              # one count per CDF level passed
            p = p * lam_rec / k
            cdf = cdf + p
        # CLT branch for high-intensity paths (relative error ~ 1/sqrt(λdt))
        dn_big = jnp.round(jnp.maximum(lam_dt + jnp.sqrt(lam_dt) * z, 0.0))
        dn = jnp.where(lam_dt > self.icdf_switch, dn_big, dn)
        return dn, lam_dt

    # ---- controls ----------------------------------------------------------
    def mean_hq(self, state: MFGState) -> jax.Array:
        return self._mean_hq[state.i]

    def calpha_target(self, state: MFGState) -> jax.Array:
        """MFGModel.py:76-79."""
        if self.jump_model == "stochastic":
            return self.alpha_target * self.mean_hq(state)
        return self.alpha_target * jnp.ones_like(state.hQ)

    def calpha_hat(self, state: MFGState, hY: jax.Array) -> jax.Array:
        """Projected Pontryagin control α̂(hY) (MFGModel.py:83-85)."""
        gate = jnp.where(state.R <= self.theta, 1.0, 0.0)
        k_theta = (self.A + (1 - self.pi) * self.coeff_equi * self.p1 + self.K
                   + self.coeff_equi * self.f1 * gate)
        target = self.calpha_target(state)
        return -(1.0 / k_theta) * (
            self.p0 + self.pi * self.p1 * state.hQ
            + ((1 - self.pi) * self.coeff_equi * self.p1 + self.K) * state.hQ
            + hY
            + (self.f0 + self.coeff_equi * self.f1
               * (state.hQ - self.mean_hq(state) - target)) * gate
        )

    def calpha(self, state: MFGState, hY: jax.Array, Y: jax.Array) -> jax.Array:
        """Full control α(hY, Y) (MFGModel.py:87-89)."""
        gate = jnp.where(state.R <= self.theta, 1.0, 0.0)
        a_hat = self.calpha_hat(state, hY)
        target = self.calpha_target(state)
        return -(1.0 / (self.A + self.K)) * (
            self.K * state.Q + self.p0 + self.pi * self.p1 * state.hQ
            + (1 - self.pi) * self.coeff_equi * self.p1 * (state.hQ + a_hat)
            + Y
            + (self.f0 + self.coeff_equi * self.f1
               * (state.hQ - self.mean_hq(state) + a_hat - target)) * gate
        )

    # ---- dynamics ------------------------------------------------------------
    def step(self, state: MFGState, dW0: jax.Array, dW: jax.Array, dN: jax.Array,
             hY: jax.Array, Y: jax.Array) -> MFGState:
        """One forward step (MFGModel.py:58-71): controls and gates use the
        *pre-step* state; hQ/Q mean-revert toward QAver at the *new* index."""
        i_new = state.i + 1
        hS = state.hS + self.calpha_hat(state, hY) * self._dt
        S = state.S + self.calpha(state, hY, Y) * self._dt
        R = state.R + self._dt - jnp.where(dN > 0, state.R, 0.0)
        q_next = self._q_aver[i_new]
        hQ = state.hQ + self.coeff_ou * (q_next - state.hQ) * self._dt + self.sig0 * dW0
        Q = (state.Q + self.coeff_ou * (q_next - state.Q) * self._dt
             + self.sig0 * dW0 + self.sig * dW)
        return MFGState(i=i_new, hQ=hQ, Q=Q, R=R, hS=hS, S=S)

    # ---- BSDE pieces -------------------------------------------------------------
    def f(self, u: jax.Array) -> jax.Array:
        """Driver f(U) = C·U (MFGModel.py:92-93)."""
        return u * self.C

    def g(self, x: jax.Array) -> jax.Array:
        """Terminal g(X) = h1 + h2·X (MFGModel.py:97-98)."""
        return self.h1 + self.h2 * x

    # ---- net features ---------------------------------------------------------------
    def projected_features(self, state: MFGState) -> jax.Array:
        """(t, hQ, hS, R) stacked — the hat-net input (MFGModel.py:102-103,
        coupledMFG/Networks.py:18)."""
        t = jnp.full_like(state.hQ, state.i.astype(jnp.float32) * self._dt)
        return jnp.stack([t, state.hQ, state.hS, state.R], -1)

    def all_features(self, state: MFGState) -> jax.Array:
        """(t, Q, S, hQ, hS, R) stacked — the full-net input (MFGModel.py:106-107)."""
        t = jnp.full_like(state.hQ, state.i.astype(jnp.float32) * self._dt)
        return jnp.stack([t, state.Q, state.S, state.hQ, state.hS, state.R], -1)


def make_mfg_default(nb_days: int = 2, raf_coef: int = 1, jump_factor: float = 2.16,
                     pi: float = 0.1, p0: float = 6.159423723, p1: float = 87.4286117,
                     f0: float = 0.0, f1: float = 1e4, jump_model: str = "stochastic",
                     coeff_equi: float = 1.0) -> SmartGridMFGModel:
    """The mainMFGComparison.py:92-110 default configuration."""
    alpha = 30.0
    return SmartGridMFGModel(
        T=float(nb_days), q_aver=daily_profile(nb_days, raf_coef), R0=2 * 0.12,
        jump_factor=jump_factor, alpha=alpha, beta=float(np.exp(-0.5 * alpha)),
        coeff_ou=5.0, A=150.0, K=50.0, pi=pi, p0=p0, p1=p1, f0=f0, f1=f1,
        theta=0.12, C=80.0, S0=0.0, h1=0.0, h2=600.0, sig0=0.1, sig=0.3,
        alpha_target=-0.2, jump_model=jump_model, coeff_equi=coeff_equi,
    )
