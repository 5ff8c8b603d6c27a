"""Fixed-common-noise replay and Price-of-Anarchy pipeline.

Rebuilds the *intended* behavior of coupledMFG/MFGSolutions.py and the PoA
sweep of mainMFGPoA.py.  The reference file cannot run as checked in
(undefined ``savefig`` :10, missing ``computeTarget`` called at
mainMFGPoA.py:150, ctor arity mismatch :147); this module implements the
semantics the scripts clearly intend:

* draw ONE frozen noise set (common dW0, per-player dW, jump counts dN) so
  MFG vs aggregate-MFC policies and different players are compared pathwise on
  identical randomness (mainMFGPoA.py:113-121);
* replay trained policies through the forward system recording all processes
  (Q, S, hQ, hS, R, λ, α, α̂ — MFGSolutions.py:23-97), with the Global scheme
  rolling the BSDEs explicitly from Y0 (:42-70) and feedback schemes reading Y
  from the nets each step (:71-92);
* the players' objective functional and its CI (:103-111), the dynamic price
  (:100-101), the α-target (the missing ``computeTarget``), and
  PoA = cost_MFG / cost_MFCagg (mainMFGPoA.py:332-334).

Execution: the replay is one ``lax.scan`` over the frozen arrays — no
per-step host round-trips (the reference drops to numpy every step).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from deepfbsdejsolvers_tpu.models.mfg_smart_grid import SmartGridMFGModel
from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver


class FrozenNoise(NamedTuple):
    """Pre-drawn noise, shapes (B, N+1); dW already includes the sqrt(dt)
    scaling (mainMFGPoA.py:113-115)."""

    dW0: jax.Array
    dW: jax.Array
    dN: jax.Array


def draw_frozen_noise(model: SmartGridMFGModel, key: jax.Array, n_sim: int,
                      n_players: int = 2) -> Tuple[jax.Array, list, jax.Array]:
    """Reproduce the reference pre-draw (mainMFGPoA.py:113-121): dW0 and the
    players' dW are iid N(0, dt); dN is drawn by rolling the model forward
    under the common noise ONLY (controls and idiosyncratic noise zeroed).

    Returns (dW0, [dW_player_1, ..], dN), each (n_sim, N+1).
    """
    n1 = model.N + 1
    sdt = np.sqrt(model.dt)
    k0, kp, kn = jax.random.split(key, 3)
    dw0 = sdt * jax.random.normal(k0, (n_sim, n1), jnp.float32)
    dws = [sdt * jax.random.normal(jax.random.fold_in(kp, i), (n_sim, n1), jnp.float32)
           for i in range(n_players)]

    state0 = model.init_state(n_sim)
    keys = jax.random.split(kn, n1)
    # column 0 is drawn at the initial state; later columns after stepping the
    # projected state forward under dW0 alone (mainMFGPoA.py:117-121).
    dn0, _ = model.sample_dN(keys[0], state0)
    state = state0

    def body2(state, inp):
        i, key_col = inp
        zero = jnp.zeros((n_sim,), jnp.float32)
        state = model.step(state, dw0[:, i], zero, zero, zero, zero)
        dn, _ = model.sample_dN(key_col, state)
        return state, dn

    _, dns = jax.lax.scan(body2, state, (jnp.arange(1, n1), keys[1:]))
    dn = jnp.concatenate([dn0[None], dns], axis=0).T  # (n_sim, N+1)
    return dw0, dws, dn


@dataclasses.dataclass
class MFGFixedTrajectoryEvaluator:
    """Replay a trained policy on frozen noise (MFGSolutions.py semantics)."""

    solver: MFGSolver
    params: dict
    noise: FrozenNoise

    @property
    def model(self) -> SmartGridMFGModel:
        return self.solver.model

    def simulate_all_processes(self, n_sim: int) -> Dict[str, np.ndarray]:
        """Record every process along the frozen paths; arrays (n_sim, N+1)
        except meanhQ (N+1,).  MFGSolutions.py:23-97."""
        model, solver = self.model, self.solver
        n_avail = int(self.noise.dN.shape[0])
        if n_sim > n_avail:
            raise ValueError(
                f"n_sim={n_sim} exceeds the {n_avail} frozen trajectories")
        dW0 = self.noise.dW0[:n_sim].T  # (N+1, B)
        dW = self.noise.dW[:n_sim].T
        dN = self.noise.dN[:n_sim].T
        params = self.params
        is_global = solver.scheme == "global"
        N, dt = model.N, model.dt

        state0 = model.init_state(n_sim)
        ones = jnp.ones((n_sim,), jnp.float32)
        if is_global:
            h_y0 = params["hat"]["y0"] * ones
            y0 = params["full"]["y0"] * ones
        else:
            h_y0 = solver._hat(params, state0)[..., 0]
            y0 = solver._full(params, state0)[..., 0]

        def record(state, h_y, y):
            lam = model.intensity(state)
            return dict(
                Q=state.Q, S=state.S, hQ=state.hQ, hS=state.hS, R=state.R,
                lam=lam,
                alpha_hat=model.calpha_hat(state, h_y),
                alpha=model.calpha(state, h_y, y),
                hY=h_y, Y=y,
            )

        def body(carry, inp):
            state, h_y, y = carry
            i, dw0_i, dw_i, dn_i = inp
            rec = record(state, h_y, y)
            compens = model.intensity(state) * dt
            dpi = dn_i - compens
            if is_global:
                h_out = solver._hat(params, state)
                f_out = solver._full(params, state)
                h_y_next = (h_y - dt * model.f(state.hS)
                            + h_out[..., 0] * dw0_i + h_out[..., 1] * dpi)
                y_next = (y - dt * model.f(state.S) + f_out[..., 0] * dw0_i
                          + f_out[..., 1] * dpi + f_out[..., 2] * dw_i)
            state = model.step(state, dw0_i, dw_i, dn_i, h_y, y)
            if not is_global:
                h_y_next = solver._hat(params, state)[..., 0]
                y_next = solver._full(params, state)[..., 0]
            return (state, h_y_next, y_next), rec

        xs = (jnp.arange(N), dW0[:N], dW[:N], dN[:N])
        (state, h_y, y), recs = jax.lax.scan(body, (state0, h_y0, y0), xs)
        last = record(state, h_y, y)
        out = {k: np.asarray(jnp.concatenate([recs[k], last[k][None]], 0).T)
               for k in last}
        out["meanhQ"] = np.asarray(model.mean_hq_table)
        out["alphaTg"] = self.compute_target(n_sim, out["meanhQ"])
        out["t"] = np.arange(N + 1)
        self.trajectories = out
        return out

    def compute_target(self, n_sim: int, mean_hq: np.ndarray) -> np.ndarray:
        """The α-target trajectory (the reference's missing ``computeTarget``;
        semantics from MFGSolutions.py:93-97 / MFGModel.py:76-79)."""
        if self.model.jump_model == "stochastic":
            return np.broadcast_to(self.model.alpha_target * mean_hq[None, :],
                                   (n_sim, len(mean_hq))).copy()
        return np.full((n_sim, self.model.N + 1), self.model.alpha_target)

    def price(self, pi: float, alpha) -> np.ndarray:
        """Dynamic price p0 + π p1 hQ + (1-π) p1 (hQ + α)
        (MFGSolutions.py:100-101)."""
        hq = self.trajectories["hQ"]
        return (self.model.p0 + pi * self.model.p1 * hq
                + (1 - pi) * self.model.p1 * (hq + alpha))

    def objective_function(self) -> Tuple[float, float]:
        """Players' cost functional mean/std over paths (MFGSolutions.py:103-111)."""
        m = self.model
        tr = self.trajectories
        Q, S, R = tr["Q"], tr["S"], tr["R"]
        a, a_hat = tr["alpha"], tr["alpha_hat"]
        hq, mean_hq, a_tg = tr["hQ"], tr["meanhQ"][None, :], tr["alphaTg"]
        increment = (
            m.A * 0.5 * a**2 + m.C * 0.5 * S**2 + m.K * 0.5 * (Q + a) ** 2
            + (Q + a) * (m.p0 + m.p1 * m.pi * hq
                         + m.p1 * (1 - m.pi) * (hq + a_hat))
            + (R < m.theta) * (Q - mean_hq + a - a_tg)
            * (m.f0 + m.f1 * (hq - mean_hq + a_hat - a_tg))
        )
        cost = (np.sum(increment * m.dt, axis=1)
                + m.h1 * S[:, -1] + m.h2 * 0.5 * S[:, -1] ** 2)
        return float(np.mean(cost)), float(np.std(cost))


def price_of_anarchy(mfg_eval: MFGFixedTrajectoryEvaluator,
                     mfc_eval: MFGFixedTrajectoryEvaluator,
                     n_sim: int) -> Dict[str, float]:
    """PoA = MFG cost / MFCagg cost with 95% CIs (mainMFGPoA.py:322-334)."""
    mfg_eval.simulate_all_processes(n_sim)
    mfc_eval.simulate_all_processes(n_sim)
    mfg_cost, mfg_std = mfg_eval.objective_function()
    mfc_cost, mfc_std = mfc_eval.objective_function()
    half_ci = 1.96 / np.sqrt(n_sim)
    return {
        "mfg_cost": mfg_cost,
        "mfg_ci": half_ci * mfg_std,
        "mfc_cost": mfc_cost,
        "mfc_ci": half_ci * mfc_std,
        "poa": mfg_cost / mfc_cost,
    }
