"""The linear-quadratic MFG oracle (eval/mfg_lq_oracle.py).

With f0 = f1 = 0 the smart-grid FBSDE (MFGModel.py:83-98) is linear, so
Y0_hat / Y0 are exactly computable — the first independent MFG accuracy
truth in the framework.  These tests validate the
oracle against the MODEL'S OWN control/dynamics code (not a re-derivation):
with zero noise every recursion is affine, so a zero-noise rollout through
``SmartGridMFGModel.step`` / ``calpha_hat`` / ``calpha`` IS the mean
system, and the oracle's trajectories must reproduce it and close the
backward consistency hY_N = g(hS_N).  The independent *stochastic* check
(the MC Picard warm start converging to the oracle value) lives in the
``full`` tier; the trained-scheme gates live in the chip gate matrix
(scripts/convergence_gates.py, mfg_lq_* rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfbsdejsolvers_tpu.eval.mfg_lq_oracle import solve_lq
from deepfbsdejsolvers_tpu.models.mfg_smart_grid import make_mfg_default


@pytest.fixture(scope="module")
def lq_model():
    return make_mfg_default(f0=0.0, f1=0.0)


@pytest.fixture(scope="module")
def oracle(lq_model):
    return solve_lq(lq_model)


def test_rejects_non_lq_model():
    with pytest.raises(ValueError, match="f0 = f1 = 0"):
        solve_lq(make_mfg_default())


def test_y0_identity(oracle):
    # In the LQ corner the full mean system reduces exactly to the hat
    # system (substituting Y = hY makes (e_full + Y)/(A+K) equal
    # (e_hat + hY)/k_hat because k_hat = A + (1-pi)*ce*p1 + K), so the
    # two independently-solved TPBVPs must agree to f64 rounding.
    assert abs(oracle.y0 - oracle.y0_hat) < 1e-10 * abs(oracle.y0_hat)


def test_oracle_magnitude(oracle):
    # f1 = 1e4 contributes only a few units to the default config's
    # consensus values (-44.8..-48.7); the LQ corner must land nearby.
    assert -60.0 < oracle.y0_hat < -35.0


def test_zero_noise_rollout_matches_oracle(lq_model, oracle):
    """Roll the MODEL's step/controls with zero noise, feeding hY/Y from
    the oracle tables: the produced hS/S trajectories must match the
    oracle's and the terminal condition hY_N = g(hS_N) must close."""
    model, n = lq_model, lq_model.N
    state = model.init_state(1)
    hy_tab = jnp.asarray(oracle.mean_hy, jnp.float32)
    y_tab = jnp.asarray(oracle.mean_y, jnp.float32)
    zero = jnp.zeros((1,), jnp.float32)
    hs_traj, s_traj = [float(state.hS[0])], [float(state.S[0])]
    # forward-integrate the hat BSDE alongside: hY_{i+1} = hY_i - C hS_i dt
    hy = jnp.full((1,), oracle.y0_hat, jnp.float32)
    for i in range(n):
        ones = jnp.ones((1,), jnp.float32)
        hy = hy - model.dt * model.f(state.hS)
        state = model.step(state, zero, zero, zero,
                           hy_tab[i] * ones, y_tab[i] * ones)
        hs_traj.append(float(state.hS[0]))
        s_traj.append(float(state.S[0]))
    np.testing.assert_allclose(hs_traj, oracle.mean_hs, atol=2e-4)
    np.testing.assert_allclose(s_traj, oracle.mean_s, atol=2e-4)
    # terminal closure of the BSDE the solvers train on
    g_term = float(model.g(state.hS)[0])
    assert abs(float(hy[0]) - g_term) < 2e-2 * abs(g_term)
    # and the zero-noise mean state must also follow the discrete Euler
    # hQ mean the oracle uses (NOT the model's analytic mean_hq_table)
    assert abs(float(state.hQ[0]) - oracle.mean_hq[-1]) < 1e-5


def test_oracle_invariant_to_jump_config(lq_model, oracle):
    # jumps enter the controls only through the f1-gated terms — the LQ
    # value must be independent of the jump model entirely
    import dataclasses

    alt = dataclasses.replace(lq_model, jump_model="constant",
                              jump_factor=12.0)
    alt_oracle = solve_lq(alt)
    assert alt_oracle.y0_hat == oracle.y0_hat


@pytest.mark.full
def test_picard_warm_start_agrees_with_oracle(lq_model, oracle):
    """Independent stochastic validation: the fictitious-play Picard MC
    warm start (solvers/mfg.py, frozen noise, batch 8192) estimates the
    same fixed point the oracle solves exactly — agreement to MC
    resolution validates both against each other."""
    from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver

    solver = MFGSolver(lq_model, "global")
    params = solver.init_params(jax.random.key(0))
    warm = solver.warm_start_y0(params, jax.random.key(7), batch=8192,
                                n_picard=24)
    rel = abs(float(warm["hat"]["y0"]) - oracle.y0_hat) / abs(oracle.y0_hat)
    rel_full = abs(float(warm["full"]["y0"]) - oracle.y0) / abs(oracle.y0)
    assert rel < 2e-2, (float(warm["hat"]["y0"]), oracle.y0_hat)
    assert rel_full < 2e-2, (float(warm["full"]["y0"]), oracle.y0)
