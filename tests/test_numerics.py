"""ops/numerics: the bias-free multiplicative-walk update.

The module exists because a device's f32 exp can be biased near 0, and the
bias compounds over a multiplicative walk (ops/numerics.py docstring).  CPU
f32 exp is correctly rounded, so these tests pin the *polynomial's own*
accuracy/bias floor and the API contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfbsdejsolvers_tpu.ops.numerics import (_TAYLOR_CUT, expm1_acc,
                                                mul_exp)


def test_expm1_acc_pointwise_vs_f64():
    # dense grid across both branches, incl. the cut boundary
    u = np.concatenate([
        np.linspace(-0.5, 0.5, 40001),
        np.array([-_TAYLOR_CUT, _TAYLOR_CUT, 0.0, 1e-8, -1e-8, 2.0, -2.0]),
    ]).astype(np.float32)
    got = np.asarray(expm1_acc(jnp.asarray(u)), np.float64)
    truth = np.expm1(u.astype(np.float64))
    # relative to the FACTOR 1+expm1 (what the walk multiplies by)
    rel = (got - truth) / (1.0 + truth)
    assert np.max(np.abs(rel)) < 5e-7


def test_expm1_acc_unbiased_under_increment_laws():
    """Mean factor defect under the shipped increment laws — the quantity
    that compounds N-fold in the walk — stays at the e-8 rounding floor."""
    rng = np.random.default_rng(0)
    b = 1 << 20
    for n, law in [(240, "vg"), (1600, "merton")]:
        dt = 1.0 / n
        if law == "vg":
            kappa, theta, sigj, r = 0.1, -0.1, 0.2, 0.1
            corr = -np.log(1 - theta * kappa - 0.5 * kappa * sigj**2) / kappa
            g = rng.gamma(dt / kappa, kappa, b)
            u = (r - corr) * dt + theta * g + sigj * np.sqrt(g) \
                * rng.standard_normal(b)
        else:
            r, sig, lam, sigj = 0.1, 0.3, 3.0, 0.2
            kbar = np.exp(0.5 * sigj**2) - 1
            dn = rng.poisson(lam * dt, b)
            u = ((r - 0.5 * sig**2 - lam * kbar) * dt
                 + sig * np.sqrt(dt) * rng.standard_normal(b)
                 + sigj * np.sqrt(dn) * rng.standard_normal(b))
        u32 = u.astype(np.float32)
        got = np.asarray(expm1_acc(jnp.asarray(u32)), np.float64)
        truth = np.exp(u32.astype(np.float64))
        defect = np.mean((1.0 + got - truth) / truth)
        # walk-compounded bound: N * |defect| far below the 1e-3 gates
        assert n * abs(defect) < 2e-5, (law, n, defect)


def test_mul_exp_matches_x_exp_u():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(0.5, 2.0, 4096).astype(np.float32))
    u = jnp.asarray((rng.standard_normal(4096) * 0.05).astype(np.float32))
    got = mul_exp(x, u)
    ref = x * jnp.exp(u)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=3e-6)


def test_mul_exp_gradients():
    x0, u0 = 1.3, 0.04
    gx, gu = jax.grad(lambda x, u: mul_exp(x, u), argnums=(0, 1))(
        jnp.float32(x0), jnp.float32(u0))
    assert np.isclose(float(gx), np.exp(u0), rtol=1e-5)          # d/dx = e^u
    assert np.isclose(float(gu), x0 * np.exp(u0), rtol=1e-5)     # d/du = x e^u
    # large-|u| branch is differentiable too
    gu2 = jax.grad(lambda u: mul_exp(jnp.float32(1.0), u))(jnp.float32(1.5))
    assert np.isclose(float(gu2), np.exp(1.5), rtol=1e-5)


@pytest.mark.parametrize("model_name", ["merton", "vg"])
def test_model_step_uses_unbiased_update(model_name):
    """model.step's realized multiplicative factor must match f64 exp of the
    log-increment to the polynomial floor (catches a regression back to
    x*exp(u))."""
    import dataclasses
    if model_name == "merton":
        from deepfbsdejsolvers_tpu.models.merton import make_merton_default
        model = dataclasses.replace(make_merton_default(a_lin=0.0), N=1600)
    else:
        from deepfbsdejsolvers_tpu.models.variance_gamma import \
            make_vg_default
        model = dataclasses.replace(make_vg_default(a_lin=0.0), N=960)
    b = 1 << 16
    key = jax.random.key(3)
    kd, kj = jax.random.split(key)
    x = model.init_x(b)
    j = model.sample_jumps(kj, x.shape)
    y = jnp.zeros_like(x)
    if model_name == "merton":
        dw = jnp.sqrt(model.dt) * jax.random.normal(kd, x.shape, jnp.float32)
        x_new = model.step(0, x, dw, j, y, price=jnp.zeros_like(x))
        u = model.uncoupled_log_increments(dw, j)
    else:
        x_new = model.step(0, x, j, y, price=jnp.zeros_like(x))
        u = model.uncoupled_log_increments(jnp.zeros_like(x), j)
    truth = np.asarray(x, np.float64) * np.exp(np.asarray(u, np.float64))
    defect = np.mean((np.asarray(x_new, np.float64) - truth) / truth)
    assert model.N * abs(defect) < 2e-5, defect
