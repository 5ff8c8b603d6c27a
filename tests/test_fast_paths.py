"""Tests for the speed paths: table pricer, icdf Poisson sampler,
reduced quadrature, bfloat16 compute.  Each fast path must agree with its
reference-parity twin to well inside the 1e-3 Y0 gate."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfbsdejsolvers_tpu.models.merton import make_merton_default
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver


def test_table_pricer_matches_series():
    m_series = make_merton_default()
    m_table = make_merton_default(price_mode="table")
    xs = jnp.asarray(np.linspace(0.3, 3.0, 257), jnp.float32)
    for i in (0, 10, 25, 49):
        a = np.asarray(m_series.price(jnp.asarray(i), xs))
        b = np.asarray(m_table.price(jnp.asarray(i), xs))
        assert np.max(np.abs(a - b)) < 5e-5, i
    assert m_table.price_at_origin() == pytest.approx(
        m_series.price_at_origin(), abs=2e-5)


def test_cheb_pricer_matches_series():
    m_series = make_merton_default()
    m_cheb = make_merton_default(price_mode="chebyshev")
    xs = jnp.asarray(np.linspace(0.3, 3.0, 1024), jnp.float32)
    # ~1e-6 away from expiry; the last step (tau = dt) develops the payoff
    # kink at the strike and degrades to ~1.4e-4 — still 7x under the 1e-3
    # Y0 gate, and it enters the drift only through aLin*|Y-A|*dt.
    for i, tol in ((0, 1e-5), (25, 1e-5), (49, 5e-4)):
        a = np.asarray(m_series.price(jnp.asarray(i), xs))
        b = np.asarray(m_cheb.price(jnp.asarray(i), xs))
        assert np.max(np.abs(a - b)) < tol, i
    # small batches fall back to the exact series
    small = jnp.asarray([1.0, 1.1], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(m_cheb.price(jnp.asarray(5), small)),
        np.asarray(m_series.price(jnp.asarray(5), small)), rtol=1e-6)


def test_vg_cheb_price_eval_matches_direct():
    from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

    vg_d = make_vg_default()
    vg_c = make_vg_default()
    object.__setattr__(vg_c, "price_eval", "chebyshev")
    xs = jnp.asarray(np.linspace(0.4, 2.5, 1024), jnp.float32)
    # Pure-jump VG has almost no diffusion smoothing, so the payoff kink at
    # the strike is sharp at tau = dt and collocation degrades to ~1.7e-3
    # there (vs ~1.5e-5 elsewhere) — which is why price_eval stays "direct"
    # by default for VG and "chebyshev" is an opt-in.
    for i, tol in ((0, 5e-5), (15, 5e-5), (29, 3e-3)):
        a = np.asarray(vg_d.price(jnp.asarray(i), xs))
        b = np.asarray(vg_c.price(jnp.asarray(i), xs))
        assert np.max(np.abs(a - b)) < tol, i


def test_vg_icdf_gamma_sampler_matches_law(rng_key):
    """The iCDF subordinator sampler (G = kappa*GammaQuantile(Phi(z)) via a
    host-precomputed piecewise-Chebyshev table) draws the same VG increment
    law as jax.random.gamma's rejection sampler: two-sample KS cannot tell
    them apart at 2e5 samples, and the first three moments agree."""
    from scipy import stats

    from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

    n = 200_000
    # independent keys: with a shared key the two samplers reuse the same
    # normal draws, correlating the samples and voiding ks_2samp's null
    k_icdf, k_exact = jax.random.split(rng_key)
    j_icdf = np.asarray(make_vg_default(jump_sampler="icdf").sample_jumps(
        k_icdf, (n,)))
    j_exact = np.asarray(make_vg_default().sample_jumps(k_exact, (n,)))
    assert j_icdf.mean() == pytest.approx(j_exact.mean(), abs=4e-4)
    assert j_icdf.std() == pytest.approx(j_exact.std(), rel=2e-2)
    assert stats.skew(j_icdf) == pytest.approx(stats.skew(j_exact), abs=0.15)
    assert stats.ks_2samp(j_icdf, j_exact).pvalue > 1e-3


def test_vg_icdf_gamma_table_fit_error():
    """The (16, 7) quantile table matches scipy's gamma ppf to ~1.6e-5 sup
    in f32 over |z| <= 5.4 (f64 fit error 2.4e-7; the rest is pw_eval's f32
    rounding), and the sampler's negativity clamp only ever absorbs
    O(1e-9)-deep fit wiggle."""
    from scipy.special import ndtr
    from scipy.stats import gamma as sp_gamma

    from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default
    from deepfbsdejsolvers_tpu.ops.piecewise import pw_eval

    m = make_vg_default(jump_sampler="icdf")
    z = np.linspace(-5.4, 5.4, 20001)
    g_fit = np.asarray(pw_eval(m._g_coef, jnp.asarray(z, jnp.float32),
                               jnp.float32(-m.icdf_zmax),
                               jnp.float32(m.icdf_zmax)))
    g_true = sp_gamma.ppf(ndtr(z), m._dt / m.kappa) * m.kappa
    assert np.abs(g_fit - g_true).max() < 5e-5
    assert g_fit.min() > -1e-6  # pre-clamp wiggle stays negligible


@pytest.mark.full  # covered end-to-end by the vg_speed gate smoke
def test_vg_icdf_speed_config_trains(rng_key):
    """End-to-end: the VG speed stack with the iCDF subordinator sampler
    (bench.py --model vg) reduces the loss from init."""
    import dataclasses

    from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default
    from deepfbsdejsolvers_tpu.solvers.train import fit

    m = dataclasses.replace(make_vg_default(jump_sampler="icdf"),
                            price_eval="chebyshev")
    solver = PricingSolver(
        m, "global",
        compensator=CompensatorSpec(kind="quadrature", x_interp="chebyshev",
                                    n_cheb=64),
        hoist=True, hoist_interp="piecewise")
    params = solver.init_params(jax.random.key(0))
    loss_eval = jax.jit(solver.build_loss(2048))
    k_fixed = jax.random.key(9)
    before = float(loss_eval(params, k_fixed))
    res = fit(loss_fn=solver.build_loss(256), params=params,
              key=rng_key, lrate=5e-3, num_epoch=30, num_epoch_ext=2,
              y0_fn=solver.y0_estimate, verbose=False)
    after = float(loss_eval(res.params, k_fixed))
    assert after < before
    assert np.isfinite(res.y0_history[-1])


def test_table_pricer_differentiable():
    m = make_merton_default(price_mode="table")
    g = jax.grad(lambda x: m.price(jnp.asarray(5), x[None])[0])(jnp.float32(1.0))
    # delta of a call in (0, 1), roughly ndtr(d1)-ish here
    assert 0.1 < float(g) < 1.5


def test_icdf_sampler_matches_poisson_law(rng_key):
    m = make_merton_default(jump_sampler="icdf")
    j = np.asarray(m.sample_jumps(rng_key, (400_000,)))
    lam_dt = 3.0 * m.dt
    assert abs(j.mean() - 0.0) < 4e-4
    assert abs(j.var() - lam_dt * 0.04) < 4e-4
    assert abs((j == 0).mean() - math.exp(-lam_dt)) < 2e-3


def test_reduced_quadrature_loss_agrees(rng_key):
    """The (3,5) 16-node rule matches the (6,8) 49-node rule at the loss
    level far below the 1e-3 gate (tail mass P(k>3 | lam*dt=0.06) ~ 1e-6)."""
    m = make_merton_default()
    losses = {}
    for tag, spec in (("full", CompensatorSpec()),
                      ("fast", CompensatorSpec(n_poisson_max=3, n_hermite=5))):
        solver = PricingSolver(m, "global", compensator=spec)
        params = solver.init_params(jax.random.key(0))
        losses[tag] = float(jax.jit(solver.build_loss(4096))(params, rng_key))
    assert losses["fast"] == pytest.approx(losses["full"], abs=2e-4)


def test_bf16_compute_loss_agrees(rng_key):
    m = make_merton_default()
    losses = {}
    for tag, dtype in (("f32", None), ("bf16", "bfloat16")):
        solver = PricingSolver(m, "global", compute_dtype=dtype)
        params = solver.init_params(jax.random.key(0))
        losses[tag] = float(jax.jit(solver.build_loss(4096))(params, rng_key))
    # bf16 matmuls in f32-accum: loss agrees to ~1e-3 relative
    assert losses["bf16"] == pytest.approx(losses["f32"], rel=5e-3)


@pytest.mark.full  # covered end-to-end by the merton_speed gate smoke
def test_fast_config_trains(rng_key):
    """End-to-end: the full speed stack (table pricer + icdf sampler + 16-node
    quadrature + bf16) still reduces the loss and moves Y0 toward the oracle."""
    from deepfbsdejsolvers_tpu.solvers.train import fit

    m = make_merton_default(price_mode="table", jump_sampler="icdf")
    solver = PricingSolver(
        m, "global", compute_dtype="bfloat16",
        compensator=CompensatorSpec(n_poisson_max=3, n_hermite=5))
    params = solver.init_params(jax.random.key(0))
    loss_eval = jax.jit(solver.build_loss(2048))
    k_fixed = jax.random.key(9)
    before = float(loss_eval(params, k_fixed))
    res = fit(loss_fn=solver.build_loss(256), params=params,
              key=rng_key, lrate=5e-3, num_epoch=30, num_epoch_ext=2,
              y0_fn=solver.y0_estimate, verbose=False)
    after = float(loss_eval(res.params, k_fixed))
    assert after < before
    assert np.isfinite(res.y0_history[-1])


def test_piecewise_interp_accuracy():
    """ops/piecewise.py: the 8x7 piecewise local-Chebyshev fit matches
    smooth functions to ~1e-4 sup over the sampled range, and grads flow."""
    from deepfbsdejsolvers_tpu.ops.piecewise import pw_interp_1d

    x = jnp.asarray(np.random.RandomState(0).uniform(0.3, 3.0, 4096),
                    jnp.float32)
    for f in (jnp.exp, lambda v: jnp.tanh(2 * v) + 0.3 * jnp.sin(3 * v)):
        approx = pw_interp_1d(f, x, 8, 7)
        assert float(jnp.max(jnp.abs(approx - f(x)))) < 2e-4
    g = jax.grad(lambda xx: jnp.sum(pw_interp_1d(jnp.exp, xx, 8, 7)))(x)
    assert bool(jnp.all(jnp.isfinite(g)))


def test_piecewise_exact_at_own_nodes():
    """fit+eval are inverse to f32 roundoff at the sample nodes — the
    property the local Chebyshev basis buys (the monomial inverse
    Vandermonde carried condition ~257 at degree 7, a ~3e-5 absolute f32
    floor this assertion would catch)."""
    from deepfbsdejsolvers_tpu.ops.piecewise import (pw_eval, pw_fit,
                                                     pw_nodes)

    lo, hi = jnp.float32(0.3), jnp.float32(3.0)
    xn = pw_nodes(lo, hi, 8, 7)
    vals = jnp.exp(xn)
    coef = pw_fit(vals, 8, 7)
    at_nodes = pw_eval(coef, xn, lo, hi)
    assert float(jnp.max(jnp.abs(at_nodes - vals))) < 1e-5 * float(
        jnp.max(jnp.abs(vals)))


def test_piecewise2d_interp_accuracy():
    """ops/piecewise.py pw2_*: the tensor-product Chebyshev-basis fit matches
    smooth 2-D functions on the sampled box and reproduces its own sample
    nodes to fp roundoff (the monomial basis cannot do this: the two fit
    conditionings MULTIPLY, ~5e3 * f32 eps — see _pw_cheb_fit)."""
    from deepfbsdejsolvers_tpu.ops.piecewise import pw2_eval, pw2_fit, pw2_nodes

    px, dx, pj, dj = 8, 7, 4, 4
    lo, hi = jnp.float32(0.3), jnp.float32(3.0)
    jlo, jhi = jnp.float32(-1.0), jnp.float32(1.0)
    f = lambda x, j: jnp.tanh(x + 0.5 * j) + 0.3 * jnp.sin(2 * x) * jnp.cos(
        3 * j) + 0.1 * x * j
    xn, jn = pw2_nodes(lo, hi, jlo, jhi, px, dx, pj, dj)
    vals = f(xn[:, None], jn[None, :])
    coef = pw2_fit(vals, px, dx, pj, dj)
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.uniform(0.3, 3.0, 8192), jnp.float32)
    j = jnp.asarray(rs.uniform(-1.0, 1.0, 8192), jnp.float32)
    approx = pw2_eval(coef, x, j, lo, hi, jlo, jhi, px, dx, pj, dj)
    assert float(jnp.max(jnp.abs(approx - f(x, j)))) < 2e-4
    # exact at its own sample grid (fit+eval are inverse up to roundoff)
    X, J = jnp.meshgrid(xn, jn, indexing="ij")
    at_nodes = pw2_eval(coef, X.ravel(), J.ravel(), lo, hi, jlo, jhi,
                        px, dx, pj, dj)
    assert float(jnp.max(jnp.abs(at_nodes - vals.ravel()))) < 1e-6
    # grads flow through the fitted values
    g = jax.grad(lambda v: jnp.sum(pw2_eval(pw2_fit(v, px, dx, pj, dj), x, j,
                                            lo, hi, jlo, jhi,
                                            px, dx, pj, dj)))(vals)
    assert bool(jnp.all(jnp.isfinite(g)))


@pytest.mark.full  # hoist_gamma is a measured-slower opt-in instrument
def test_hoist_gamma_tables_built_and_toggle(rng_key):
    """hoist_gamma=True (opt-in: measured slower than the in-scan Γ head,
    see the PricingSolver field note) builds the per-step 2-D Γ tables
    ("gc", "jlo", "jhi") for gam-net schemes and removes the in-scan Γ-MLP;
    the default leaves them off.  The loss equality with the direct path is
    covered by test_hoisted_loss_matches_inscan (whose hoist leg opts in)."""
    m = make_merton_default(jump_sampler="icdf", price_mode="chebyshev")
    spec = CompensatorSpec(x_interp="chebyshev", n_cheb=64)
    on = PricingSolver(m, "global", compensator=spec, hoist=True,
                       hoist_interp="piecewise", hoist_gamma=True)
    off = PricingSolver(m, "global", compensator=spec, hoist=True,
                        hoist_interp="piecewise")
    params = on.init_params(jax.random.key(0))
    noise = on._prenoise(rng_key, 64)
    t_on = on._hoist_tables(params, noise)
    t_off = off._hoist_tables(params, noise)
    assert {"gc", "jlo", "jhi"} <= set(t_on)
    assert not ({"gc", "jlo", "jhi"} & set(t_off))
    # 1-net schemes (Γ via the UZ net) have no gam net to collocate
    one_net = PricingSolver(m, "multistep1", compensator=spec, hoist=True,
                            hoist_interp="piecewise", hoist_gamma=True)
    t1 = one_net._hoist_tables(one_net.init_params(jax.random.key(1)), noise)
    assert "gc" not in t1
    # both paths produce finite, close losses
    l_on = float(jax.jit(on.build_loss(256))(params, rng_key))
    l_off = float(jax.jit(off.build_loss(256))(params, rng_key))
    assert np.isfinite(l_on) and np.isfinite(l_off)
    assert l_on == pytest.approx(l_off, rel=5e-4)


# quick keeps ONE representative (the shipped piecewise-global config);
# the full equality matrix runs in the default/full tier (equality tests
# don't need to dominate the fast CI tier).
@pytest.mark.parametrize("scheme,interp", [
    pytest.param("global", "piecewise"),
    pytest.param("global", "clenshaw", marks=pytest.mark.full),
    pytest.param("multistep1", "clenshaw", marks=pytest.mark.full),
    pytest.param("multistep1", "piecewise", marks=pytest.mark.full),
    pytest.param("sumlocal2", "clenshaw", marks=pytest.mark.full),
    pytest.param("sumlocal2", "piecewise", marks=pytest.mark.full),
])
def test_hoisted_loss_matches_inscan(rng_key, scheme, interp):
    """The hoisted per-step collocation tables (intervals from the uncoupled
    marginals, comp/pricer/Z tables computed before the scan) reproduce the
    in-scan collocated loss and gradients."""
    # N=20: the hoisted tables are built per step, so equality at N=20
    # covers the mechanism; production-N compiles belong to the full tier.
    m = dataclasses.replace(
        make_merton_default(jump_sampler="icdf", price_mode="chebyshev"), N=20)
    spec = CompensatorSpec(x_interp="chebyshev", n_cheb=64)
    vals, grads = {}, {}
    for tag, kw in (("base", {}),
                    ("hoist", dict(hoist=True, hoist_interp=interp,
                                   hoist_gamma=True))):
        solver = PricingSolver(m, scheme, compensator=spec, **kw)
        params = solver.init_params(jax.random.key(0))
        loss, grad = jax.value_and_grad(jax.jit(solver.build_loss(512)))(
            params, rng_key)
        vals[tag], grads[tag] = float(loss), grad
    assert vals["hoist"] == pytest.approx(vals["base"], rel=1e-4)
    fa, _ = jax.flatten_util.ravel_pytree(grads["base"])
    fb, _ = jax.flatten_util.ravel_pytree(grads["hoist"])
    rel = float(jnp.linalg.norm(fa - fb) / jnp.linalg.norm(fa))
    assert rel < 5e-3


@pytest.mark.parametrize("scheme,chunk", [
    pytest.param("global", 2),  # the shipped chunk — quick representative
    pytest.param("global", 5, marks=pytest.mark.full),
    pytest.param("global", 7, marks=pytest.mark.full),
    pytest.param("multistep1", 2, marks=pytest.mark.full),
    pytest.param("multistep1", 5, marks=pytest.mark.full),
    pytest.param("multistep1", 7, marks=pytest.mark.full),
])
def test_scan_chunk_matches_flat_scan(rng_key, scheme, chunk):
    """Chunked time scan (outer scan over N/k blocks of k unrolled steps,
    rematerialized per chunk — the shipped speed default is scan_chunk=2)
    computes the SAME math as the flat lax.scan: same per-step xs rows, same
    RNG stream, only the loop structure changes.  Loss and gradients must
    match at fixed params.  chunk=7 exercises the non-divisor fallback
    (k reduces to the largest divisor of N <= k, here 5 for N=50)."""
    m = make_merton_default(jump_sampler="icdf", price_mode="chebyshev")
    spec = CompensatorSpec(x_interp="chebyshev", n_cheb=64)
    vals, grads = {}, {}
    for tag, k in (("flat", 0), ("chunk", chunk)):
        solver = PricingSolver(m, scheme, compensator=spec, hidden=(8, 8),
                               hoist=True, hoist_interp="piecewise",
                               scan_chunk=k)
        params = solver.init_params(jax.random.key(0))
        loss, grad = jax.value_and_grad(jax.jit(solver.build_loss(128)))(
            params, rng_key)
        vals[tag], grads[tag] = float(loss), grad
    assert vals["chunk"] == pytest.approx(vals["flat"], rel=1e-6)
    fa, _ = jax.flatten_util.ravel_pytree(grads["flat"])
    fb, _ = jax.flatten_util.ravel_pytree(grads["chunk"])
    rel = float(jnp.linalg.norm(fa - fb) / jnp.linalg.norm(fa))
    assert rel < 1e-5


@pytest.mark.parametrize("scheme,chunk", [
    pytest.param("global", 16),  # the shipped chunk — quick representative
    pytest.param("global", 2, marks=pytest.mark.full),
    pytest.param("sumlocal", 2, marks=pytest.mark.full),
    pytest.param("sumlocal", 16, marks=pytest.mark.full),
])
def test_mfg_scan_chunk_matches_flat_scan(rng_key, scheme, chunk):
    """MFG twin of the scan-chunk equality test: the chunked MFG training
    scan (shipped speed default scan_chunk=16 for the N=96 system — bench.py
    --model mfg) computes the same math as the flat scan at fixed params.
    Exact on CPU; on an accelerator only XLA's cross-step fusion
    reassociation differs (observed ~1e-7 rel on the loss)."""
    import dataclasses

    from deepfbsdejsolvers_tpu.models.mfg_smart_grid import make_mfg_default
    from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver

    # 1-day profile (N=48, still divisible by the shipped chunk=16):
    # equality doesn't need the production N=96 scan.
    m = dataclasses.replace(make_mfg_default(nb_days=1), jump_sampler="icdf")
    vals, grads = {}, {}
    for tag, k in (("flat", 0), ("chunk", chunk)):
        solver = MFGSolver(m, scheme, hidden_hat=(8, 8), hidden=(8, 8),
                           scan_chunk=k)
        params = solver.init_params(jax.random.key(0))
        loss, grad = jax.value_and_grad(
            jax.jit(solver.build_losses(128)["coupled"]))(params, rng_key)
        vals[tag], grads[tag] = float(loss), grad
    assert vals["chunk"] == pytest.approx(vals["flat"], rel=1e-6)
    fa, _ = jax.flatten_util.ravel_pytree(grads["flat"])
    fb, _ = jax.flatten_util.ravel_pytree(grads["chunk"])
    rel = float(jnp.linalg.norm(fa - fb) / jnp.linalg.norm(fa))
    assert rel < 1e-5


@pytest.mark.full  # fuse_heads is a measured-slower opt-in instrument
@pytest.mark.parametrize("scheme", ["global", "multistep", "sumlocal"])
def test_mfg_fused_heads_match_split(rng_key, scheme):
    """Block-diagonal head fusion (MFGSolver(fuse_heads=True), opt-in —
    measured slower, see the MFGSolver field note) computes the same pair
    loss as
    the split heads: block-diag weights make the two MLPs independent, so
    losses are bit-exact and grads differ only by backward dot order."""
    import dataclasses

    from deepfbsdejsolvers_tpu.models.mfg_smart_grid import make_mfg_default
    from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver

    m = dataclasses.replace(make_mfg_default(), jump_sampler="icdf")
    vals, grads = {}, {}
    for tag, fuse in (("split", False), ("fused", True)):
        solver = MFGSolver(m, scheme, fuse_heads=fuse)
        params = solver.init_params(jax.random.key(0))
        loss, grad = jax.value_and_grad(
            jax.jit(solver.build_losses(64)["coupled"]))(params, rng_key)
        vals[tag], grads[tag] = float(loss), grad
    assert vals["fused"] == pytest.approx(vals["split"], rel=1e-6)
    fa, _ = jax.flatten_util.ravel_pytree(grads["split"])
    fb, _ = jax.flatten_util.ravel_pytree(grads["fused"])
    assert float(jnp.linalg.norm(fa - fb) / jnp.linalg.norm(fa)) < 1e-5


def test_hoisted_mc_compensator_matches_inscan(rng_key):
    """Hoisted tables under the reference-exact MC node law: same per-step
    node draws as the in-scan chebyshev+mc branch (both consume the per-step
    kms keys), so the losses agree to interpolation error."""
    m = make_merton_default(jump_sampler="icdf", price_mode="chebyshev")
    spec = CompensatorSpec(kind="mc", n_mc=200, x_interp="chebyshev",
                           n_cheb=64)
    out = {}
    for tag, kw in (("base", {}),
                    ("hoist", dict(hoist=True, hoist_interp="piecewise"))):
        solver = PricingSolver(m, "global", compensator=spec, **kw)
        params = solver.init_params(jax.random.key(0))
        out[tag] = float(jax.jit(solver.build_loss(512))(params, rng_key))
    assert out["hoist"] == pytest.approx(out["base"], rel=2e-3)


def test_hoist_requires_chebyshev_interp():
    m = make_merton_default()
    with pytest.raises(ValueError):
        PricingSolver(m, "global", hoist=True)


def test_hoist_clamp_fractions_stay_negligible():
    """Validity envelope of the hoist interval policy (pad_frac=0.15 +
    boundary clamp): the per-step fraction of coupled paths clamped outside
    the collocation intervals must stay <1e-3 — including on a deliberately
    heavy-tailed Merton (sigJ=0.5, lam=6, ~4x the default jump variance and
    2x the rate) and across the scheme families' distinct table layouts
    (global BSDE-carried Y, sumlocal shift_next tables).  The intervals are
    built from the EXACT uncoupled marginals of the same pre-drawn noise,
    so only the accumulated coupling drift can escape them — this pins that
    the O(aLin*dt) argument holds, with a diagnostic anyone can rerun on a
    new parameterization (jump law:
    pricingModels.py:57-61)."""
    import dataclasses

    cheb = CompensatorSpec(x_interp="chebyshev", n_cheb=64)
    heavy = dataclasses.replace(
        make_merton_default(jump_sampler="icdf", price_mode="chebyshev"),
        sigJ=0.5, lam=6.0)
    for scheme in ("global", "multistep1", "sumlocal2"):
        solver = PricingSolver(heavy, scheme, compensator=cheb,
                               hoist=True, hoist_interp="piecewise")
        params = solver.init_params(jax.random.key(0))
        fr = solver.hoist_clamp_fractions(params, jax.random.key(1),
                                          batch=4096)
        assert fr.shape == (heavy.N,)
        assert float(fr.max()) < 1e-3, (scheme, float(fr.max()))


def test_hoist_clamp_fractions_requires_hoist():
    solver = PricingSolver(make_merton_default(), "global")
    with pytest.raises(ValueError):
        solver.hoist_clamp_fractions(
            solver.init_params(jax.random.key(0)), jax.random.key(1))
