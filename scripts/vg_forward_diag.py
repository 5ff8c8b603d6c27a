#!/usr/bin/env python
"""Separate the two candidate causes of the VG N=960 error rise
(round 4, ``git show 1858ddd:BASELINE.md``: all seeds biased LOW at Y0 ~ 0.1315 vs
oracle 0.133141, refuted hoisted-table attribution).

Structural fact this instrument exploits: VG is a Levy process, so the
uncoupled discretized forward X_N = x0 * exp(sum of N iid exact VG dt-increments
+ N*(r-omega)*dt) has EXACTLY the T-law at every N (pricingModels.py:184-191
increments are exact draws, not Euler approximations); and on the true BSDE
solution Y = A(t, X) the coupling term func(Y - A) * dt vanishes identically,
so the coupled SDE's true law equals the uncoupled law.  Therefore:

* if the training-free uncoupled MC price at N=960 is biased LOW by ~1.5e-3
  -> the forward SAMPLER's numerics at tiny gamma shape (dt/kappa ~ 0.01)
  are the cause (candidate a);
* if it matches the FFT oracle to MC noise at every N -> the forward law is
  exact and the rise is an OPTIMIZATION/budget effect of training a
  960-step scan (candidate b).

A sharper instrument than the walk: ``--mode moment`` measures the realized
per-step increment moments directly — E[G] (= dt), E[J] (= theta*dt) and the
exponential moment E[e^J] (= e^{omega*dt} by the martingale correction) — per
sampler and per shape dt/kappa, over 2^29 draws.  If the realized E[e^J]
carries a relative defect eps, the uncoupled forward mean compounds it as
E[X_N] = x0*e^{rT}*(1+eps)^N, so the price bias prediction is
Delta * x0 * e^{rT} * N * eps (Delta ~ 0.66 at the VG default) — testable
against the walk cells.

Usage: python scripts/vg_forward_diag.py [--paths-log2 24] [--seeds 4]
       [--mode walk|moment] [--x64] (x64: CPU-friendly smaller batch)
"""

import argparse
import dataclasses
import json
import sys

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--paths-log2", type=int, default=24)
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--n", nargs="*", type=int, default=[30, 240, 960])
    p.add_argument("--samplers", nargs="*", default=["exact", "icdf"])
    p.add_argument("--mode", choices=["walk", "moment", "chain"], default="walk")
    p.add_argument("--update", choices=["exp", "mul_exp"], default="exp",
                   help="walk mode step arithmetic: the biased x*exp(u) "
                        "(diagnostic baseline) or the shipped "
                        "ops.numerics.mul_exp fix")
    p.add_argument("--chunks", type=int, default=128,
                   help="moment mode: number of 2^(paths_log2) draw chunks")
    p.add_argument("--x64", action="store_true",
                   help="run the whole diagnostic in float64 (isolates f32 "
                        "rounding in the sampler / the multiplicative walk)")
    args = p.parse_args()

    if args.x64:
        import jax
        jax.config.update("jax_enable_x64", True)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

    ftype = jnp.float64 if args.x64 else jnp.float32
    batch = 2 ** args.paths_log2

    if args.mode == "moment":
        run_moment(args, batch)
        return
    if args.mode == "chain":
        run_chain(args, batch)
        return

    results = {}
    for sampler in args.samplers:
        for n in args.n:
            model = dataclasses.replace(
                make_vg_default(a_lin=0.0, jump_sampler=sampler), N=n)
            oracle = model.price_at_origin()

            @jax.jit
            def price_mc(key, model=model):
                def body(x, i):
                    j = model.sample_jumps(jax.random.fold_in(key, i), x.shape)
                    # uncoupled: coupling(y - a) == 0 on the true solution
                    u = (model.r - model.correction) * model.dt + j
                    if args.update == "mul_exp":
                        from deepfbsdejsolvers_tpu.ops.numerics import mul_exp
                        x = mul_exp(x, u)
                    else:
                        x = x * jnp.exp(u)
                    return x, None

                x0 = jnp.full((batch,), model.x0, ftype)
                x, _ = jax.lax.scan(body, x0, jnp.arange(model.N))
                pay = jnp.maximum(x - model.K, 0.0)
                disc = jnp.exp(jnp.asarray(-model.r * model.T, ftype))
                # E[X_N] = x0 * exp(r T) exactly (discounted X is a
                # martingale by the omega correction) — an analytic,
                # payoff-free probe of the realized jump law's exponential
                # moment.
                return (disc * jnp.mean(pay), disc * jnp.std(pay) / np.sqrt(batch),
                        jnp.mean(x))

            vals, ses, mart = [], [], []
            for s in range(args.seeds):
                v, se, m = price_mc(jax.random.key(7000 + s))
                vals.append(float(v))
                ses.append(float(se))
                mart.append(float(m))
            vals = np.asarray(vals)
            mart_target = model.x0 * float(np.exp(model.r * model.T))
            rec = {
                "sampler": sampler, "N": n, "oracle": oracle,
                "update": args.update,
                "mc_mean": float(vals.mean()),
                "bias": float(vals.mean() - oracle),
                "se_of_mean": float(ses[0] / np.sqrt(args.seeds)),
                "seed_std": float(vals.std()),
                "martingale_defect": float(np.mean(mart) - mart_target),
                "paths": batch * args.seeds,
                "dtype": "f64" if args.x64 else "f32",
            }
            results[f"{sampler}_n{n}"] = rec
            print(json.dumps(rec), flush=True)

    print(json.dumps({"all": results}), flush=True)


def run_chain(args, batch):
    """Separate cross-step increment correlation from per-step multiplicative
    f32 arithmetic.  One scan, the walk's EXACT key schedule, two carries:

    * x32  — the walk's multiplicative update x*exp(c+j), f32 per step;
    * s32  — the f32 running sum of (c+j), exponentiated ONCE at the end
             (with expm1, so the terminal mean accumulates precisely).

    E[e^{sum}] = e^{rT}/x0-normalized target for BOTH if increments are
    independent.  x32 biased but s32 clean -> the per-step exp/multiply
    arithmetic; both biased -> the joint law (PRNG stream correlation).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

    results = {}
    for sampler in args.samplers:
        for n in args.n:
            model = dataclasses.replace(
                make_vg_default(a_lin=0.0, jump_sampler=sampler), N=n)
            c = (model.r - model.correction) * model.dt

            @jax.jit
            def chain_stats(key, model=model, c=c):
                def body(carry, i):
                    x32, s32 = carry
                    j = model.sample_jumps(jax.random.fold_in(key, i),
                                           x32.shape)
                    x32 = x32 * jnp.exp(jnp.float32(c) + j)
                    s32 = s32 + (jnp.float32(c) + j)
                    return (x32, s32), None

                x0 = jnp.ones((batch,), jnp.float32)
                s0 = jnp.zeros((batch,), jnp.float32)
                (x32, s32), _ = jax.lax.scan(body, (x0, s0),
                                             jnp.arange(model.N))
                em = jnp.expm1(s32)
                return (jnp.mean(x32), jnp.mean(em), jnp.var(em),
                        jnp.var(x32))

            mx = np.zeros(args.seeds, np.float64)
            ms = np.zeros(args.seeds, np.float64)
            for s in range(args.seeds):
                a, b, v, vx = chain_stats(jax.random.key(7000 + s))
                mx[s], ms[s] = float(a), float(b) + 1.0
            target = float(np.exp(model.r * model.T))
            rec = {
                "mode": "chain", "sampler": sampler, "N": n,
                "mult_mart_defect": float(mx.mean() - target),
                "se_mult": float(mx.std() / np.sqrt(args.seeds)),
                "sum_mart_defect": float(ms.mean() - target),
                "se_sum": float(ms.std() / np.sqrt(args.seeds)),
                "paths": batch * args.seeds,
            }
            results[f"{sampler}_n{n}"] = rec
            print(json.dumps(rec), flush=True)

    print(json.dumps({"all": results}), flush=True)


def run_moment(args, batch):
    """Per-step increment moment defects, 2^paths_log2 * chunks draws/cell.

    Chunk sums are f32 on device (XLA tree-reduce rounding is O(eps) of the
    SUM, i.e. ~1e-10 of the mean at 2^20+ draws — far below the target
    resolution); chunk means accumulate in host float64.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

    results = {}
    for sampler in args.samplers:
        for n in args.n:
            model = dataclasses.replace(
                make_vg_default(a_lin=0.0, jump_sampler=sampler), N=n)
            dt = model.dt

            # Sum CENTERED values only: a plain f32 mean of values ~= 1.0
            # rounds at the ~1e-6 level (partial sums reach 1e6 while the
            # signal is 1e-6) — exactly the scale under test.  expm1 keeps
            # every summand at the increment scale (~1e-2), so XLA's f32
            # reduce is accurate to ~1e-9 of the mean; chunk means then
            # accumulate in host float64.
            lam = model.theta + 0.5 * model.sigJ**2

            @jax.jit
            def chunk_stats(key, model=model, lam=lam):
                k_g, k_z = jax.random.split(key)
                z = jax.random.normal(k_z, (batch,), jnp.float32)
                if model.jump_sampler == "icdf":
                    from deepfbsdejsolvers_tpu.ops.piecewise import pw_eval
                    zg = jax.random.normal(k_g, (batch,), jnp.float32)
                    g = jnp.maximum(
                        pw_eval(model._g_coef, zg,
                                jnp.float32(-model.icdf_zmax),
                                jnp.float32(model.icdf_zmax)), 0.0)
                else:
                    g = jax.random.gamma(k_g, model._dt / model.kappa,
                                         (batch,), dtype=jnp.float32) \
                        * model.kappa
                j = model.theta * g + model.sigJ * jnp.sqrt(g) * z
                em_j = jnp.expm1(j)                      # full increment
                em_g = jnp.expm1(jnp.float32(lam) * g)   # Z integrated out
                return (jnp.mean(g), jnp.mean(em_j), jnp.var(em_j),
                        jnp.mean(em_g), jnp.var(em_g))

            mg = np.zeros(args.chunks, np.float64)
            mej = np.zeros(args.chunks, np.float64)
            vej = np.zeros(args.chunks, np.float64)
            meg = np.zeros(args.chunks, np.float64)
            veg = np.zeros(args.chunks, np.float64)
            for c in range(args.chunks):
                a, b, v, d, w = chunk_stats(jax.random.fold_in(
                    jax.random.key(9000 + 7 * n), c))
                mg[c], mej[c], vej[c] = float(a), float(b), float(v)
                meg[c], veg[c] = float(d), float(w)

            n_draws = batch * args.chunks
            # E[e^J] = E[e^{lam*G}] = e^{omega*dt}; both expm1 means share it
            e_ej_target = float(np.expm1(model.correction * dt))
            se_ej = float(np.sqrt(vej.mean() / n_draws))
            se_eg = float(np.sqrt(veg.mean() / n_draws))
            eps = float(mej.mean() - e_ej_target)
            eps_g = float(meg.mean() - e_ej_target)
            rec = {
                "mode": "moment", "sampler": sampler, "N": n,
                "shape": dt / model.kappa,
                "E_G_defect_rel": float(mg.mean() / dt - 1.0),
                "se_E_G_rel": float(mg.std() / np.sqrt(args.chunks) / dt),
                "E_expJ_defect": eps,
                "se_E_expJ": se_ej,
                "sigmas": eps / se_ej if se_ej else 0.0,
                "E_expG_defect": eps_g,      # gamma-law-only exp moment
                "se_E_expG": se_eg,
                "sigmas_g": eps_g / se_eg if se_eg else 0.0,
                "pred_mart_defect_at_N": float(np.exp(model.r * model.T)) * n * eps,
                "draws": n_draws,
            }
            results[f"{sampler}_n{n}"] = rec
            print(json.dumps(rec), flush=True)

    print(json.dumps({"all": results}), flush=True)


if __name__ == "__main__":
    main()
