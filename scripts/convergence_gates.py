#!/usr/bin/env python
"""The accuracy-gate matrix, run on real hardware.

Each gate trains a solver to convergence on the standard budget
(cosine-decayed fit, peak lr over `steps` Adam steps, batch 8192) and
reports |Y0 - oracle| against the model's closed-form/FFT price.
Runs on whatever jax.devices() provides (CPU takes far longer than an
accelerator).  The history of the gate studies behind the budgets and bars
below is in ``git show 1858ddd:BASELINE.md``.

The gate matrix is DATA (``build_registry``) so the pytest smoke tier
(tests/test_gates_smoke.py) can train every config end-to-end at a tiny
budget in CI — a regression in any gate path (e.g. the sumlocal hoist
tables) fails CI instead of waiting for the next manual chip run
(round-4; SURVEY §4 rebuild test plan).

Usage: python scripts/convergence_gates.py [gate ...]
Gates: merton_speed merton_speed_mc merton_direct
       merton_cheb merton_global merton_coupled_direct
       merton_global_extrapolated vg_direct vg_speed vg_coupled_direct
       vg_global_extrapolated vg_half_coupling
       mfg_lq_{global,multistep,sumlocal,sumlocal_reg,multistep_reg}
       mfg_consensus  (or: all)
"""

import argparse
import dataclasses
import json
import sys

sys.path.insert(0, ".")

import jax
import numpy as np

from deepfbsdejsolvers_tpu.models.merton import make_merton_default
from deepfbsdejsolvers_tpu.models.mfg_smart_grid import make_mfg_default
from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
from deepfbsdejsolvers_tpu.solvers.train import fit


def run_gate(name, model, oracle, scheme, batch=8192,
             peak_lr=6e-3, steps=4800, seeds=1, tail=12, warm_y0=False,
             **solver_kw):
    """Train ``seeds`` independent runs and report per-seed + aggregate error.

    Round-2 protocol: one cosine-decayed fit (peak 6e-3 over 4800 steps) with
    a trailing-average Y0 readout — the schedule the gate studies validated
    under the reference's mean-over-steps loss semantics (the round-1
    3-phase constant-lr budget undertrains under that scale).  Single-run
    numbers are NOT reproducible statements at this budget — the coupled
    configs' readouts scatter run-to-run by ~1e-3 — so robust gates use
    seeds >= 3 and report the max (round-2 gate study)."""
    import optax

    solver = PricingSolver(model, scheme, **solver_kw)
    errs, y0s = [], []
    # 400 steps per outer epoch: few host<->device round-trips with the
    # same total budget; the trailing-average window is `tail` outer epochs.
    num_epoch = min(400, steps)
    for seed in range(seeds):
        params = solver.init_params(jax.random.key(seed))
        if warm_y0:
            params = solver.warm_start_y0(params,
                                          jax.random.key(9000 + seed))
        res = fit(loss_fn=solver.build_loss(batch), params=params,
                  key=jax.random.key(1 + 100 * seed),
                  lrate=optax.cosine_decay_schedule(peak_lr, steps),
                  num_epoch=num_epoch, num_epoch_ext=steps // num_epoch,
                  y0_fn=solver.y0_estimate, verbose=False)
        y0 = float(np.mean(res.y0_history[-max(tail // 4, 2):]))
        y0s.append(y0)
        errs.append(abs(y0 - oracle))
    record = {"gate": name, "y0": y0s if seeds > 1 else y0s[0],
              "oracle": oracle, "abs_error": max(errs),
              "mean_error": float(np.mean(errs)),
              "pass_1e-3": max(errs) <= 1e-3}
    print(json.dumps(record), flush=True)
    return record


def run_extrapolated_gate(name, make_model, oracle, compensator, seeds=3,
                          a_lin=0.1, peak_lr=3e-3, steps=2400, tail=12,
                          batch=8192):
    """Richardson-extrapolated coupled-Global gate: per seed, train the
    Global scheme at aLin and aLin/2 (warm Y0 start) and report
    2*Y0(aLin/2) - Y0(aLin) — the coupling-rectification bias is linear in
    aLin (round-2 floor analysis; same structure for Merton and VG), so the
    extrapolation cancels it.  ``make_model(a)`` builds the model at
    coupling strength a."""
    import optax

    errs, y0s = [], []
    num_epoch = min(400, steps)
    for seed in range(seeds):
        pair = []
        for a in (a_lin / 2, a_lin):
            model = make_model(a)
            solver = PricingSolver(model, "global", compensator=compensator)
            params = solver.init_params(jax.random.key(seed))
            params = solver.warm_start_y0(params, jax.random.key(9000 + seed))
            res = fit(loss_fn=solver.build_loss(batch), params=params,
                      key=jax.random.key(1 + 100 * seed),
                      lrate=optax.cosine_decay_schedule(peak_lr, steps),
                      num_epoch=num_epoch, num_epoch_ext=steps // num_epoch,
                      y0_fn=solver.y0_estimate, verbose=False)
            pair.append(float(np.mean(res.y0_history[-max(tail // 4, 2):])))
        y0 = 2.0 * pair[0] - pair[1]
        y0s.append(y0)
        errs.append(abs(y0 - oracle))
    record = {"gate": name, "y0": y0s,
              "oracle": oracle, "abs_error": max(errs),
              "mean_error": float(np.mean(errs)),
              "pass_1e-3": max(errs) <= 1e-3}
    print(json.dumps(record), flush=True)
    return record


def _fit_mfg(solver, batch, key_seed, peak_lr, steps, warm_y0, tail,
             warm_batch=16384):
    """One cosine-decayed coupled fit of an MFGSolver; returns the
    trailing-average (y0_hat, y0) readout and the trained params."""
    import optax

    params = solver.init_params(jax.random.key(key_seed))
    if warm_y0 and solver.scheme == "global":
        params = solver.warm_start_y0(params, jax.random.key(9000 + key_seed),
                                      batch=warm_batch)
    losses = solver.build_losses(batch)
    num_epoch = min(400, steps)
    res = fit(loss_fn=losses["coupled"], params=params,
              key=jax.random.key(1 + 100 * key_seed),
              lrate=optax.cosine_decay_schedule(peak_lr, steps),
              num_epoch=num_epoch, num_epoch_ext=steps // num_epoch,
              y0_fn=solver.y0_estimates, verbose=False)
    window = res.y0_history[-max(tail // 4, 2):]
    y0_hat = float(np.mean([y[0] for y in window]))
    y0 = float(np.mean([y[1] for y in window]))
    return y0_hat, y0, res.params


def run_mfg_lq_gate(name, model, scheme, batch=4096, peak_lr=6e-3,
                    steps=4800, seeds=1, tail=12, warm_y0=False,
                    rel_gate=1e-3, warm_batch=16384, **solver_kw):
    """MFG gate against the EXACT linear-quadratic oracle (the first
    independent MFG accuracy truth).

    With f0 = f1 = 0 the coupled FBSDE is linear and Y0_hat = Y0 is the
    exact solution of a deterministic affine TPBVP
    (eval/mfg_lq_oracle.py); trains ``scheme`` on that model and reports
    |Y0_hat - oracle| and |Y0 - oracle| RELATIVE to |oracle| (oracle
    ~ -48.3 at the comparison profile, vs the pricing oracles' ~0.14 —
    an absolute 1e-3 bar would be 30x tighter than the pricing gates').
    """
    from deepfbsdejsolvers_tpu.eval.mfg_lq_oracle import solve_lq

    oracle = solve_lq(model)
    solver = MFGSolver(model, scheme, **solver_kw)
    scale = abs(oracle.y0_hat)
    y0s, errs = [], []
    for seed in range(seeds):
        y0_hat, y0, _ = _fit_mfg(solver, batch, seed, peak_lr, steps,
                                 warm_y0, tail, warm_batch)
        y0s.append((y0_hat, y0))
        errs.append(max(abs(y0_hat - oracle.y0_hat),
                        abs(y0 - oracle.y0)) / scale)
    record = {"gate": name, "scheme": scheme,
              "y0_pairs": y0s if seeds > 1 else y0s[0],
              "oracle": oracle.y0_hat, "rel_error": max(errs),
              "mean_rel_error": float(np.mean(errs)),
              # cold nets read ~0 at init, so the initial relative error
              # is ~1; the smoke tier asserts progress against this
              "init_rel_error": 1.0,
              f"pass_{rel_gate:g}": max(errs) <= rel_gate}
    print(json.dumps(record), flush=True)
    return record


def run_mfg_consensus_gate(name, model, schemes=("global", "sumlocal"),
                           batch=512, peak_lr=3e-3, steps=6000, tail=12,
                           band_tol=3.0, cost_tol=0.6, cost_batch=65536,
                           seeds=1, warm_batch=16384):
    """Automated version of the manual MFG cross-method consensus run
    (mainMFGComparison.py:148-157 is the reference's
    own instrument): train a warm-started Global plus one feedback scheme
    on the DEFAULT (f1 = 1e4) comparison config at a reduced budget and
    assert (a) the Y0_hat estimates agree within ``band_tol`` (the
    round-4 full-budget four-method band spans −44.8…−47.5), and (b) the
    frozen-noise expected costs (simulate_global_err on a SHARED key =
    identical pre-drawn noise) agree within ``cost_tol`` (full-budget
    spread 33.92–34.40 at CI ±0.03)."""
    results = {}
    for seed in range(seeds):
        for scheme in schemes:
            solver = MFGSolver(model, scheme)
            y0_hat, y0, params = _fit_mfg(
                solver, batch, seed, peak_lr, steps,
                warm_y0=(scheme == "global"), tail=tail,
                warm_batch=warm_batch)
            cost_hat, cost, err = solver.simulate_global_err(
                params, jax.random.key(777), cost_batch)
            results.setdefault(scheme, []).append(
                {"y0_hat": y0_hat, "y0": y0,
                 "cost_hat": float(cost_hat), "cost": float(cost)})
    y0_spread = max(abs(results[a][s]["y0_hat"] - results[b][s]["y0_hat"])
                    for s in range(seeds)
                    for a in schemes for b in schemes)
    cost_spread = max(abs(results[a][s]["cost_hat"] - results[b][s]["cost_hat"])
                      for s in range(seeds)
                      for a in schemes for b in schemes)
    record = {"gate": name, "per_scheme": results,
              "y0_hat_spread": y0_spread, "cost_hat_spread": cost_spread,
              "band_tol": band_tol, "cost_tol": cost_tol,
              "pass": y0_spread <= band_tol and cost_spread <= cost_tol}
    print(json.dumps(record), flush=True)
    return record


def build_registry():
    """The gate matrix as data: name -> {kind: "gate"|"extrapolated",
    args: {...}}.  ``run_entry`` consumes an entry; the pytest smoke tier
    overrides the budget keys (steps/seeds/batch) without touching the
    config keys (model/scheme/solver kwargs)."""
    merton = make_merton_default()
    merton_oracle = merton.price_at_origin()
    vg = make_vg_default()
    vg_oracle = vg.price_at_origin()
    cheb64 = CompensatorSpec(x_interp="chebyshev", n_cheb=64)
    # the round-3 headline speed path: hoisted tables + piecewise evaluator
    speed_kw = dict(compensator=cheb64, hoist=True, hoist_interp="piecewise")

    g = {}
    # The robust speed-config gate: UNcoupled Merton (aLin=0), Global
    # scheme with the warm Y0 start — the round-2 study protocol that
    # passed 5/5 seeds at <= 2.2e-4 (trainable-scalar readout, tight).
    # The aLin=0.1 coupled configs carry an inherent ±(1-3.5)e-3
    # scheme-level deviation at any budget (round-2 floor analysis;
    # removable by aLin extrapolation), and the multistep U(0,x0) net
    # readout has occasional ±3e-3 outlier seeds even uncoupled — both
    # are kept as diagnostics, not hard gates.
    g["merton_speed"] = dict(
        model=make_merton_default(a_lin=0.0, jump_sampler="icdf",
                                  price_mode="chebyshev"),
        oracle=merton_oracle, scheme="global", seeds=3,
        peak_lr=3e-3, steps=2400, warm_y0=True, **speed_kw)
    # The reference-exact MC-5000 compensator LAW through the same
    # hoisted tables (per-step fresh node draws swept at the collocation
    # points instead of the full batch — the round-3 fast exact-law
    # path).
    g["merton_speed_mc"] = dict(
        model=make_merton_default(a_lin=0.0, jump_sampler="icdf",
                                  price_mode="chebyshev"),
        oracle=merton_oracle, scheme="global", seeds=3,
        peak_lr=3e-3, steps=2400, warm_y0=True,
        compensator=CompensatorSpec(kind="mc", n_mc=5000,
                                    x_interp="chebyshev", n_cheb=64),
        hoist=True, hoist_interp="piecewise")
    g["merton_multistep_diag"] = dict(
        model=make_merton_default(a_lin=0.0, jump_sampler="icdf",
                                  price_mode="chebyshev"),
        oracle=merton_oracle, scheme="multistep1", compensator=cheb64,
        seeds=3)
    g["merton_coupled_diag"] = dict(
        model=make_merton_default(jump_sampler="icdf",
                                  price_mode="chebyshev"),
        oracle=merton_oracle, scheme="multistep1", compensator=cheb64,
        seeds=3)
    # DIRECT coupled-Global gate, no extrapolation: the round-3
    # ts-series (scripts/gate_global_study.py n*_ts cells) REFUTED the
    # round-2 "a ~ 1.5e-3 dt->0 floor" — the coupled bias follows the
    # strong-Euler law ~0.027/sqrt(N) (3.69/2.77/2.07/1.61/0.70/0.56 e-3
    # at N = 50/100/200/400/800/1600) and crosses 1e-3 between N=800
    # (predicted 0.96e-3 — AT the gate, per-seed passes are marginal:
    # 3/3 in the study draw, 2/3 under this gate's seed protocol) and
    # N=1600 (predicted 0.68e-3, robustly inside), so the operational
    # gate runs N=1600.  The time feature is rescaled to the N=50 range
    # (time_scale=50/N) so net capacity is not the confound (raw-index
    # features saturate the tanh layer at N>=800).
    # Reference scheme: SolversJumpDiff.py:17-73 at a finer grid than
    # mainMerton's N=50.
    g["merton_coupled_direct"] = dict(
        model=dataclasses.replace(
            make_merton_default(a_lin=0.1, jump_sampler="icdf",
                                price_mode="chebyshev"), N=1600),
        oracle=merton_oracle, scheme="global", seeds=3, peak_lr=3e-3,
        steps=2400, warm_y0=True, time_scale=50.0 / 1600.0, **speed_kw)
    # The VG twin (round-4 N-study + round-5 capacity/budget study,
    # scripts/gate_vg_study.py n*_ts / n*_w64 / n*_w128 / *_long cells).
    # With the mul_exp-exact forward walk the coupled bias is a flat
    # all-seeds-HIGH plateau (+0.8-1.1e-3 at width 21 / 2400 steps,
    # N-independent) — net-approximation error rectified through the aLin
    # coupling, NOT discretization.  The round-5 two-factor study splits
    # it: doubling the schedule alone halves it (w21@4800: mean 4.5e-4),
    # widening alone trims ~25% and (128,128) overfits the budget into
    # run scatter; BOTH together remove most of it — (64,64)@4800 reads
    # 0.5/1.4/3.5 e-4 (round-5 VG study).  The operational
    # gate ships that cell: N=240, hidden (64,64), steps 4800 — ~3x
    # margin on the seed max vs round-4's 1.1x.
    g["vg_coupled_direct"] = dict(
        model=dataclasses.replace(
            make_vg_default(a_lin=0.1), price_eval="chebyshev", N=240),
        oracle=vg_oracle, scheme="global", seeds=3, peak_lr=3e-3,
        steps=4800, warm_y0=True, time_scale=30.0 / 240.0,
        hidden=(64, 64), **speed_kw)
    # Reference-faithful numerics on the same budget.
    g["merton_direct"] = dict(
        model=merton, oracle=merton_oracle, scheme="multistep1",
        compensator=CompensatorSpec())
    # Chebyshev compensator alone (round-1 reading: 4.3e-4).
    g["merton_cheb"] = dict(
        model=make_merton_default(jump_sampler="icdf"),
        oracle=merton_oracle, scheme="multistep1", compensator=cheb64)
    # Global scheme (trainable Y0) — optimization-dominated.
    g["merton_global"] = dict(
        model=make_merton_default(jump_sampler="icdf"),
        oracle=merton_oracle, scheme="global", compensator=cheb64)
    # VG against the Carr-Madan FFT price.
    g["vg_direct"] = dict(
        model=vg, oracle=vg_oracle, scheme="global",
        compensator=CompensatorSpec(n_hermite=5, n_laguerre=8))
    # The shipped bench.py --model vg config: collocated price_eval +
    # the iCDF subordinator sampler (the gamma rejection loop was ~77%
    # of VG device time; icdf is law-exact to the table fit — see
    # models/variance_gamma.py and tests/test_fast_paths.py).
    g["vg_speed"] = dict(
        model=dataclasses.replace(vg, price_eval="chebyshev",
                                  jump_sampler="icdf"),
        oracle=vg_oracle, scheme="global", **speed_kw)
    # aLin=0.05 coupled VG row — passed 5/5 in the study (+0.73e-3).
    g["vg_half_coupling"] = dict(
        model=dataclasses.replace(make_vg_default(a_lin=0.05),
                                  price_eval="chebyshev"),
        oracle=vg_oracle, scheme="global", compensator=cheb64, seeds=3,
        peak_lr=3e-3, steps=2400, warm_y0=True)

    registry = {name: {"kind": "gate", "args": args}
                for name, args in g.items()}
    # Gate-closing technique for the COUPLED Global scheme at the
    # reference's own N: the coupling-rectification bias is linear in
    # aLin (round-2 floor analysis), so 2*Y0(aLin/2) - Y0(aLin)
    # cancels it.  The VG twin landed 2.0e-7 from the FFT oracle on seed
    # means (round-2 VG study).
    registry["merton_global_extrapolated"] = {
        "kind": "extrapolated",
        "args": dict(
            make_model=lambda a: make_merton_default(
                a_lin=a, jump_sampler="icdf", price_mode="chebyshev"),
            oracle=merton_oracle, compensator=cheb64, seeds=3)}
    registry["vg_global_extrapolated"] = {
        "kind": "extrapolated",
        "args": dict(
            make_model=lambda a: dataclasses.replace(
                make_vg_default(a_lin=a), price_eval="chebyshev"),
            oracle=vg_oracle, compensator=cheb64, seeds=3)}

    # --- MFG rows (round 5; the matrix was pricing-only before) ---------
    # Linear-quadratic corner: f0 = f1 = 0 makes the coupled FBSDE linear
    # and Y0_hat = Y0 EXACTLY solvable (eval/mfg_lq_oracle.py) — the
    # first independent MFG accuracy oracle (all five schemes gated).
    # icdf Cox sampler as shipped by bench --model mfg; the jumps are
    # provably irrelevant in the LQ corner (they enter the controls only
    # through the f1-gated terms), so the sampler choice cannot move Y0.
    #
    # Per-scheme budgets/bars from the round-5 calibration study
    # (scripts/mfg_lq_study.py + width probe): warm-started Global reads the oracle to 1-5e-6
    # relative (gate 1e-3, three orders of margin).  The four feedback
    # schemes plateau at a REPRODUCIBLE per-family low bias of the
    # t=0 net readout — multistep family 1.31-1.41e-2, sumlocal family
    # 2.41-2.53e-2 relative — invariant to peak lr (3e-3/6e-3), steps
    # (2400-9600), batch (4096/16384) and head width ((21,21)/(64,64));
    # their gates pin that measured plateau as a regression bound at
    # ~1.7x margin.  Budgets stop at 2400/4800 steps: longer cosine
    # schedules DESTABILIZE the full-net t=0 readout (drifts to -50..-52
    # by 9600 steps while the hat readout stays put — the corner value
    # is loss-irrelevant once terminal matching saturates).
    mfg_lq = dataclasses.replace(make_mfg_default(f0=0.0, f1=0.0),
                                 jump_sampler="icdf")
    lq_budget = {
        "global": dict(steps=4800, rel_gate=1e-3, warm_y0=True),
        "multistep": dict(steps=2400, rel_gate=2.5e-2),
        "multistep_reg": dict(steps=2400, rel_gate=2.5e-2),
        "sumlocal": dict(steps=2400, rel_gate=4e-2),
        "sumlocal_reg": dict(steps=2400, rel_gate=4e-2),
    }
    for scheme, budget in lq_budget.items():
        registry[f"mfg_lq_{scheme}"] = {
            "kind": "mfg_lq",
            "args": dict(model=mfg_lq, scheme=scheme, seeds=3,
                         batch=4096, peak_lr=6e-3, **budget)}
    # Default-config consensus at a reduced budget: a regression in any
    # MFG training path now fails a chip gate run instead of waiting for
    # the manual 24-minute comparison sweep.
    registry["mfg_consensus"] = {
        "kind": "mfg_consensus",
        "args": dict(model=dataclasses.replace(make_mfg_default(),
                                               jump_sampler="icdf"))}
    return registry


def run_entry(name, entry, **overrides):
    """Run one registry entry with budget-key overrides (smoke tier)."""
    args = dict(entry["args"])
    args.update(overrides)
    if entry["kind"] == "extrapolated":
        return run_extrapolated_gate(name, **args)
    if entry["kind"] == "mfg_lq":
        return run_mfg_lq_gate(name, **args)
    if entry["kind"] == "mfg_consensus":
        return run_mfg_consensus_gate(name, **args)
    return run_gate(name, **args)


def main():
    from deepfbsdejsolvers_tpu.utils.compile_cache import enable_compile_cache

    p = argparse.ArgumentParser()
    p.add_argument("gates", nargs="*", default=["merton_speed"])
    args = p.parse_args()
    enable_compile_cache()
    registry = build_registry()
    gates = args.gates if args.gates != ["all"] else list(registry)
    for g in gates:
        run_entry(g, registry[g])


if __name__ == "__main__":
    main()
