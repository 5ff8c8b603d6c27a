#!/usr/bin/env python
"""Close (or quantify the floor of) the Merton Global-scheme 1e-3 gate.

Round-1 status (``git show 1858ddd:BASELINE.md``): the Global scheme's trainable Y0 lands at
3.4e-3 - 9.4e-3 run-to-run on the standard 3-phase budget — optimization-
dominated, not numerics-dominated (aLin=0 passes at 3.8e-4; the coupling
aLin*|Y - A| rectifies head-approximation noise into a drift bias).

This study measures, across seeds, the round-1 review's levers:
  base        3-phase constant-lr fit (round-1 configuration)
  cosine      one fit, cosine-decayed lr (3e-3 -> 0) over the same step budget
  cosine_tail cosine + trailing-average Y0 readout over the last K epochs
  long        cosine_tail at 2x steps
  wide        cosine_tail with (64, 64) heads (less rectified drift bias)
  bigbatch    cosine_tail at 4x batch (less SGD noise into the rectifier)

Usage: python scripts/gate_global_study.py [--seeds 5] [--variants ...]
Writes one JSON line per (variant, seed) and a summary per variant.
"""

import argparse
import json
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np
import optax

from deepfbsdejsolvers_tpu.models.merton import make_merton_default
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
from deepfbsdejsolvers_tpu.solvers.train import fit

CHEB64 = CompensatorSpec(x_interp="chebyshev", n_cheb=64)


def run_once(seed: int, *, hidden=(21, 21), batch=8192, steps=2400,
             schedule="cosine", tail_epochs=0, peak_lr=3e-3, a_lin=0.1,
             warm_y0=False, n_steps=None, solver_kw=None):
    import dataclasses as _dc

    model = make_merton_default(a_lin=a_lin, jump_sampler="icdf",
                                price_mode="chebyshev")
    if n_steps is not None:
        model = _dc.replace(model, N=n_steps)
    oracle = model.price_at_origin()
    solver = PricingSolver(model, "global", hidden=hidden, compensator=CHEB64,
                          **(solver_kw or {}))
    params = solver.init_params(jax.random.key(seed))
    if warm_y0:
        # Initialize the trainable Y0 at the closed-form-free MC estimate of
        # the discounted payoff under the UNcoupled dynamics (a cheap, oracle-
        # free warm start that keeps Adam out of the spurious Y0<0 basin).
        import dataclasses as _dc

        m0 = make_merton_default(a_lin=0.0, jump_sampler="icdf",
                                 price_mode="chebyshev")

        @jax.jit
        def payoff_mc(k):
            def body(x, i):
                dw = jnp.sqrt(m0.dt) * jax.random.normal(
                    jax.random.fold_in(k, 2 * i), x.shape)
                j = m0.sample_jumps(jax.random.fold_in(k, 2 * i + 1), x.shape)
                return m0.step(i, x, dw, j, jnp.zeros_like(x)), None

            x, _ = jax.lax.scan(body, m0.init_x(65536), jnp.arange(m0.N))
            return jnp.exp(-m0.r * m0.T) * jnp.mean(m0.payoff(x))

        y0_est = payoff_mc(jax.random.key(10_000 + seed))
        params["uz"]["y0"] = jnp.asarray(y0_est, jnp.float32)
    key = jax.random.key(1000 + seed)
    num_epoch = 100
    n_ext = steps // num_epoch
    if schedule == "cosine":
        lrate = optax.cosine_decay_schedule(peak_lr, steps)
        res = fit(loss_fn=solver.build_loss(batch), params=params, key=key,
                  lrate=lrate, num_epoch=num_epoch, num_epoch_ext=n_ext,
                  y0_fn=solver.y0_estimate, verbose=False)
        y0_hist = res.y0_history
    else:  # round-1 3-phase schedule
        y0_hist = []
        for phase, lr in enumerate((3e-3, 1e-3, 3e-4)):
            res = fit(loss_fn=solver.build_loss(batch), params=params,
                      key=jax.random.fold_in(key, phase), lrate=lr,
                      num_epoch=num_epoch, num_epoch_ext=n_ext // 3,
                      y0_fn=solver.y0_estimate, verbose=False)
            params = res.params
            y0_hist += res.y0_history
    if tail_epochs > 1:
        y0 = float(np.mean(y0_hist[-tail_epochs:]))
    else:
        y0 = float(y0_hist[-1])
    return y0, abs(y0 - oracle), oracle


VARIANTS = {
    "base": dict(schedule="phases"),
    "cosine": dict(schedule="cosine"),
    "cosine_tail": dict(schedule="cosine", tail_epochs=6),
    "long": dict(schedule="cosine", tail_epochs=12, steps=4800),
    "wide": dict(schedule="cosine", tail_epochs=6, hidden=(64, 64)),
    "bigbatch": dict(schedule="cosine", tail_epochs=6, batch=32768),
    # Decomposition of the systematic +3.5e-3 bias: the coupling term
    # aLin*|Y-A| rectifies the scheme's pathwise Y-approximation error into
    # extra drift.  If the bias is linear in aLin, 2*Y0(aLin/2) - Y0(aLin)
    # extrapolates it away.  warm_y0 starts the trainable scalar at an
    # oracle-free MC payoff estimate (keeps Adam out of the spurious
    # negative-Y0 basin some Glorot inits fall into).
    "warm": dict(schedule="cosine", tail_epochs=6, warm_y0=True),
    "warm_long": dict(schedule="cosine", tail_epochs=12, steps=4800,
                      warm_y0=True),
    "alin005": dict(schedule="cosine", tail_epochs=6, warm_y0=True,
                    a_lin=0.05),
    "alin0": dict(schedule="cosine", tail_epochs=6, warm_y0=True, a_lin=0.0),
    # Discretization probe: if the pathwise |Y - A| feeding the rectifier is
    # Euler-dominated, the bias shrinks with dt.
    "n100": dict(schedule="cosine", tail_epochs=6, warm_y0=True, n_steps=100),
    "n200": dict(schedule="cosine", tail_epochs=6, warm_y0=True, n_steps=200),
    # Round-3 discrimination cells: the round-2 3-point fit a + b/N gave a
    # "floor" a ~ 1.5e-3, but the same 3 points fit a + c/sqrt(N) with
    # a ~ 1e-4 — i.e. NO floor, the signature of the aLin*|Y-A| drift
    # rectifying the scheme's strong-Euler pathwise error (std ~ sqrt(dt)).
    # The models diverge at N=400 (pred 1.76e-3 vs 1.29e-3) and N=800
    # (1.63e-3 vs 0.94e-3): these cells decide, and under the sqrt model the
    # DIRECT coupled gate passes near N~800.
    "n400": dict(schedule="cosine", tail_epochs=6, warm_y0=True, n_steps=400),
    "n800": dict(schedule="cosine", tail_epochs=6, warm_y0=True, n_steps=800),
    # The raw-index time feature (reference parity) collapses at N=800
    # (~6e-3: the tanh first layer saturates over [0, 800] within the fixed
    # budget).  The _ts cells rescale the feature to the N=50 range
    # (time_scale = 50/N), isolating the SCHEME bias from net capacity; the
    # hoisted piecewise path keeps the big-N cells affordable.
    "n50_ts": dict(schedule="cosine", tail_epochs=6, warm_y0=True,
                   n_steps=50, solver_kw=dict(
                       time_scale=1.0, hoist=True,
                       hoist_interp="piecewise")),
    "n100_ts": dict(schedule="cosine", tail_epochs=6, warm_y0=True,
                    n_steps=100, solver_kw=dict(
                        time_scale=0.5, hoist=True,
                        hoist_interp="piecewise")),
    "n200_ts": dict(schedule="cosine", tail_epochs=6, warm_y0=True,
                    n_steps=200, solver_kw=dict(
                        time_scale=0.25, hoist=True,
                        hoist_interp="piecewise")),
    "n400_ts": dict(schedule="cosine", tail_epochs=6, warm_y0=True,
                    n_steps=400, solver_kw=dict(
                        time_scale=0.125, hoist=True,
                        hoist_interp="piecewise")),
    "n800_ts": dict(schedule="cosine", tail_epochs=6, warm_y0=True,
                    n_steps=800, solver_kw=dict(
                        time_scale=0.0625, hoist=True,
                        hoist_interp="piecewise")),
    "n1600_ts": dict(schedule="cosine", tail_epochs=6, warm_y0=True,
                     n_steps=1600, solver_kw=dict(
                         time_scale=0.03125, hoist=True,
                         hoist_interp="piecewise")),
}


def fit_bias_models(cells):
    """Least-squares fits of bias(N) under competing asymptotics.

    cells: {N: mean_abs_error}.  Returns per-model coefficients and the
    residual RMS, for the floor-vs-no-floor adjudication."""
    Ns = np.asarray(sorted(cells), dtype=float)
    y = np.asarray([cells[int(n)] for n in Ns])
    out = {}
    designs = {
        "a+b/N": np.stack([np.ones_like(Ns), 1.0 / Ns], 1),
        "a+c/sqrtN": np.stack([np.ones_like(Ns), Ns ** -0.5], 1),
        "b/N+c/sqrtN": np.stack([1.0 / Ns, Ns ** -0.5], 1),
        "c/sqrtN": (Ns ** -0.5)[:, None],
    }
    for name, X in designs.items():
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        resid = y - X @ coef
        out[name] = {"coef": [float(c) for c in coef],
                     "rms_resid": float(np.sqrt(np.mean(resid ** 2))),
                     "pred": {int(n): float(v) for n, v in
                              zip(Ns, X @ coef)}}
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--variants", nargs="*", default=list(VARIANTS))
    p.add_argument("--fit", nargs="*", metavar="N=err", default=None,
                   help="skip training; fit bias(N) models to the given "
                        "cells, e.g. --fit 50=3.5e-3 100=2.5e-3 200=1.93e-3")
    args = p.parse_args()

    if args.fit is not None:
        cells = {}
        for tok in args.fit:
            n, e = tok.split("=")
            cells[int(n)] = float(e)
        print(json.dumps(fit_bias_models(cells), indent=1))
        return

    summary = {}
    for name in args.variants:
        errs = []
        for seed in range(args.seeds):
            y0, err, oracle = run_once(seed, **VARIANTS[name])
            errs.append(err)
            print(json.dumps({"variant": name, "seed": seed, "y0": y0,
                              "oracle": oracle, "abs_error": err}), flush=True)
        errs = np.asarray(errs)
        summary[name] = {
            "mean_err": float(errs.mean()), "max_err": float(errs.max()),
            "pass_rate_1e-3": float((errs <= 1e-3).mean()),
        }
        print(json.dumps({"summary": name, **summary[name]}), flush=True)
    print(json.dumps({"all": summary}), flush=True)


if __name__ == "__main__":
    main()
