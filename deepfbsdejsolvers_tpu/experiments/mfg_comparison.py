"""MFG method-comparison pipeline — the mainMFGComparison.py equivalent.

Trains all five MFG schemes on the smart-grid coupled FBSDE and overlays the
(Y0_hat, Y0) convergence curves.  The reference's plotting stage is broken as
checked in (it reloads hY0List.csv/Y0List.csv that nothing writes,
mainMFGComparison.py:146-147); here the histories flow straight from training
to the figure, and are also persisted as CSV + JSONL so the intended reload
path actually works.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import jax
import numpy as np

from deepfbsdejsolvers_tpu.experiments.configs import (
    MFG_METHOD_TO_SCHEME,
    MFGComparisonConfig,
)
from deepfbsdejsolvers_tpu.models.mfg_smart_grid import make_mfg_default
from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver
from deepfbsdejsolvers_tpu.utils.logging import MetricsLogger
from deepfbsdejsolvers_tpu.utils.profiling import trace_profile


@dataclasses.dataclass
class MFGMethodResult:
    method: str
    y0_hat_history: list
    y0_history: list
    loss_history: list
    params: dict
    # players' objective cost (mean, 95% half-CI) over the common frozen-noise
    # replay — None when config.n_simulation == 0
    eval_cost: float = None
    eval_ci: float = None


@dataclasses.dataclass
class MFGComparisonResult:
    methods: Dict[str, MFGMethodResult]
    model: object


def build_mfg_model(config: MFGComparisonConfig):
    """Model from config (mainMFGComparison.py:92-110)."""
    model = make_mfg_default(
        nb_days=config.nb_days, raf_coef=config.raf_coef,
        jump_factor=config.jump_factor, pi=config.pi, p0=config.p0,
        p1=config.p1, f0=config.f0, f1=config.f1,
        jump_model=config.jump_model, coeff_equi=1.0,
    )
    if config.jump_sampler != model.jump_sampler:
        import dataclasses

        model = dataclasses.replace(model, jump_sampler=config.jump_sampler)
    return model


def run_mfg_comparison(config: MFGComparisonConfig,
                       verbose: bool = True) -> MFGComparisonResult:
    model = build_mfg_model(config)
    io = config.io
    logger = None
    if io.outdir and io.metrics_jsonl:
        os.makedirs(io.outdir, exist_ok=True)
        logger = MetricsLogger(os.path.join(io.outdir, "metrics.jsonl"),
                               tags={"experiment": "mfg_comparison"})

    mesh = None
    if config.data_parallel:
        from deepfbsdejsolvers_tpu.parallel.data_parallel import make_mesh

        mesh = make_mesh()
        if verbose:
            print(f"data-parallel over {mesh.shape['data']} device(s)")

    results: Dict[str, MFGMethodResult] = {}
    solvers: Dict[str, MFGSolver] = {}
    with trace_profile(io.profile_dir):
        for method in config.methods:
            if verbose:
                print(f"==== MFG method {method} (couplage {config.couplage}) ====")
            scheme = MFG_METHOD_TO_SCHEME[method]
            solver = MFGSolver(model=model, scheme=scheme,
                               hidden_hat=config.hidden_hat, hidden=config.hidden,
                               activation_hat=config.activation_hat,
                               activation=config.activation,
                               scan_chunk=config.scan_chunk)
            solvers[method] = solver
            mlog = logger.child(method=method) if logger else None
            res = solver.train(
                key=jax.random.key(config.seed), batch=config.batch_size,
                batch_val=config.batch_size * 10, num_epoch=config.n_epoch,
                num_epoch_ext=config.n_epoch_ext,
                lrate=config.lrate_for(method), couplage=config.couplage,
                verbose=verbose,
                on_epoch=(lambda i, m, s: mlog.log(epoch=i, **m)) if mlog else None,
                mesh=mesh, y0_warm_start=config.y0_warm_start,
            )
            results[method] = MFGMethodResult(
                method=method, y0_hat_history=res.y0_hat_history,
                y0_history=res.y0_history, loss_history=res.loss_history,
                params=res.params)
            if logger:
                logger.log(event="method_done", method=method,
                           y0_hat=res.y0_hat_history[-1],
                           y0=res.y0_history[-1])

    if config.n_simulation:
        # The reference parses nbSimulation and only prints it
        # (mainMFGComparison.py:28,41); give it its clearly-intended role —
        # evaluate every trained policy's objective cost on ONE common
        # frozen-noise set (MFGSolutions.py:103-111 semantics), so methods
        # are compared pathwise on identical randomness.
        from deepfbsdejsolvers_tpu.eval.mfg_solutions import (
            FrozenNoise, MFGFixedTrajectoryEvaluator, draw_frozen_noise)

        dw0, dws, dn = draw_frozen_noise(
            model, jax.random.key(config.seed + 10_000), config.n_simulation)
        noise = FrozenNoise(dW0=dw0, dW=dws[0], dN=dn)
        half_ci = 1.96 / np.sqrt(config.n_simulation)
        for method in config.methods:
            ev = MFGFixedTrajectoryEvaluator(
                solver=solvers[method], params=results[method].params,
                noise=noise)
            ev.simulate_all_processes(config.n_simulation)
            cost, std = ev.objective_function()
            results[method].eval_cost = cost
            results[method].eval_ci = half_ci * std
            if verbose:
                print(f"{method}: frozen-noise cost {cost:.4f} "
                      f"± {half_ci * std:.4f} ({config.n_simulation} paths)")
            if logger:
                logger.log(event="frozen_eval", method=method, cost=cost,
                           ci=half_ci * std, n_sim=config.n_simulation)

    if io.outdir:
        # The CSVs the reference plots expect to exist (:146-147) — written
        # for real this time.
        hist_hat = np.array([results[m].y0_hat_history for m in config.methods])
        hist = np.array([results[m].y0_history for m in config.methods])
        np.savetxt(os.path.join(io.outdir, "hY0List.csv"), hist_hat, delimiter=",")
        np.savetxt(os.path.join(io.outdir, "Y0List.csv"), hist, delimiter=",")
        if io.save_plots:
            _plot(config, results)
    if logger:
        logger.close()
    return MFGComparisonResult(methods=results, model=model)


def _plot(config: MFGComparisonConfig, results: Dict[str, MFGMethodResult]):
    """Two-panel (Y0_hat, Y0) convergence overlay (mainMFGComparison.py:148-161)."""
    from deepfbsdejsolvers_tpu.experiments.plots import pyplot

    plt = pyplot()

    fig, ax = plt.subplots(nrows=1, ncols=2, figsize=(12, 4))
    for method in config.methods:
        ax[0].plot(results[method].y0_hat_history, label=method)
        ax[1].plot(results[method].y0_history, label=method)
    ax[0].set(ylabel=r"$\hat{Y}_0$", xlabel="epochs", title="convergence of methods")
    ax[1].set(ylabel=r"$Y_0$", xlabel="epochs", title="convergence of methods")
    for a in ax:
        a.legend(prop={"size": 6})
        a.grid()
    fig.savefig(os.path.join(config.io.outdir, "mfg_convergence.png"),
                dpi=120, bbox_inches="tight")
    plt.close(fig)
