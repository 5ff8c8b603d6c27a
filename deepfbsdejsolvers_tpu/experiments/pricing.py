"""Pricing experiment pipeline — the mainMerton.py / mainVG.py equivalent.

Runs the full method sweep (7 deep-BSDE schemes) on one pricing model, tracks
Y0 convergence against the model's closed-form/FFT oracle, and optionally
writes JSONL metrics, checkpoints, and the convergence figure the reference
shows interactively (mainMerton.py:124-128, mainVG.py:114-121).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import jax

from deepfbsdejsolvers_tpu.experiments.configs import (
    MertonConfig,
    PRICING_METHOD_TO_SCHEME,
    VGConfig,
)
from deepfbsdejsolvers_tpu.models.merton import MertonJumpModel, abs_coupling
from deepfbsdejsolvers_tpu.models.variance_gamma import VGModel
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
from deepfbsdejsolvers_tpu.solvers.train import fit
from deepfbsdejsolvers_tpu.utils.checkpointing import CheckpointManager
from deepfbsdejsolvers_tpu.utils.logging import MetricsLogger
from deepfbsdejsolvers_tpu.utils.profiling import trace_profile


def build_model(config):
    """Model from config (params: mainMerton.py:57 / mainVG.py:54)."""
    coupling = abs_coupling(config.a_lin)
    if isinstance(config, MertonConfig):
        return MertonJumpModel(T=1.0, N=50, r=0.1, muJ=0.0, sigJ=0.2, sigma=0.3,
                               lam=3.0, K=0.9, x0=1.0, coupling=coupling,
                               limit=config.limit,
                               jump_sampler=config.jump_sampler,
                               price_mode=config.price_mode)
    if isinstance(config, VGConfig):
        # VG keeps direct price evaluation ("chebyshev" price_mode maps to
        # its price_eval knob; the near-expiry kink caveat is in the model).
        # jump_sampler="icdf" (the --fast preset) swaps the gamma rejection
        # sampler for the precomputed subordinator-quantile table — the
        # round-3 VG speed path.
        return VGModel(T=1.0, N=30, r=0.1, theta=-0.1, kappa=0.1, sigJ=0.2,
                       K=1.0, x0=1.0, coupling=coupling, pricer=config.pricer,
                       jump_sampler=config.jump_sampler,
                       price_eval="chebyshev" if config.price_mode == "chebyshev"
                       else "direct")
    raise TypeError(f"unknown pricing config type {type(config).__name__}")


@dataclasses.dataclass
class MethodResult:
    method: str
    y0_history: list
    loss_history: list
    duration: float
    y0: float
    abs_error: float
    params: dict


@dataclasses.dataclass
class PricingRunResult:
    reference_price: float
    methods: Dict[str, MethodResult]

    def best(self) -> MethodResult:
        return min(self.methods.values(), key=lambda m: m.abs_error)


def _train_one(config, model, method: str, logger: Optional[MetricsLogger],
               verbose: bool) -> MethodResult:
    scheme = PRICING_METHOD_TO_SCHEME[method]
    solver = PricingSolver(
        model=model, scheme=scheme, hidden=config.hidden,
        activation=config.activation,
        compensator=CompensatorSpec(
            kind=config.compensator, n_mc=config.n_mc,
            n_poisson_max=config.n_poisson_max, n_hermite=config.n_hermite,
            n_laguerre=config.n_laguerre, x_interp=config.x_interp,
            n_cheb=config.n_cheb),
        compute_dtype=config.compute_dtype,
        hoist=config.hoist, hoist_interp=config.hoist_interp,
        scan_chunk=config.scan_chunk,
    )
    key = jax.random.key(config.seed)
    key, k_init = jax.random.split(key)
    params = solver.init_params(k_init)
    if config.y0_warm_start and scheme == "global":
        # dedicated key: fit() folds per-epoch constants into `key`, so a
        # fold_in(key, const) here could alias a training/validation batch
        key, k_warm = jax.random.split(key)
        params = solver.warm_start_y0(params, k_warm)

    io = config.io
    mgr = None
    start_epoch, opt_state = 0, None
    if io.outdir and io.checkpoint_every:
        mgr = CheckpointManager(os.path.join(io.outdir, "ckpt", method))
        if io.resume:
            latest = mgr.latest_step()
            if latest is not None:
                from deepfbsdejsolvers_tpu.solvers.train import make_adam

                opt_example = make_adam(config.lrate_for(method)).init(params)
                step, (params, opt_state, key) = mgr.restore_latest(
                    (params, opt_example, key))
                start_epoch = step + 1

    def on_epoch(i, metrics, state):
        if logger is not None:
            logger.log(epoch=i, **metrics)
        if mgr is not None and io.checkpoint_every and (i + 1) % io.checkpoint_every == 0:
            mgr.save(i, state)

    # reference semantics: the Y-only regressions train on 1000x the nominal
    # batch (SolversJumpDiff.py:435,503)
    batch = config.batch_size * (
        config.reg_batch_multiplier
        if scheme in ("sumlocal_reg", "multistep_reg") else 1)
    val_batch = config.batch_size * 10
    mesh = None
    if config.data_parallel:
        from deepfbsdejsolvers_tpu.parallel.data_parallel import (
            make_mesh, per_shard_batch)

        mesh = make_mesh()
        batch = per_shard_batch(batch, mesh)
        val_batch = per_shard_batch(val_batch, mesh)
        if verbose:
            print(f"  data-parallel over {mesh.shape['data']} device(s), "
                  f"{batch} paths/chip")
    res = fit(
        loss_fn=solver.build_loss(batch),
        params=params, key=key, lrate=config.lrate_for(method),
        num_epoch=config.n_epoch, num_epoch_ext=config.n_epoch_ext,
        val_loss_fn=solver.build_loss(val_batch),
        y0_fn=solver.y0_estimate, verbose=verbose, on_epoch=on_epoch,
        start_epoch=start_epoch, opt_state=opt_state, mesh=mesh,
    )
    if not res.y0_history:
        y0 = float("nan")
    elif config.y0_tail_avg > 1:
        import numpy as np

        y0 = float(np.mean(res.y0_history[-config.y0_tail_avg:]))
    else:
        y0 = res.y0_history[-1]
    ref = model.price_at_origin()
    return MethodResult(method=method, y0_history=res.y0_history,
                        loss_history=res.loss_history, duration=res.duration,
                        y0=y0, abs_error=abs(y0 - ref), params=res.params)


def run_pricing(config, verbose: bool = True) -> PricingRunResult:
    """The full mainMerton/mainVG sweep: train every method, compare to the
    oracle price, emit metrics/plots per ``config.io``."""
    model = build_model(config)
    ref_price = model.price_at_origin()
    io = config.io
    logger = None
    if io.outdir and io.metrics_jsonl:
        os.makedirs(io.outdir, exist_ok=True)
        exp = "merton" if isinstance(config, MertonConfig) else "vg"
        logger = MetricsLogger(os.path.join(io.outdir, "metrics.jsonl"),
                               tags={"experiment": exp})
        logger.log(event="start", reference_price=ref_price,
                   config={k: str(v) for k, v in dataclasses.asdict(config).items()})

    results: Dict[str, MethodResult] = {}
    with trace_profile(io.profile_dir):
        for method in config.methods:
            if verbose:
                print(f"==== method {method} (oracle price {ref_price:.6f}) ====")
            mlog = logger.child(method=method) if logger else None
            results[method] = _train_one(config, model, method, mlog, verbose)
            if logger:
                logger.log(event="method_done", method=method,
                           y0=results[method].y0,
                           abs_error=results[method].abs_error,
                           duration_s=results[method].duration)

    if io.outdir and io.save_plots:
        _plot_convergence(config, ref_price, results)
    if logger:
        logger.close()
    return PricingRunResult(reference_price=ref_price, methods=results)


def _plot_convergence(config, ref_price: float, results: Dict[str, MethodResult]):
    """The reference's Y0-vs-epoch overlay (mainMerton.py:124-128), written to
    a file instead of plt.show()."""
    from deepfbsdejsolvers_tpu.experiments.plots import pyplot

    plt = pyplot()
    import numpy as np

    fig, ax = plt.subplots(figsize=(10, 6))
    for method, res in results.items():
        ax.plot(res.y0_history, label=f"Y0 DL {method}")
    ax.plot(ref_price * np.ones(config.n_epoch_ext), label="Y0 closed formula",
            linestyle="dashed")
    ax.grid()
    ax.set(xlabel="outer epoch", ylabel="Y0")
    ax.legend()
    path = os.path.join(config.io.outdir, "convergence.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
