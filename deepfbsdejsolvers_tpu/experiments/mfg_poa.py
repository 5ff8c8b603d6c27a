"""Price-of-Anarchy pipeline — the mainMFGPoA.py equivalent.

For each pricing case and each π, trains an MFG model (coeff_equi=1) and an
aggregate-MFC model (coeff_equi=2), replays both players' trained policies on
ONE frozen common-noise set, and tabulates PoA = cost_MFG / cost_MFC with 95%
CIs (mainMFGPoA.py:189-337).  Artifacts: the PoA table (CSV), JSONL metrics,
and optionally the multi-page PDF of consumption/deviation/price panels
(:362-375).

The reference script cannot run as checked in (SyntaxError at :252-255, dead
Osterlee branch :224-225, MFGSolutions defects) — this pipeline implements the
intended behavior end-to-end (SURVEY.md §2 #12/#14).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List

import jax

from deepfbsdejsolvers_tpu.experiments.configs import (
    MFG_METHOD_TO_SCHEME,
    MFGPoAConfig,
)
from deepfbsdejsolvers_tpu.eval.mfg_solutions import (
    FrozenNoise,
    MFGFixedTrajectoryEvaluator,
    draw_frozen_noise,
    price_of_anarchy,
)
from deepfbsdejsolvers_tpu.models.mfg_smart_grid import (
    SmartGridMFGModel,
    make_mfg_default,
)
from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver
from deepfbsdejsolvers_tpu.utils.logging import MetricsLogger
from deepfbsdejsolvers_tpu.utils.profiling import trace_profile


@dataclasses.dataclass
class PoACell:
    """One (case, π) sweep point."""

    case: str
    pi: float
    poa: float
    mfg_cost: float
    mfg_ci: float
    mfc_cost: float
    mfc_ci: float
    evaluators: Dict[str, MFGFixedTrajectoryEvaluator]


TABLE_COLUMNS = ("case", "pi", "PoA", "MFG cost", "MFG ci95", "MFC cost",
                 "MFC ci95")


@dataclasses.dataclass
class PoARunResult:
    cells: List[PoACell]

    def table(self) -> List[dict]:
        """PoA table rows, one dict per sweep point with the
        ``TABLE_COLUMNS`` keys (mainMFGPoA.py:332-337)."""
        return [dict(zip(TABLE_COLUMNS,
                         (c.case, c.pi, c.poa, c.mfg_cost, c.mfg_ci,
                          c.mfc_cost, c.mfc_ci)))
                for c in self.cells]

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=TABLE_COLUMNS)
            writer.writeheader()
            writer.writerows(self.table())

    def to_text(self) -> str:
        """The table as aligned plain text, one line per sweep point."""
        cells = [list(TABLE_COLUMNS)] + [
            [r["case"]] + [f"{r[k]:.6g}" for k in TABLE_COLUMNS[1:]]
            for r in self.table()]
        widths = [max(len(row[i]) for row in cells)
                  for i in range(len(TABLE_COLUMNS))]
        return "\n".join("  ".join(v.rjust(w) for v, w in zip(row, widths))
                         for row in cells)


def _make_model(config: MFGPoAConfig, pi: float, p0: float, p1: float,
                f0: float, f1: float, coeff_equi: float) -> SmartGridMFGModel:
    model = make_mfg_default(
        nb_days=config.nb_days, raf_coef=config.raf_coef,
        jump_factor=config.jump_factor, pi=pi, p0=p0, p1=p1, f0=f0, f1=f1,
        jump_model=config.jump_model, coeff_equi=coeff_equi,
    )
    if config.jump_sampler != model.jump_sampler:
        import dataclasses

        model = dataclasses.replace(model, jump_sampler=config.jump_sampler)
    return model


def run_mfg_poa(config: MFGPoAConfig, verbose: bool = True) -> PoARunResult:
    io = config.io
    logger = None
    if io.outdir and io.metrics_jsonl:
        os.makedirs(io.outdir, exist_ok=True)
        logger = MetricsLogger(os.path.join(io.outdir, "metrics.jsonl"),
                               tags={"experiment": "mfg_poa"})

    # Frozen noise, drawn once from the zero-price model with pi=0.5
    # (mainMFGPoA.py:110-121).
    noise_model = _make_model(config, pi=0.5, p0=0.0, p1=0.0, f0=0.0, f1=0.0,
                              coeff_equi=1.0)
    key = jax.random.key(config.seed)
    key, k_noise = jax.random.split(key)
    dw0, dws, dn = draw_frozen_noise(noise_model, k_noise, config.n_frozen,
                                     n_players=2)

    scheme = MFG_METHOD_TO_SCHEME[config.method]
    mesh = None
    if config.data_parallel:
        from deepfbsdejsolvers_tpu.parallel.data_parallel import make_mesh

        mesh = make_mesh()
        if verbose:
            print(f"data-parallel over {mesh.shape['data']} device(s)")
    cells: List[PoACell] = []
    with trace_profile(io.profile_dir):
        for i_case, (case, (p0, p1, f0, f1)) in enumerate(config.cases.items()):
            for i_pi, pi in enumerate(config.pi_list):
                if verbose:
                    print(f"==== case '{case}'  pi={pi} ====")
                evaluators: Dict[str, MFGFixedTrajectoryEvaluator] = {}
                for i_tag, (tag, coeff_equi) in enumerate((("mfg", 1.0),
                                                           ("mfc", 2.0))):
                    model = _make_model(config, pi, p0, p1, f0, f1, coeff_equi)
                    solver = MFGSolver(
                        model=model, scheme=scheme,
                        hidden_hat=config.hidden_hat, hidden=config.hidden,
                        activation_hat=config.activation_hat,
                        activation=config.activation,
                        scan_chunk=config.scan_chunk)
                    # deterministic per-(case, pi, model) training key
                    cell_id = (i_case * len(config.pi_list) + i_pi) * 2 + i_tag
                    res = solver.train(
                        key=jax.random.fold_in(key, cell_id),
                        batch=config.batch_size,
                        batch_val=config.batch_size * 10,
                        num_epoch=config.n_epoch,
                        num_epoch_ext=config.n_epoch_ext,
                        lrate=config.lrate_for(config.method),
                        couplage=config.couplage, verbose=verbose, mesh=mesh,
                        y0_warm_start=config.y0_warm_start)
                    for player, dw in enumerate(dws):
                        evaluators[f"{tag}_p{player + 1}"] = (
                            MFGFixedTrajectoryEvaluator(
                                solver=solver, params=res.params,
                                noise=FrozenNoise(dW0=dw0, dW=dw, dN=dn)))
                poa = price_of_anarchy(evaluators["mfg_p1"], evaluators["mfc_p1"],
                                       config.n_frozen)
                # player-2 replays for the two-player trajectory panels
                evaluators["mfg_p2"].simulate_all_processes(config.n_frozen)
                evaluators["mfc_p2"].simulate_all_processes(config.n_frozen)
                cell = PoACell(case=case, pi=pi, poa=poa["poa"],
                               mfg_cost=poa["mfg_cost"], mfg_ci=poa["mfg_ci"],
                               mfc_cost=poa["mfc_cost"], mfc_ci=poa["mfc_ci"],
                               evaluators=evaluators)
                cells.append(cell)
                if logger:
                    logger.log(event="cell_done", case=case, pi=pi, **poa)
                if verbose:
                    print(f"  PoA = {poa['poa']:.6f}  "
                          f"(MFG {poa['mfg_cost']:.4f}±{poa['mfg_ci']:.4f}, "
                          f"MFC {poa['mfc_cost']:.4f}±{poa['mfc_ci']:.4f})")

    result = PoARunResult(cells=cells)
    if io.outdir:
        result.write_csv(os.path.join(io.outdir, "poa_table.csv"))
        if io.save_plots:
            pretrain = _pretrain_evaluators(config, noise_model, scheme, key,
                                            dw0, dws, dn)
            _plot_pdf(config, result, pretrain)
    if logger:
        logger.close()
    return result


def _pretrain_evaluators(config: MFGPoAConfig, noise_model, scheme, key,
                         dw0, dws, dn):
    """Untrained-policy replays on the frozen noise — the reference's
    pre-training diagnostic stage (mainMFGPoA.py:139-186): both players run a
    FRESH-initialized network pair through the zero-price model so the raw
    consumption/intensity/jump dynamics are visible before any learning."""
    solver0 = MFGSolver(model=noise_model, scheme=scheme,
                        hidden_hat=config.hidden_hat, hidden=config.hidden,
                        activation_hat=config.activation_hat,
                        activation=config.activation)
    params0 = solver0.init_params(jax.random.fold_in(key, 10 ** 6))
    evs = []
    for dw in dws:
        ev = MFGFixedTrajectoryEvaluator(
            solver=solver0, params=params0,
            noise=FrozenNoise(dW0=dw0, dW=dw, dN=dn))
        ev.simulate_all_processes(min(config.n_frozen, max(config.n_replay, 1)))
        evs.append(ev)
    return tuple(evs)


def _plot_pdf(config: MFGPoAConfig, result: PoARunResult, pretrain=None):
    """Multi-page PDF: the pre-training diagnostic panels (untrained policy:
    consumption / intensity twin-axis / intensity / jump indicator,
    mainMFGPoA.py:154-186), then consumption / deviation / price panels per
    sweep point, then the PoA-vs-π curves (:252-335,362-375 intended output)."""
    from deepfbsdejsolvers_tpu.experiments.plots import pyplot

    plt = pyplot()
    from matplotlib.backends.backend_pdf import PdfPages

    path = os.path.join(config.io.outdir, "simulations_all_cases.pdf")
    n_show = min(config.n_replay, result.cells[0].evaluators["mfg_p1"]
                 .trajectories["Q"].shape[0]) if result.cells else 0
    with PdfPages(path) as pdf:
        if pretrain is not None:
            _pretrain_pages(config, pretrain, pdf, plt)
        for cell in result.cells:
            ev1, ev2 = cell.evaluators["mfg_p1"], cell.evaluators["mfg_p2"]
            t_hours = ev1.trajectories["t"] * ev1.model.dt * 24.0
            for j in range(n_show):
                fig, ax = plt.subplots(nrows=2, ncols=2, figsize=(12, 8))
                tr1, tr2 = ev1.trajectories, ev2.trajectories
                # equilibrium consumption of both players vs the projection
                ax[0, 0].plot(t_hours, tr1["hQ"][j], color="dimgray",
                              linewidth=2.2, label=r"$\hat{Q}$")
                ax[0, 0].plot(t_hours, tr1["Q"][j] + tr1["alpha"][j],
                              color="blue", label=r"$Q^1+\alpha^1$")
                ax[0, 0].plot(t_hours, tr2["Q"][j] + tr2["alpha"][j],
                              color="red", label=r"$Q^2+\alpha^2$")
                ax[0, 0].set_title(f"consumption — {cell.case}, pi={cell.pi}")
                # cumulative deviation
                ax[0, 1].plot(t_hours, tr1["S"][j], label=r"$S^1$")
                ax[0, 1].plot(t_hours, tr1["hS"][j], label=r"$\hat S$")
                ax[0, 1].set_title("cumulative deviation")
                # dynamic price p0 + pi p1 hQ + (1-pi) p1 (hQ+alpha_hat)
                price = ev1.price(cell.pi, tr1["alpha_hat"])
                ax[1, 0].plot(t_hours, price[j], label="price")
                ax[1, 0].set_title("dynamic price")
                # jump intensity
                ax[1, 1].plot(t_hours, tr1["lam"][j], linestyle="dashed",
                              color="brown", label=r"$\lambda$")
                ax[1, 1].set_title("intensity")
                for a in ax.flat:
                    a.set(xlabel="time (hours)")
                    a.legend(prop={"size": 6})
                pdf.savefig(fig)
                plt.close(fig)
        # PoA vs pi, one curve per case
        fig, ax = plt.subplots(figsize=(8, 5))
        cases = sorted({c.case for c in result.cells})
        for case in cases:
            pts = sorted([(c.pi, c.poa) for c in result.cells if c.case == case])
            ax.plot([p for p, _ in pts], [v for _, v in pts], marker="o",
                    label=case)
        ax.set(xlabel=r"$\pi$", ylabel="PoA", title="Price of Anarchy")
        ax.grid()
        ax.legend(prop={"size": 7})
        pdf.savefig(fig)
        plt.close(fig)


def _pretrain_pages(config: MFGPoAConfig, pretrain, pdf, plt):
    """One page per shown trajectory with the reference's four pre-training
    panels (mainMFGPoA.py:157-183): player consumptions vs the projection,
    the intensity on a twin axis against hQ, the intensity alone, and the
    R < theta jump-window indicator."""
    ev1, ev2 = pretrain
    tr1, tr2 = ev1.trajectories, ev2.trajectories
    t_hours = tr1["t"] * ev1.model.dt * 24.0
    n_show = min(config.n_replay, tr1["Q"].shape[0])
    for j in range(n_show):
        fig, ax = plt.subplots(nrows=2, ncols=2, figsize=(12, 8))
        ax[0, 0].plot(t_hours, tr1["hQ"][j], label=r"$\hat{Q}$",
                      linewidth=2.2, color="dimgray")
        ax[0, 0].plot(t_hours, tr1["Q"][j], label=r"$Q^{1}$ player 1",
                      color="blue")
        ax[0, 0].plot(t_hours, tr2["Q"][j], label=r"$Q^{2}$ player 2",
                      color="red")
        ax[0, 0].set_title("consumption (kW) — pre-training")
        ax[0, 0].legend(prop={"size": 6})
        ax[0, 1].plot(t_hours, tr1["hQ"][j], label=r"$\hat{Q}$",
                      linewidth=2.2, color="dimgray")
        ax[0, 1].set_title("intensity")
        ax[0, 1].set(ylabel=r"$\hat{Q}$")
        ax2 = ax[0, 1].twinx()
        ax2.plot(t_hours, tr1["lam"][j], label=r"$\lambda$",
                 linestyle="dashed", color="tab:brown")
        ax2.legend(loc=1, prop={"size": 6})
        ax[1, 0].plot(t_hours, tr1["lam"][j], label=r"$\lambda$",
                      linestyle="dashed", color="brown")
        ax[1, 0].set_title("intensity")
        ax[1, 0].legend(prop={"size": 6})
        ax[1, 1].plot(t_hours, tr1["R"][j] < ev1.model.theta, label="jumps")
        ax[1, 1].set_title("jumps")
        for a in ax.flat:
            a.set(xlabel="time (hours)")
        pdf.savefig(fig)
        plt.close(fig)
