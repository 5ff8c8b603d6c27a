"""Smoke tests for the L4 experiment pipelines (tiny configs).

The reference has no tests; these gate what its main scripts do interactively
— method sweeps converge toward the oracle and artifacts are written
(SURVEY.md §4 rebuild plan).
"""

import csv
import json
import os

import numpy as np
import pytest

from deepfbsdejsolvers_tpu.experiments.configs import (
    MertonConfig,
    MFGComparisonConfig,
    MFGPoAConfig,
    RunIO,
    VGConfig,
)
from deepfbsdejsolvers_tpu.experiments.mfg_comparison import run_mfg_comparison
from deepfbsdejsolvers_tpu.experiments.mfg_poa import run_mfg_poa
from deepfbsdejsolvers_tpu.experiments.pricing import run_pricing


def test_merton_pipeline_artifacts(tmp_path):
    cfg = MertonConfig(
        n_epoch_ext=2, n_epoch=3, batch_size=8,
        methods=("Global", "SumLocalReg"),
        io=RunIO(outdir=str(tmp_path), save_plots=True),
    )
    res = run_pricing(cfg, verbose=False)
    assert set(res.methods) == {"Global", "SumLocalReg"}
    # golden oracle value, cross-checked against scipy in test_pricers.py
    assert res.reference_price == pytest.approx(0.271457, abs=2e-4)
    for r in res.methods.values():
        assert len(r.y0_history) == 2
        assert np.isfinite(r.y0)
    # artifacts
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert any(rec.get("event") == "method_done" for rec in lines)
    assert (tmp_path / "convergence.png").exists()


def test_vg_pipeline_smoke():
    cfg = VGConfig(n_epoch_ext=1, n_epoch=2, batch_size=8, methods=("Global",))
    res = run_pricing(cfg, verbose=False)
    assert np.isfinite(res.methods["Global"].y0)
    assert res.reference_price > 0


@pytest.mark.full
def test_mfg_comparison_pipeline(tmp_path):
    cfg = MFGComparisonConfig(
        n_epoch_ext=1, n_epoch=2, batch_size=16, nb_days=1,
        methods=("Global", "SumLocal"), n_simulation=32,
        io=RunIO(outdir=str(tmp_path), save_plots=True),
    )
    res = run_mfg_comparison(cfg, verbose=False)
    for m in cfg.methods:
        assert np.isfinite(res.methods[m].y0_history[-1])
        # the frozen-noise eval stage (nbSimulation finally used) ran
        assert np.isfinite(res.methods[m].eval_cost)
        assert res.methods[m].eval_ci >= 0.0
    # the CSVs the reference expected but never wrote (mainMFGComparison:146-147)
    hist = np.loadtxt(tmp_path / "Y0List.csv", delimiter=",")
    assert hist.shape[0] == 2
    assert (tmp_path / "mfg_convergence.png").exists()


@pytest.mark.full
def test_mfg_poa_pipeline(tmp_path):
    cfg = MFGPoAConfig(
        n_epoch_ext=1, n_epoch=2, batch_size=16, nb_days=1,
        n_frozen=16, n_replay=2, pi_list=(0.1,),
        cases={"with jumps and with dynamic pricing":
               (6.159423723, 87.4286117, 0.0, 1e4)},
        io=RunIO(outdir=str(tmp_path), save_plots=True),
    )
    res = run_mfg_poa(cfg, verbose=False)
    assert len(res.cells) == 1
    cell = res.cells[0]
    assert np.isfinite(cell.poa)
    assert [row["pi"] for row in res.table()] == [0.1]
    with open(tmp_path / "poa_table.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and float(rows[0]["pi"]) == 0.1
    assert float(rows[0]["PoA"]) == pytest.approx(cell.poa)
    assert os.path.exists(tmp_path / "simulations_all_cases.pdf")


def test_cli_parser_reference_flags():
    """Reference users' command lines parse verbatim (flag-name parity)."""
    from deepfbsdejsolvers_tpu.experiments.cli import build_parser

    p = build_parser()
    a = p.parse_args(["merton", "--nbNeuron", "21", "--nEpochExt", "120",
                      "--batchSize", "10", "--lRateY0", "0.0004",
                      "--activation", "tanh", "--aLin", "0.1", "--limit", "30"])
    assert a.cmd == "merton" and a.nbNeuron == 21 and a.limit == 30
    a = p.parse_args(["mfg-poa", "--jumpFac", "12", "--couplage", "OFF",
                      "--method", "Global", "--piList", "0.0", "0.5"])
    assert a.couplage == "OFF" and a.piList == [0.0, 0.5]


def test_cli_parser_round2_flags():
    """Round-2 flags: data-parallel, Y0 readout/init, speed preset, NaN
    guard."""
    from deepfbsdejsolvers_tpu.experiments.cli import build_parser

    p = build_parser()
    a = p.parse_args(["merton", "--dataParallel", "--y0TailAvg", "6",
                      "--y0WarmStart", "--fast", "--debugNans"])
    assert a.dataParallel and a.y0WarmStart and a.debugNans and a.fast
    assert a.y0TailAvg == 6
    assert not hasattr(a, "sweepImpl")
    a = p.parse_args(["mfg-compare", "--dataParallel"])
    assert a.dataParallel


@pytest.mark.full
def test_mfg_poa_pipeline_data_parallel(tmp_path):
    """End-to-end mfg-poa --dataParallel on the virtual 8-device mesh
    (round 4): the full pipeline — coupled training,
    frozen-trajectory replay, PoA table — through the shard_map DP path."""
    cfg = MFGPoAConfig(
        n_epoch_ext=1, n_epoch=2, batch_size=16, nb_days=1,
        n_frozen=16, n_replay=2, pi_list=(0.1,), data_parallel=True,
        cases={"with jumps and with dynamic pricing":
               (6.159423723, 87.4286117, 0.0, 1e4)},
        io=RunIO(outdir=str(tmp_path)),
    )
    res = run_mfg_poa(cfg, verbose=False)
    assert len(res.cells) == 1
    assert np.isfinite(res.cells[0].poa)
    assert os.path.exists(tmp_path / "poa_table.csv")


@pytest.mark.parametrize("sub", ["merton", "vg", "mfg-compare", "mfg-poa",
                                 "bench"])
def test_cli_help_renders(sub):
    """--help must render for every subcommand: the defaults-appending
    formatter %-interpolates help strings, so a bare '%' in any help text
    crashes argparse (it did, for every MFG subcommand, until round 4)."""
    from deepfbsdejsolvers_tpu.experiments.cli import build_parser

    with pytest.raises(SystemExit) as exc:
        build_parser().parse_args([sub, "--help"])
    assert exc.value.code == 0


def _poa_result():
    from deepfbsdejsolvers_tpu.experiments.mfg_poa import PoACell, PoARunResult

    cells = [PoACell(case=c, pi=pi, poa=1.0 + pi, mfg_cost=2.0, mfg_ci=0.1,
                     mfc_cost=1.5, mfc_ci=0.05, evaluators={})
             for c, pi in (("no jumps", 0.1), ("with jumps", 0.5))]
    return PoARunResult(cells=cells)


def test_poa_table_csv_roundtrip(tmp_path):
    from deepfbsdejsolvers_tpu.experiments.mfg_poa import TABLE_COLUMNS

    res = _poa_result()
    res.write_csv(str(tmp_path / "t.csv"))
    with open(tmp_path / "t.csv", newline="") as f:
        reader = csv.DictReader(f)
        assert tuple(reader.fieldnames) == TABLE_COLUMNS
        rows = list(reader)
    assert [r["case"] for r in rows] == ["no jumps", "with jumps"]
    assert [float(r["PoA"]) for r in rows] == [1.1, 1.5]


def test_poa_table_text_is_aligned():
    lines = _poa_result().to_text().splitlines()
    assert len(lines) == 3 and lines[0].split()[0] == "case"
    assert len({len(line) for line in lines}) == 1   # right-aligned columns
    assert "with jumps" in lines[2] and "1.5" in lines[2]


def test_save_plots_without_matplotlib_fails_clearly(monkeypatch):
    import sys

    from deepfbsdejsolvers_tpu.experiments.plots import pyplot

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        pyplot()
