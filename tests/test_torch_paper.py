"""The paper's experiment through the port against ``repro``'s.

* ``run_many`` with strategies built for ``device="cpu"`` equals the
  reference's ``run_many(..., n_jobs=1)`` on every ``Summary`` field, name
  included, over {cholesky, lu, qr} at NT 4–6 × {heft, ws, dada(0),
  dada(0.5), dada(0.5)+cp} × 2 and 8 GPUs × 3 seeds.
* The figure sweeps of ``repro_torch.bench`` on both engines equal
  summaries built from the reference's own ``run_many`` / ``run_batch`` on
  the same small graphs, field for field, before rounding.
* C1–C5 on hand-made rows pass or fail where the reference's ``validate``
  does, at each threshold's edge; C6 equals the reference's runs.
"""
import dataclasses
import math
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.core import run_batch as ref_run_batch
from repro.core import run_many as ref_run_many
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro.linalg.lu import lu_graph as ref_lu_graph
from repro.linalg.qr import qr_graph as ref_qr_graph
from repro.sched import resolve as ref_resolve
from repro.sched.config import SchedConfig
from repro_torch.bench import common, figures
from repro_torch.bench import paper_validation as pv
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import run_many
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import paper_validation as ref_pv  # noqa: E402

KERNELS = {  # kernel -> (NT, reference builder, port builder)
    "cholesky": (6, ref_cholesky_graph, cholesky_graph),
    "lu": (5, ref_lu_graph, lu_graph),
    "qr": (4, ref_qr_graph, qr_graph),
}
SPECS = ("heft", "ws", "dada?alpha=0", "dada?alpha=0.5", "dada?alpha=0.5&use_cp=1")
RUNS = 3
GPUS = (2, 8)


def ref_strategy(spec):
    """The reference's policy on its numpy scoring path (``ws`` has none)."""
    return ref_resolve(spec) if spec == "ws" else ref_resolve(spec, backend="numpy")


def fields(summary):
    return dataclasses.asdict(summary)


@pytest.mark.parametrize("n_gpus", GPUS)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_run_many_equals_reference(kernel, spec, n_gpus):
    nt, ref_build, build = KERNELS[kernel]
    want = ref_run_many(partial(ref_build, nt, 256, with_fns=False), ref_paper_machine(n_gpus),
                        partial(ref_strategy, spec), n_runs=RUNS, n_jobs=1)
    got = run_many(partial(build, nt, 256, with_fns=False), paper_machine(n_gpus),
                   partial(common.strategy_for, spec, "cpu"), n_runs=RUNS)
    assert fields(got) == fields(want)
    if spec == "ws":
        assert got.steals_mean > 0  # the ws runs do steal here


def test_run_many_seeds_and_noise_pass_through():
    want = ref_run_many(partial(ref_lu_graph, 4, 256, with_fns=False), ref_paper_machine(3),
                        partial(ref_strategy, "ws"), n_runs=2, noise=0.1, base_seed=7, n_jobs=1)
    got = run_many(partial(lu_graph, 4, 256, with_fns=False), paper_machine(3),
                   partial(common.strategy_for, "ws", "cpu"), n_runs=2, noise=0.1, base_seed=7)
    assert fields(got) == fields(want)
    assert got.row() == want.row()


@pytest.mark.parametrize("spec", ["heft", "ws", "dada?alpha=0.5&use_cp=1"])
def test_run_many_audit_equals_reference(spec, monkeypatch):
    """``run_many(audit=True)`` re-checks every run with the verifier and
    summarizes as the reference does under its audit switch, and as the
    port does with the audit off."""
    from repro_torch.core import api

    monkeypatch.setenv("REPRO_SCHED_AUDIT", "1")  # the reference's switch
    want = ref_run_many(partial(ref_lu_graph, 4, 256, with_fns=False), ref_paper_machine(3),
                        partial(ref_strategy, spec), n_runs=2, n_jobs=1)
    checked, verify = [], api.verify_audit
    monkeypatch.setattr(api, "verify_audit",
                        lambda log: checked.append(len(log.execs)) or verify(log))
    factory = partial(lu_graph, 4, 256, with_fns=False)
    got = run_many(factory, paper_machine(3), partial(common.strategy_for, spec, "cpu"), n_runs=2,
                   audit=True)
    assert checked == [len(factory())] * 2  # both runs' logs, whole
    assert fields(got) == fields(want)
    assert fields(got) == fields(run_many(factory, paper_machine(3),
                                          partial(common.strategy_for, spec, "cpu"), n_runs=2))


def test_sweep_audits_the_exact_engine_and_the_surrogate_refuses(capsys):
    got = common.sweep_summaries("cholesky", {"heft": "heft"}, 2, [2], device="cpu", nt=SWEEP_NT,
                                 tile=256, audit=True)
    assert got == common.sweep_summaries("cholesky", {"heft": "heft"}, 2, [2], device="cpu",
                                         nt=SWEEP_NT, tile=256)
    with pytest.raises(ValueError, match="audit"):
        common.sweep_summaries("cholesky", {"heft": "heft"}, 2, [2], engine="surrogate",
                               device="cpu", nt=SWEEP_NT, tile=256, audit=True)
    with pytest.raises(SystemExit) as e:
        pv.main(["--engine", "surrogate", "--audit", "--device", "cpu"])
    assert e.value.code == 2 and "--audit" in capsys.readouterr().err


def test_single_run_has_no_interval():
    got = run_many(partial(cholesky_graph, 4, 256, with_fns=False), paper_machine(2),
                   partial(common.strategy_for, "heft", "cpu"), n_runs=1)
    assert got.n == 1 and got.gflops_ci95 == got.gbytes_ci95 == 0.0


# ---------------------------------------------------------------------------
# the figure sweeps on both engines

SWEEP_NT = 4
REF_SURROGATE = SchedConfig(backend="jax", pallas="0")


def ref_summaries(kernel, strategies, engine):
    """Summaries of every (GPU count, strategy) built from the reference's
    own run_many / run_batch, reduced as its figure sweeps reduce them."""
    ref_build = KERNELS[kernel][1]
    factory = partial(ref_build, SWEEP_NT, 256, with_fns=False)
    configs = [(n, label, spec) for n in GPUS for label, spec in strategies.items()]
    if engine == "exact":
        return [(n, label, fields(ref_run_many(factory, ref_paper_machine(n),
                                               partial(ref_strategy, spec), n_runs=RUNS, n_jobs=1)))
                for n, label, spec in configs]
    graph = factory()
    items = [{"graph": graph, "machine": ref_paper_machine(n), "strategy": spec,
              "seed": 1234 + i, "noise": 0.03} for n, _, spec in configs for i in range(RUNS)]
    results = ref_run_batch(items, config=REF_SURROGATE)
    out = []
    for k, (n, label, _) in enumerate(configs):
        rs = results[k * RUNS:(k + 1) * RUNS]
        gf = [r.gflops for r in rs]
        gb = [r.gbytes for r in rs]
        out.append((n, label, dict(
            strategy=label, n=RUNS,
            gflops_mean=float(sum(gf) / len(gf)), gflops_ci95=ref_pv_ci95(gf),
            gbytes_mean=float(sum(gb) / len(gb)), gbytes_ci95=ref_pv_ci95(gb),
            makespan_mean=float(sum(r.makespan for r in rs) / len(rs)), steals_mean=0.0)))
    return out


def ref_pv_ci95(xs):
    return 1.96 * float(np.std(xs, ddof=1)) / math.sqrt(len(xs)) if len(xs) > 1 else 0.0


@pytest.mark.parametrize("engine", common.ENGINES)
@pytest.mark.parametrize("fig", sorted(figures.FIGURES))
def test_figure_sweep_equals_reference(fig, engine):
    kernel, strategies = figures.FIGURES[fig]
    got = common.sweep_summaries(kernel, strategies, RUNS, GPUS, engine=engine, device="cpu",
                                 nt=SWEEP_NT, tile=256)
    want = ref_summaries(kernel, strategies, engine)
    assert [(n, label, fields(s)) for n, label, s in got] == want
    rows = [common.row_of(fig, kernel, label, n, s) for n, label, s in got]
    for row, (n, label, s) in zip(rows, want):
        assert row == dict(
            fig=fig, kernel=kernel, strategy=label, n_gpus=n, n_runs=RUNS,
            gflops=round(s["gflops_mean"], 2), gflops_ci95=round(s["gflops_ci95"], 2),
            gbytes=round(s["gbytes_mean"], 4), gbytes_ci95=round(s["gbytes_ci95"], 4),
            makespan_s=round(s["makespan_mean"], 5), steals=round(s["steals_mean"], 1))


def test_figure_strategy_sets():
    assert list(figures.FIGURES) == ["fig1_alpha_sweep", "fig2_cholesky", "fig3_lu", "fig4_qr"]
    fig1 = figures.FIGURES["fig1_alpha_sweep"][1]
    assert list(fig1) == [f"dada({a})" for a in ("0", "0.25", "0.5", "0.75", "1")] + [
        f"dada({a})+cp" for a in ("0", "0.25", "0.5", "0.75", "1")]
    assert fig1["dada(0.25)+cp"] == "dada?alpha=0.25&use_cp=1"
    assert list(common.STRATEGIES.values()) == list(SPECS)


def test_sweep_refusals(monkeypatch):
    with pytest.raises(ValueError, match="engine"):
        common.sweep("fig2_cholesky", "cholesky", common.STRATEGIES, 1, [2], engine="fast")
    with pytest.raises(ValueError, match="unknown policy"):
        common.sweep("f", "cholesky", {"x": "nope"}, 1, [2], device="cpu", nt=2)
    assert common.sweep("f", "cholesky", common.STRATEGIES, 1, [], device="cpu") == []
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in common.ENGINES:  # ws alone would touch no card: the sweep refuses first
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.sweep("f", "cholesky", {"ws": common.STRATEGIES["ws"]}, 1, [2], engine=engine)


@pytest.mark.parametrize("engine", common.ENGINES)
def test_sweep_refuses_more_than_eight_gpus(engine):
    """Both engines run on the paper machine and refuse a GPU count it lacks."""
    with pytest.raises(ValueError, match="at most 8 GPUs"):
        common.sweep("f", "cholesky", {"heft": "heft"}, 1, [12], engine=engine, device="cpu", nt=2)


def test_strategy_for_passes_device_only_where_declared():
    from repro_torch.core import DADA, HEFT
    from repro_torch.runtime.queues import WorkSteal

    assert isinstance(common.strategy_for("ws", "cpu"), WorkSteal)
    h = common.strategy_for("heft", "cpu")
    assert isinstance(h, HEFT) and h.backend.device.type == "cpu"
    d = common.strategy_for("dada?alpha=0.5&use_cp=1", "cpu")
    assert isinstance(d, DADA) and d.name == "dada(0.5)+cp"


# ---------------------------------------------------------------------------
# the claims

def _fig1(lo_gpus, hi_gpus, dada0, dada1, alphas):
    """fig1 rows: dada(0) and dada(1) at lo/hi GPUs, and the α series at hi."""
    rows = [dict(strategy="dada(0)", n_gpus=lo_gpus, gflops=dada0[0]),
            dict(strategy="dada(0)", n_gpus=hi_gpus, gflops=dada0[1]),
            dict(strategy="dada(1)", n_gpus=lo_gpus, gflops=dada1[0])]
    rows += [dict(strategy=f"dada({a:g})", n_gpus=hi_gpus, gflops=g)
             for a, g in zip((0.25, 0.5, 0.75), alphas)]
    rows.append(dict(strategy="dada(1)", n_gpus=hi_gpus, gflops=dada1[1]))
    return rows


def _fig(hi_gpus, **gf_gb):
    return [dict(strategy=s, n_gpus=hi_gpus, gflops=gf, gbytes=gb) for s, (gf, gb) in gf_gb.items()]


def _edge(x):
    """x one ulp below, at and one ulp above."""
    return (np.nextafter(x, -np.inf), x, np.nextafter(x, np.inf))


def _cases():
    base = dict(
        fig1=_fig1(2, 8, (500.0, 600.0), (500.0, 700.0), (650.0, 660.0, 680.0)),
        fig2=_fig(8, heft=(650.0, 4.0), **{"dada(a)": (700.0, 3.9)}),
        fig3=_fig(8, heft=(600.0, 10.0), **{"dada(a)+cp": (600.0, 9.0)}),
        fig4=_fig(8, heft=(650.0, 9.0), **{"dada(0)": (640.0, 9.5), "dada(a)": (645.0, 8.5),
                                           "dada(a)+cp": (650.0, 8.3)}),
    )
    yield "base", base
    for g in _edge(600.0):  # C1: dada(1)'s speedup equal to dada(0)'s at 700 (1.2 vs 1.2)
        yield f"c1-{g!r}", dict(base, fig1=_fig1(2, 8, (500.0, 600.0), (500.0, g), (650.0, 660.0, 680.0)))
    for g in _edge(650.0):  # C2: dada(1) against dada(0.25) at max GPUs
        yield f"c2-{g!r}", dict(base, fig1=_fig1(2, 8, (500.0, 600.0), (500.0, g), (650.0, 660.0, 680.0)))
    for gb in _edge(9.0):  # C3 transfer factor > 1
        yield f"c3b-{gb!r}", dict(base, fig3=_fig(8, heft=(600.0, 9.0), **{"dada(a)+cp": (600.0, gb)}))
    for gf in _edge(480.0):  # C3 perf ratio < 1.25 (600 / 480 = 1.25)
        yield f"c3f-{gf!r}", dict(base, fig3=_fig(8, heft=(600.0, 10.0), **{"dada(a)+cp": (gf, 9.0)}))
    for heft in _edge(650.0 * 0.97):  # C4 heft >= 0.97 x best dual
        yield f"c4-{heft!r}", dict(base, fig4=_fig(8, heft=(heft, 9.0), **{
            "dada(0)": (640.0, 9.5), "dada(a)": (650.0, 8.5), "dada(a)+cp": (600.0, 8.3)}))
    for dada in _edge(650.0 * 0.8):  # C5 dada(a) >= 0.8 x heft
        yield f"c5-{dada!r}", dict(base, fig2=_fig(8, heft=(650.0, 4.0), **{"dada(a)": (dada, 3.9)}))


CASES = dict(_cases())


@pytest.mark.parametrize("case", list(CASES))
def test_claims_pass_where_the_reference_does(case, monkeypatch):
    figs = CASES[case]
    # the reference's validate runs C6-C8 after C5: stop it there
    monkeypatch.setattr(ref_pv, "_validate_c6", lambda checks, n_runs: checks)
    want = ref_pv.validate(figs["fig1"], figs["fig2"], figs["fig3"], figs["fig4"])
    got = pv.validate_rows(figs["fig1"], figs["fig2"], figs["fig3"], figs["fig4"])
    assert [(c["claim"], c["measured"], c["passed"]) for c in got] == [
        (c["claim"], c["measured"], c["passed"]) for c in want]
    assert len(got) == 5


def test_claim_edges_flip():
    """Each edge case family holds a pass and a fail (the edges are real)."""
    for prefix, k in (("c1", 0), ("c2", 1), ("c3b", 2), ("c3f", 2), ("c4", 3), ("c5", 4)):
        outcomes = {pv.validate_rows(*CASES[c].values())[k]["passed"]
                    for c in CASES if c.startswith(prefix + "-")}
        assert outcomes == {True, False}, prefix


def test_c1_c2_skip_without_their_rows():
    figs = CASES["base"]
    got = pv.validate_rows([r for r in figs["fig1"] if r["strategy"] != "dada(1)"],
                           figs["fig2"], figs["fig3"], figs["fig4"])
    assert [c["claim"][:2] for c in got] == ["C3", "C4", "C5"]


def test_c6_equals_reference_runs():
    n = 2
    small = partial(ref_cholesky_graph, 8, 512, with_fns=False)
    ws = ref_run_many(small, ref_paper_machine(4), partial(ref_strategy, "ws"), n, n_jobs=1)
    da = ref_run_many(small, ref_paper_machine(4), partial(ref_strategy, "dada?alpha=0.5"), n, n_jobs=1)
    got = pv.check_c6(n, device="cpu")
    assert fields(got["ws"]) == fields(ws) and fields(got["dada"]) == fields(da)
    assert got["passed"] == (da.gflops_mean > ws.gflops_mean)
    assert got["measured"] == (f"ws {ws.gflops_mean:.0f}GF/{ws.gbytes_mean:.2f}GB vs "
                               f"dada(a) {da.gflops_mean:.0f}GF/{da.gbytes_mean:.2f}GB")
    assert got["ws"].steals_mean > 0


def test_validate_runs_c1_to_c6():
    figs = CASES["base"]
    checks = pv.validate(*figs.values(), n_runs=1, device="cpu")
    assert [c["claim"][:2] for c in checks] == ["C1", "C2", "C3", "C4", "C5", "C6"]
    assert checks[:5] == pv.validate_rows(*figs.values())


def test_main_refuses_empty_gpus(capsys):
    with pytest.raises(SystemExit) as e:
        pv.main(["--gpus", ",", "--device", "cpu"])
    assert e.value.code == 2 and "at least one GPU count" in capsys.readouterr().err


def test_main_prints_rows_claims_and_walls(capsys, monkeypatch):
    """The CLI end to end on the CPU, its figures cut to NT 4."""
    monkeypatch.setattr(pv, "run_figures", partial(pv.run_figures, nt=SWEEP_NT, tile=256))
    rc = pv.main(["--engine", "surrogate", "--runs", "2", "--gpus", "2,8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(" gpus=") == (10 + 3 * 5) * 2
    for claim in ("C1", "C2", "C3", "C4", "C5", "C6"):
        assert f"] {claim} " in out
    assert "] C7 " in out and "verifier errors 0" in out  # C7 runs on the exact engine
    assert "configs/s" in out and "fig4_qr: wall" in out
    # C8 and the two verifier rows run on the exact engine too
    assert "] C8 " in out and out.count("] CV ") == 2 and "C8 and CV" in out
    assert rc == (1 if "[FAIL]" in out else 0)
