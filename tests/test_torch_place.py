"""The placement of one activation: DADA's λ search and HEFT's EFT scan
(``repro_torch.kernels.sched_place``) against the reference's own jitted
functions, exactly.

The reference is reached through a ``JaxScoringBackend`` built without
its ``__init__`` (``object.__new__``, with x64 scoped by
``jax.enable_x64``): its jitted ``dada_lambda_search`` at depths 1 and 5
and its jitted ``heft_select`` run here on the CPU, on the same seeded
inputs as the port's plain versions. Nothing in ``repro`` is changed. The
inputs are quantized to multiples of 1/8 so that scores, loads and
finish times tie, and HEFT's finish times are nudged by a few ulps so
that candidates fall within and just outside its 1e-15 margin. The
tolerance is exact: λ, rids, loads and finish times compare with ``==``.

Also here: the final build at λ against the reference's host
``try_build`` (the function it replaces, copied below from
``repro/core/dada.py``), the liveness inputs (dead and noticed
resources) against the reference's scalar path (its preferences, cost
rows, area bound and serial bisection, copied below likewise), the packed placement section's round trip, the
wrappers on CPU tensors against the plain versions, the buffer the
backend packs for the card against its CPU placement, and the refusals. (The CUDA kernels are held against
the plain versions in test_torch_cuda.py.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _place_cases import (
    LIVE_KINDS,
    MACHINES,
    MID_ROUND,
    TINY,
    dada_case,
    heft_case,
    live_case,
    live_heft_case,
    packed_dada,
    packed_heft,
    plain_kwargs,
)
from repro.core.backend import JaxScoringBackend, _bucket
from repro_torch.kernels import sched_place as sp
from repro_torch.kernels import sched_score as ss

N_GROUPS, PER_GROUP = 20, 10  # 200 DADA activations
HEFT_GROUPS, HEFT_PER_GROUP = 10, 20  # 200 HEFT activations


class _Res:
    def __init__(self, accel):
        self.is_accelerator = accel


@pytest.fixture(scope="module")
def ref_backend():
    """The reference's scoring backend without its constructor (which
    needs ``jax.experimental.enable_x64``, gone from current jax)."""
    be = object.__new__(JaxScoringBackend)
    be.jax, be.jnp = jax, jnp
    be._search_fns, be._heft_fns = {}, {}
    be._x64 = jax.enable_x64
    be.depth = 1
    return be


# --- the reference's host side, as repro/core/dada.py computes it -------------


def ref_cost_rows(case):
    """C as the scalar path forms it: a noticed column pays its remaining
    window after C is formed (repro/core/dada.py:203-208)."""
    C_rows = [list(row) for row in case["C"]]
    for j, p in enumerate(case.get("pen") or ()):
        if p > 0.0:
            for row in C_rows:
                row[j] += p
    return C_rows


def ref_by_score(case):
    """The preferences (repro/core/dada.py:253-277, the scalar path): the
    scan skips the detached and, under recover, the noticed columns."""
    pref = []
    skip = case.get("skip") or [False] * len(case["offsets"])
    C_rows = ref_cost_rows(case)
    if case["alpha"] > 0.0:
        for i, row in enumerate(case["S"].tolist()):
            if not any(row):
                continue
            best_score, best_rid = 0.0, -1
            for rid in range(len(row)):
                if skip[rid]:
                    continue
                if row[rid] > best_score + TINY:
                    best_score, best_rid = row[rid], rid
            if best_rid >= 0:
                pref.append((best_score, case["tids"][i], best_rid, C_rows[i][best_rid]))
    return sorted(pref, key=lambda x: (-x[0], x[1]))


def ref_upper(case):
    worst_xfer = 0.0
    for v in case["x_max"] or ():
        worst_xfer += v
    return (sum(max(pc, pg) for pc, pg in zip(case["p_cpu"], case["p_gpu"]))
            + case["max_off"] + worst_xfer + TINY)


def ref_try_build(case, lam):
    """``try_build`` of repro/core/dada.py:313-425: the area bound counts
    the alive resources (:310, :322)."""
    p_cpu, p_gpu, C_rows, tids = case["p_cpu"], case["p_gpu"], ref_cost_rows(case), case["tids"]
    cpu_rids, gpu_rids = case["cpu_rids"], case["gpu_rids"]
    any_rids = cpu_rids or gpu_rids
    have_both, no_cpus, no_gpus = bool(cpu_rids and gpu_rids), not cpu_rids, not gpu_rids
    alpha, n = case["alpha"], case["n"]
    all_idx = list(range(n))
    cap = (2.0 + alpha) * lam + TINY
    if case["max_off"] > cap:
        return None
    if case["area_bound"]:
        if case["area"] > (lam * case.get("n_alive", len(case["offsets"]))
                           - case["off_total"]) + TINY:
            return None
    loads = case["offsets"].copy()
    assign = {}
    by_score = ref_by_score(case)
    if by_score:
        budget = alpha * lam + TINY
        for sc, tid, rid, c in by_score:
            if loads[rid] <= budget:
                assign[tid] = rid
                v = loads[rid] + c
                if v > cap:
                    return None
                loads[rid] = v
    rem = [i for i in all_idx if tids[i] not in assign] if assign else all_idx
    for i in rem:
        if (no_cpus or p_cpu[i] > lam) and (no_gpus or p_gpu[i] > lam):
            return None

    def eft(i, pool):
        best_v, best_rid = float("inf"), pool[0]
        for rid in pool:
            v = loads[rid] + C_rows[i][rid]
            if v < best_v:
                best_v, best_rid = v, rid
        if best_v > cap:
            return False
        assign[tids[i]] = best_rid
        loads[best_rid] = best_v
        return True

    flex = None
    if have_both:
        flex = bytearray(n)
        for i in rem:
            if p_cpu[i] > lam:
                pool = gpu_rids
            elif p_gpu[i] > lam:
                pool = cpu_rids
            else:
                flex[i] = 1
                continue
            if not eft(i, pool):
                return None
    else:
        for i in rem:
            if not eft(i, any_rids):
                return None
    if flex is not None:
        for i in case["flex_order"]:
            if not flex[i]:
                continue
            g = gpu_rids[0]
            gl = loads[g]
            for rid in gpu_rids[1:]:
                if loads[rid] < gl:
                    gl, g = loads[rid], rid
            if gl <= lam + TINY:
                v = gl + C_rows[i][g]
                if v > cap:
                    return None
                assign[tids[i]] = g
                loads[g] = v
                continue
            if not eft(i, any_rids):
                return None
    return assign, loads


def ref_search(be, case, depth):
    """The reference's jitted λ search on the same inputs."""
    n, n_res = case["n"], len(case["accel"])
    with jax.enable_x64(True):
        C = np.zeros((_bucket(n), n_res))
        C[:n] = case["C"]
        C_dev = jnp.asarray(C)
    be.depth = depth
    return be.dada_lambda_search(
        n=n, n_res=n_res, offsets=case["offsets"], C_dev=C_dev, p_cpu=case["p_cpu"],
        p_gpu=case["p_gpu"], by_score=ref_by_score(case),
        tid_index={tid: i for i, tid in enumerate(case["tids"])}, flex_order=case["flex_order"],
        resources=[_Res(a) for a in case["accel"]],
        have_both=bool(case["cpu_rids"] and case["gpu_rids"]), no_cpus=not case["cpu_rids"],
        no_gpus=not case["gpu_rids"], alpha=case["alpha"], area_bound=case["area_bound"],
        area=case["area"], off_total=case["off_total"], max_off=case["max_off"],
        eps_rel=case["eps_rel"], max_iters=case["max_iters"], upper0=ref_upper(case),
    )


@pytest.mark.parametrize("depth", [1, 5])
@pytest.mark.parametrize("group", range(N_GROUPS))
def test_dada_search_and_build_match_reference(ref_backend, group, depth):
    """λ equals the reference's jitted search, and the placement equals
    the reference's try_build at that λ, bit for bit."""
    for seed in range(group * PER_GROUP, (group + 1) * PER_GROUP):
        case = dada_case(seed)
        got = sp.dada_place_plain(**plain_kwargs(case))
        lam = ref_search(ref_backend, case, depth)
        assert got.status == sp.STATUS_OK
        assert got.lam == lam, (seed, got.lam, lam)
        built = ref_try_build(case, lam)
        assert built is not None
        assign, loads = built
        assert got.rids == [assign[t] for t in case["tids"]], seed
        assert got.loads == loads, seed


@pytest.mark.parametrize("depth", [1, 3, 5])
@pytest.mark.parametrize("seed,max_iters,eps_rel", MID_ROUND,
                         ids=[f"s{s}-it{m}-eps{e}" for s, m, e in MID_ROUND])
def test_dada_search_stopping_mid_round_matches_reference(ref_backend, seed, max_iters, eps_rel,
                                                          depth):
    """Searches that stop partway through a round of the midpoint tree, by
    the iteration limit (2..7) or by the stopping rule between two levels:
    λ and the placement equal the reference's jitted search at depths 1, 3
    and 5 (one walk of up to ``depth`` levels a round, the rule re-checked
    before each), bit for bit, and the probes stay within the limit."""
    for kind, accel in MACHINES.items():
        case = dada_case(seed, n=37, accel=accel, max_iters=max_iters, eps_rel=eps_rel)
        got = sp.dada_place_plain(**plain_kwargs(case))
        lam = ref_search(ref_backend, case, depth)
        assert got.status == sp.STATUS_OK
        assert got.lam == lam, (kind, got.lam, lam)
        assert got.iters <= max_iters
        assign, loads = ref_try_build(case, lam)
        assert got.rids == [assign[t] for t in case["tids"]], kind
        assert got.loads == loads, kind


def test_mid_round_cases_stop_between_levels():
    """The mid-round cases reach every iteration limit from 2 to 7 and
    stop by the rule at probe counts that are no multiple of 5 (a depth-5
    round cut short), on every machine kind."""
    by_limit, by_rule = set(), set()
    for seed, max_iters, eps_rel in MID_ROUND:
        for accel in MACHINES.values():
            got = sp.dada_place_plain(**plain_kwargs(dada_case(
                seed, n=37, accel=accel, max_iters=max_iters, eps_rel=eps_rel)))
            (by_limit if got.iters == max_iters else by_rule).add(got.iters)
    assert set(range(2, 8)) <= by_limit
    assert {2, 3, 4, 6, 7, 8, 9, 11} <= by_rule


def test_dada_cases_cover_the_matrix():
    """The 200 activations reach every machine kind, α, ±CP, ±area
    bound, both iteration limits, ties among the preferences, rows
    without affinity, dedicated tasks and bisections that stop at once."""
    seen = set()
    for seed in range(N_GROUPS * PER_GROUP):
        c = dada_case(seed)
        kind = "both" if c["cpu_rids"] and c["gpu_rids"] else ("cpu" if c["cpu_rids"] else "gpu")
        seen |= {("kind", kind), ("alpha", c["alpha"]), ("cp", c["use_cp"]),
                 ("area", c["area_bound"]), ("iters", c["max_iters"])}
        if c["S"] is not None:
            best = sorted(s for s, *_ in ref_by_score(c))
            seen.add(("score tie", len(best) != len(set(best))))
            seen.add(("no affinity", bool((c["S"].max(axis=1) == 0).any())))
        if max(c["p_cpu"]) > 32 or max(c["p_gpu"]) > 16:
            seen.add(("dedicated", True))
    want = {("kind", k) for k in MACHINES} | {("alpha", a) for a in (0.0, 0.5, 1.0)}
    want |= {("cp", False), ("cp", True), ("area", False), ("area", True), ("iters", 1),
             ("iters", 30), ("score tie", True), ("no affinity", True), ("dedicated", True)}
    assert want <= seen


def ref_serial_search(case):
    """The scalar path's λ search (repro/core/dada.py:429-499): the upper
    bound, plus n times the largest notice penalty (:444-447), then the
    bisection over ``try_build``; (λ, the placement at it)."""
    upper = ref_upper(case)
    pen = [p for p in case.get("pen") or () if p > 0.0]
    if pen:
        upper += case["n"] * max(pen)
    lower, kept, it = 0.0, None, 0
    while upper - lower > case["eps_rel"] * upper and it < case["max_iters"]:
        lam = (upper + lower) / 2.0
        built = ref_try_build(case, lam)
        if built is not None:
            upper, kept = lam, built
        else:
            lower = lam
        it += 1
    if kept is None:
        kept = ref_try_build(case, upper)
    return upper, kept


@pytest.mark.parametrize("kind", LIVE_KINDS)
@pytest.mark.parametrize("group", range(4))
def test_dada_liveness_matches_the_reference_scalar_path(group, kind):
    """On a machine that lost resources the plain DADA equals the
    reference's scalar path bit for bit (λ, rids, loads): a dead rid 0,
    every GPU or every CPU dead but one, noticed columns paying their
    window under recover, a dead and a noticed one together; over every
    machine kind, α, ±CP and ±area bound. No placement lands on a dead
    rid, and with recover no preference points at a noticed one."""
    for seed in range(group * 25, (group + 1) * 25):
        case = live_case(seed, kind, area_bound=bool(seed % 2) if seed % 3 else None)
        got = sp.dada_place_plain(**plain_kwargs(case))
        lam, (assign, loads) = ref_serial_search(case)
        assert got.status == sp.STATUS_OK
        assert got.lam == lam, (seed, kind, got.lam, lam)
        assert got.rids == [assign[t] for t in case["tids"]], (seed, kind)
        assert got.loads == loads, (seed, kind)
        dead = {j for j, sk in enumerate(case["skip"]) if sk and case["pen"][j] == 0.0}
        assert not dead & set(got.rids), (seed, kind)
        noticed = {j for j, p in enumerate(case["pen"]) if p > 0.0}
        assert not noticed & {rid for _, _, rid, _ in ref_by_score(case)}


def test_liveness_cases_cover_the_matrix():
    """The liveness cases reach every pattern on CPU+GPU, CPU-only and
    GPU-only machines, with ±CP, ±area bound and α 0 / 0.5 / 1, and the
    penalties change placements against the same case without them."""
    seen, moved = set(), 0
    for kind in LIVE_KINDS:
        for seed in range(100):
            c = live_case(seed, kind, area_bound=bool(seed % 2) if seed % 3 else None)
            machine = "both" if c["accel"] == MACHINES["both"] else (
                "cpu" if not any(c["accel"]) else "gpu")
            seen |= {(kind, machine), ("cp", c["use_cp"]), ("area", c["area_bound"]),
                     ("alpha", c["alpha"])}
            if kind == "noticed":
                plain = {k: v for k, v in plain_kwargs(c).items() if k not in ("pen", "skip",
                                                                                "n_alive",
                                                                                "pen_top")}
                moved += sp.dada_place_plain(**plain).rids != sp.dada_place_plain(
                    **plain_kwargs(c)).rids
    assert {(k, "both") for k in LIVE_KINDS} <= seen
    assert {("dead0", "cpu"), ("dead0", "gpu"), ("noticed", "cpu"), ("noticed", "gpu")} <= seen
    assert {("cp", False), ("cp", True), ("area", False), ("area", True)} <= seen
    assert {("alpha", 0.0), ("alpha", 0.5), ("alpha", 1.0)} <= seen
    assert moved >= 10


def ref_heft_scalar(case):
    """The reference's scalar EFT loop (repro/core/heft.py:131-147) over
    the case's rows: +inf transfers on dead columns included."""
    load_ts, now = list(case["load_ts"]), case["now"]
    cols = [case["durations"][c] for c in case["cls_of_res"]]
    rids, efts = [], []
    for i in case["order"]:
        xrow = case["X"][i]
        best_eft, best_rid = float("inf"), 0
        for rid in range(len(load_ts)):
            lt = load_ts[rid]
            start = now if now > lt else lt
            eft = start + xrow[rid] + cols[rid][i]
            if eft < best_eft - 1e-15:
                best_eft, best_rid = eft, rid
        load_ts[best_rid] = best_eft
        rids.append(best_rid)
        efts.append(best_eft)
    return rids, efts


@pytest.mark.parametrize("dead,noticed", [((0,), ()), ((0, 2), (1,)), ((1,), (0,)),
                                          ((), (0, 1)), ((0, 1, 3, 4, 5, 6, 7, 8, 9), ())],
                         ids=["dead0", "dead02-noticed1", "dead1-noticed0", "noticed01",
                              "all-but-others-dead"])
def test_heft_liveness_matches_the_reference_scalar_path(dead, noticed):
    """+inf transfer columns (detached resources) and noticed penalties
    through HEFT's scan: the plain scan equals the reference's scalar loop
    bit for bit, and never picks a dead rid while one is alive."""
    for seed in range(60):
        case = live_heft_case(seed, dead=dead, noticed=noticed)
        n_res = len(case["load_ts"])
        got = sp.heft_select_plain(**case)
        assert (got.rids, got.efts) == ref_heft_scalar(case), seed
        gone = {j % n_res for j in dead}
        if len(gone) < n_res:
            assert not gone & set(got.rids), seed
            assert all(e < float("inf") for e in got.efts)


@pytest.mark.parametrize("kind", LIVE_KINDS)
def test_live_section_round_trips_and_wrappers_agree(kind):
    """A live layout's section reads back as packed, its plan counts the
    penalties' shared memory, and the wrapper on CPU tensors equals the
    plain version; packing liveness into a layout without it (or the
    reverse) is refused."""
    for seed in range(0, 60, 7):
        case = live_case(seed, kind)
        layout, buf, scores = packed_dada(case)
        assert layout.spec.live and layout.flags & sp.PLACE_LIVE
        got = sp._plain_inputs(buf.numpy(), scores.numpy(), layout)
        for key, value in plain_kwargs(case).items():
            if key == "S":
                assert (got[key] is None) == (value is None)
                if value is not None:
                    assert np.array_equal(got[key], value)
            elif key == "skip":
                assert [bool(v) for v in got[key]] == value
            else:
                assert got[key] == value, key
        spec = layout.spec
        assert spec.smem_bytes == sp.dada_smem(spec.n, spec.n_res, spec.plan[0], spec.plan[1],
                                               True)
        out = sp.dada_place(buf, scores, layout)
        assert sp.read_placement(out.numpy(), layout) == sp.dada_place_plain(**plain_kwargs(case))
    fields = {k: case[k] for k in ("offsets", "flex_order", "tids", "max_off", "sum_max", "area",
                                   "off_total", "alpha", "eps_rel", "max_iters", "cpu_rids",
                                   "gpu_rids")}
    with pytest.raises(ValueError, match="live"):
        sp.pack_dada(buf.numpy(), layout, **fields)
    plain_layout, plain_buf, _ = packed_dada(dada_case(seed))
    with pytest.raises(ValueError, match="live"):
        sp.pack_dada(plain_buf.numpy(), plain_layout, **{
            **{k: v for k, v in fields.items()}, "cpu_rids": plain_layout.spec.n_cpu * [0],
            "gpu_rids": plain_layout.spec.n_gpu * [0], "offsets": [0.0] * plain_layout.spec.n_res,
            "flex_order": list(range(plain_layout.spec.n)), "tids": list(range(plain_layout.spec.n)),
            **{k: case[k] for k in ("pen", "skip", "n_alive", "pen_top")}})


def ref_heft(be, case):
    cols = np.asarray([case["durations"][c] for c in case["cls_of_res"]]).T  # (n, n_res)
    order = case["order"]
    rids, efts = be.heft_select(cols[order], np.asarray(case["X"])[order], case["load_ts"],
                                case["now"])
    assert efts.dtype == np.float64
    return rids.tolist(), efts.tolist()


@pytest.mark.parametrize("group", range(HEFT_GROUPS))
def test_heft_scan_matches_reference(ref_backend, group):
    for seed in range(group * HEFT_PER_GROUP, (group + 1) * HEFT_PER_GROUP):
        case = heft_case(seed)
        load_ts = list(case["load_ts"])
        got = sp.heft_select_plain(**case)
        assert case["load_ts"] == load_ts  # not modified
        assert (got.rids, got.efts) == ref_heft(ref_backend, case), seed


@pytest.mark.parametrize("gap,want", [(0.0, 0), (5e-16, 0), (9e-16, 0), (2e-15, 1)],
                         ids=["tie", "5e-16", "9e-16", "2e-15"])
def test_heft_constructed_ties(ref_backend, gap, want):
    """A later rid wins only when its finish time is better by more than
    1e-15; the reference agrees."""
    case = dict(X=[[1.0, 1.0 - gap, 1.0]], order=[0], durations=[[0.5]], cls_of_res=[0, 0, 0],
                load_ts=[0.0, 0.0, 0.25], now=0.0)
    got = sp.heft_select_plain(**case)
    assert got.rids == [want]
    assert (got.rids, got.efts) == ref_heft(ref_backend, case)


# --- the packed section, the wrappers on CPU tensors, the refusals ---------------


@pytest.mark.parametrize("seed", range(0, 200, 7))
def test_dada_section_round_trips(seed):
    case = dada_case(seed)
    layout, buf, scores = packed_dada(case)
    got = sp._plain_inputs(buf.numpy(), scores.numpy(), layout)
    want = plain_kwargs(case)
    for key, value in want.items():
        if key == "S":
            assert (got[key] is None) == (value is None)
            if value is not None:
                assert np.array_equal(got[key], value)
        else:
            assert got[key] == value, key
    # the sections follow one another after the scorer's, in order
    off = layout.score.n_in
    for name in sp.PLACE_IN_SECTIONS:
        assert layout.inputs[name][0] == off
        off += layout.inputs[name][1]
    assert off == layout.n_in
    assert len(layout.c_offsets) == 6 + len(sp.PLACE_IN_SECTIONS) + len(sp.PLACE_OUT_SECTIONS)


@pytest.mark.parametrize("seed", range(0, 200, 9))
def test_heft_section_round_trips(seed):
    case = heft_case(seed)
    layout, buf, scores = packed_heft(case)
    assert sp._plain_inputs(buf.numpy(), scores.numpy(), layout) == case


@pytest.mark.parametrize("seed", range(0, 200, 13))
def test_wrappers_on_cpu_tensors_equal_the_plain_versions(seed):
    case = dada_case(seed)
    layout, buf, scores = packed_dada(case)
    before = sp.dada_place.launches
    out = sp.dada_place(buf, scores, layout)
    assert out.dtype == torch.int64 and out.shape == (layout.n_out,)
    assert sp.read_placement(out.numpy(), layout) == sp.dada_place_plain(**plain_kwargs(case))
    hcase = heft_case(seed)
    hlayout, hbuf, hscores = packed_heft(hcase)
    hout = torch.full((hlayout.n_out,), -7, dtype=torch.int64)
    assert sp.heft_select(hbuf, hscores, hlayout, out=hout) is hout
    assert sp.read_placement(hout.numpy(), hlayout) == sp.heft_select_plain(**hcase)
    assert sp.dada_place.launches == before and sp.heft_select.launches == 0


def test_dada_reports_an_infeasible_upper_bound():
    """C larger than the bound allows (a state no scorer gives): every
    build fails, the status says so, rids are -1 and loads 0.0; the
    strategy raises on it."""
    case = dada_case(3)
    case["C"] = [[1e9] * len(row) for row in case["C"]]
    got = sp.dada_place_plain(**plain_kwargs(case))
    assert got.status == sp.STATUS_INFEASIBLE
    assert got.rids == [-1] * case["n"] and got.loads == [0.0] * len(case["offsets"])
    layout, buf, scores = packed_dada(case)
    assert sp.read_placement(sp.dada_place(buf, scores, layout).numpy(), layout) == got


def test_strategy_raises_on_an_infeasible_placement(monkeypatch):
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import DADA, run_simulation
    from repro_torch.linalg.cholesky import cholesky_graph

    strategy = DADA(alpha=0.5, device="cpu")
    monkeypatch.setattr(strategy.backend, "place_dada", lambda *a, **k: sp.DadaPlacement(
        [], [], 1.0, sp.STATUS_INFEASIBLE, 0))
    with pytest.raises(RuntimeError, match="must always be feasible"):
        run_simulation(cholesky_graph(3, 256), paper_machine(2), strategy, seed=0)


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5",
                                  "dada?alpha=0&area_bound=1"])
def test_backend_packing_matches_its_cpu_placement(spec):
    """The buffer the backend packs for the card (the scorer's sections and
    the placement section), run through the scorer and the placement
    wrappers on CPU tensors, gives the placement that place_dada /
    place_heft give with device="cpu" (the plain versions over the host
    values) on the same activation."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve

    sim = Simulator(qr_graph(6, 256), paper_machine(8), resolve(spec, device="cpu"), seed=7)
    for k, name in enumerate(sim.arrays.data_names):  # every third datum on a device
        if k % 3 == 0:
            sim.residency.write(name, k % 8)
    be, res, st = sim.strategy.backend, sim.machine.resources, sim.strategy
    tids = list(range(40))
    sim.load_ts[:] = [0.125 * (j % 5) for j in range(len(res))]
    calls = sp.dada_place_plain.calls + sp.heft_select_plain.calls
    if spec == "heft":
        scan = dict(order=list(range(39, -1, -1)), durations=[[1.0 + t for t in tids],
                    [0.5 + 0.25 * t for t in tids]],
                    cls_of_res=[int(r.is_accelerator) for r in res], load_ts=sim.load_ts, now=0.25)
        want = be.place_heft(sim, tids, res, **scan)
        layout, packed, machine = be.pack(sim, tids, res, use_cp=True, x_rows=True,
                                          place=sp.PlaceSpec("heft", 40, len(res), n_cls=2))
        sp.pack_heft(packed.numpy(), layout, **scan)
        kernel = sp.heft_select
    else:
        p_cpu, p_gpu = [1.0 + t for t in tids], [0.5 + 0.25 * t for t in tids]
        section = dict(
            offsets=[0.0625 * (j % 3) for j in range(len(res))], flex_order=list(range(40)),
            max_off=0.125, sum_max=sum(max(a, b) for a, b in zip(p_cpu, p_gpu)),
            area=sum(min(a, b) for a, b in zip(p_cpu, p_gpu)) if st.area_bound else 0.0,
            off_total=0.0, alpha=st.alpha, eps_rel=st.eps_rel, max_iters=st.max_iters,
            cpu_rids=[r.rid for r in sim.machine.cpus], gpu_rids=[r.rid for r in sim.machine.gpus],
        )
        score_kw = dict(p_cpu=p_cpu, p_gpu=p_gpu, use_cp=st.use_cp,
                        affinity="accel_write" if st.alpha > 0.0 else None)
        want = be.place_dada(sim, tids, res, area_bound=st.area_bound, **score_kw, **section)
        assert want.status == sp.STATUS_OK and min(want.rids) >= 0
        layout, packed, machine = be.pack(sim, tids, res, **score_kw, place=sp.PlaceSpec(
            "dada", 40, len(res), n_cpu=len(section["cpu_rids"]), n_gpu=len(section["gpu_rids"]),
            area_bound=st.area_bound))
        sp.pack_dada(packed.numpy(), layout, tids=tids, **section)
        kernel = sp.dada_place
    scores = ss.score_activation(packed[:layout.score.n_in], layout.score, machine)
    assert sp.read_placement(kernel(packed, scores, layout).numpy(), layout) == want
    assert sp.dada_place_plain.calls + sp.heft_select_plain.calls == calls + 2


@pytest.mark.parametrize("kw", [
    dict(kind="nope", n=1, n_res=1), dict(kind="dada", n=0, n_res=2, n_cpu=1),
    dict(kind="dada", n=2, n_res=2), dict(kind="dada", n=2, n_res=2, n_cpu=3),
    dict(kind="dada", n=2, n_res=2, n_cpu=1, n_cls=1), dict(kind="heft", n=2, n_res=2),
    dict(kind="heft", n=2, n_res=2, n_cls=1, area_bound=True),
    dict(kind="heft", n=2, n_res=2, n_cls=1, n_gpu=1), dict(kind="dada", n=2.0, n_res=2, n_cpu=1),
])
def test_place_spec_refuses_malformed(kw):
    with pytest.raises(ValueError):
        sp.PlaceSpec(**kw)


def test_place_layout_refuses_a_scorer_that_does_not_fit():
    dada = sp.PlaceSpec("dada", 3, 4, n_cpu=2, n_gpu=2)
    heft = sp.PlaceSpec("heft", 3, 4, n_cls=2)
    with pytest.raises(ValueError, match="x 4"):  # another activation
        sp.place_layout(dada, ss.ScoreSpec(n=2, nnz_r=0, nnz_w=0, n_u=1, n_res=4, want_c=True))
    with pytest.raises(ValueError, match="want_c"):  # DADA without C
        sp.place_layout(dada, ss.ScoreSpec(n=3, nnz_r=0, nnz_w=0, n_u=1, n_res=4, want_x=True))
    with pytest.raises(ValueError, match="want_c"):  # DADA with full X rows
        sp.place_layout(dada, ss.ScoreSpec(n=3, nnz_r=0, nnz_w=0, n_u=1, n_res=4, want_x=True,
                                           x_rows=True, want_c=True))
    with pytest.raises(ValueError, match="x_rows"):  # HEFT without X rows
        sp.place_layout(heft, ss.ScoreSpec(n=3, nnz_r=0, nnz_w=0, n_u=1, n_res=4, want_x=True))


def test_pack_refuses_out_of_range_ids():
    case = dada_case(0)
    layout, buf, _ = packed_dada(case)
    fields = {k: case[k] for k in ("offsets", "flex_order", "tids", "max_off", "sum_max", "area",
                                   "off_total", "alpha", "eps_rel", "max_iters", "cpu_rids",
                                   "gpu_rids")}
    for key, bad in (("flex_order", [case["n"]] * case["n"]), ("cpu_rids", [-1] * len(case["cpu_rids"])),
                     ("gpu_rids", [99] * len(case["gpu_rids"])), ("offsets", [0.0])):
        if not len(bad):
            continue
        with pytest.raises(ValueError):
            sp.pack_dada(buf.numpy(), layout, **{**fields, key: bad})
    hcase = heft_case(1)
    hlayout, hbuf, _ = packed_heft(hcase)
    hfields = {k: v for k, v in hcase.items() if k != "X"}
    with pytest.raises(ValueError):
        sp.pack_heft(hbuf.numpy(), hlayout, **{**hfields, "cls_of_res": [2] * len(hcase["cls_of_res"])})
    with pytest.raises(ValueError):
        sp.pack_heft(hbuf.numpy(), hlayout, **{**hfields, "order": [-1] * len(hcase["order"])})
    with pytest.raises(ValueError, match="HEFT layout"):
        sp.pack_heft(buf.numpy(), layout, **hfields)
    with pytest.raises(ValueError, match="DADA layout"):
        sp.pack_dada(hbuf.numpy(), hlayout, **fields)


def test_wrappers_refuse_mismatched_buffers():
    case = dada_case(4)
    layout, buf, scores = packed_dada(case)
    with pytest.raises(ValueError, match="slots"):
        sp.dada_place(buf[:-1], scores, layout)
    with pytest.raises(ValueError, match="slots"):
        sp.dada_place(buf, scores.float(), layout)
    with pytest.raises(ValueError, match="heft"):
        sp.heft_select(buf, scores, layout)
    with pytest.raises(ValueError, match="slots"):
        sp.dada_place(buf, scores, layout, out=torch.empty(layout.n_out + 1, dtype=torch.int64))


def test_shared_memory_envelope():
    """The kernels' envelope, as csrc/sched_place.cu sizes it: the main
    path's widest activation fits many times over, staged whole under a
    depth-5 tree (DADA) or in one pass (HEFT); 12 884 ready tasks at 14
    resources or more than 256 resources (DADA), or more than 512
    resources (HEFT), do not, and a CUDA tensor there is refused."""
    dada = sp.PlaceSpec("dada", 128, 14, n_cpu=6, n_gpu=8)
    assert dada.smem_bytes == (8 * (1 + 14 + 128 + 5 * 128 + 128 * 14)
                               + 4 * (2 * 128 + 3 * 14 + 64) + 2 * 31 * 128)
    assert dada.fits_kernel and dada.plan == (5, 2, dada.smem_bytes)
    heft = sp.PlaceSpec("heft", 128, 14, n_cls=2)
    assert heft.smem_bytes == 8 * (128 * 14 + 2 * 128 + 128) and heft.plan == (128, 1, heft.smem_bytes)
    assert sp.PlaceSpec("dada", 8000, 14, n_cpu=6, n_gpu=8).fits_kernel
    assert sp.PlaceSpec("dada", 12883, 14, n_cpu=6, n_gpu=8).fits_kernel
    assert not sp.PlaceSpec("dada", 12884, 14, n_cpu=6, n_gpu=8).fits_kernel
    assert sp.PlaceSpec("dada", 8, 256, n_gpu=256).fits_kernel
    assert not sp.PlaceSpec("dada", 8, 257, n_gpu=257).fits_kernel
    assert sp.PlaceSpec("heft", 1, 440, n_cls=2).fits_kernel
    assert sp.PlaceSpec("heft", 100_000, 512, n_cls=2).fits_kernel
    assert not sp.PlaceSpec("heft", 1, 513, n_cls=2).fits_kernel


def _one_warp_kernels_took(spec) -> bool:
    """The envelope of the one-warp kernels this sizing replaced: DADA's
    16 n + 4 (3 n + 3 n_res + n_cpu + n_gpu) bytes and at most 256
    resources; HEFT's 16 x 33 bytes a resource."""
    if spec.kind == "heft":
        return 16 * 33 * spec.n_res <= sp.SMEM_LIMIT
    return (spec.n_res <= 256 and 16 * spec.n + 4 * (3 * spec.n + 3 * spec.n_res + spec.n_cpu
                                                      + spec.n_gpu) <= sp.SMEM_LIMIT)


@pytest.mark.parametrize("n_res", [1, 2, 12, 14, 31, 32, 33, 64, 65, 128, 129, 200, 256, 440])
def test_envelope_keeps_every_activation_the_one_warp_kernels_took(n_res):
    """Every placement the one-warp kernels took still fits, at every
    width up to and beyond their edge (n 8 293 at 14 resources)."""
    widths = sorted(set(range(1, 400, 13)) | set(range(400, 13_000, 211)) | {8293, 8294})
    for n in widths:
        specs = [sp.PlaceSpec("heft", n, n_res, n_cls=c) for c in (1, 2, 7)]
        if n_res <= 256:
            specs += [sp.PlaceSpec("dada", n, n_res, n_cpu=c, n_gpu=n_res - c)
                      for c in sorted({0, n_res // 3, n_res})]
        for spec in specs:
            if _one_warp_kernels_took(spec):
                assert spec.fits_kernel, spec
            if spec.fits_kernel:
                assert spec.smem_bytes == spec.plan[2] <= sp.SMEM_LIMIT


@pytest.mark.parametrize("n_res,plan", [(12, (5, 2)), (32, (5, 2)), (33, (5, 2)), (64, (5, 2)),
                                        (65, (5, 2)), (128, (5, 2)), (129, (4, 2)), (256, (4, 1))])
def test_dada_plan_takes_the_deepest_tree_the_registers_allow(n_res, plan):
    """At n 128 the tree is as deep as its class of rids a lane allows (a
    31-warp block leaves 64 registers a thread), with everything staged
    but, at 256 resources, C."""
    spec = sp.PlaceSpec("dada", 128, n_res, n_cpu=n_res // 3, n_gpu=n_res - n_res // 3)
    assert spec.plan[:2] == plan


@pytest.mark.parametrize("n,plan", [(8, (5, 2)), (128, (5, 2)), (1000, (5, 2)), (1500, (5, 1)),
                                    (2000, (5, 0)), (4000, (4, 0)), (8000, (2, 0)),
                                    (12880, (1, 0))])
def test_dada_plan_stages_what_fits_beside_the_tree(n, plan):
    """On paper_machine(8)'s 12 resources: the deepest tree that fits with
    nothing staged, then the most staging beside it (C and the task
    vectors, the task vectors, or nothing: those are read from global
    memory)."""
    spec = sp.PlaceSpec("dada", n, 12, n_cpu=4, n_gpu=8)
    depth, stage, smem = spec.plan
    assert (depth, stage) == plan
    assert smem == sp.dada_smem(n, 12, depth, stage) <= sp.SMEM_LIMIT
    if depth < 5:
        assert sp.dada_smem(n, 12, depth + 1, 0) > sp.SMEM_LIMIT
    if stage < 2:
        assert sp.dada_smem(n, 12, depth, stage + 1) > sp.SMEM_LIMIT


@pytest.mark.parametrize("n,n_res,plan", [(128, 12, (128, 1)), (1700, 14, (1700, 1)),
                                          (1800, 14, (32, 2)), (4000, 440, (16, 2)),
                                          (1, 440, (1, 1)), (100, 512, (14, 2))])
def test_heft_plan_stages_in_one_pass_or_a_ring(n, n_res, plan):
    """The whole activation in one pass where X, the two classes'
    durations and the order fit; else two buffers of up to 32 tasks'
    rows."""
    spec = sp.PlaceSpec("heft", n, n_res, n_cls=2)
    assert spec.plan[:2] == plan
    group, nbuf, smem = spec.plan
    assert smem == (8 * (n * n_res + 3 * n) if nbuf == 1 else 32 * group * n_res)
