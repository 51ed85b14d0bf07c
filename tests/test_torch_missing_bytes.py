"""DADA's missing_bytes affinity in the port against the reference.

missing_bytes scores a (task, resource) pair with minus the bytes its reads
would move there, each times its path length (``Residency.transfer_hops``:
0 where resident or nowhere yet, 1 through the host, 2 device to device).
Held here, exactly (``==``: the reference negates a zero sum into -0.0):

  * ``Residency.transfer_hops`` against the reference's;
  * the port's scalar form, matrix form and ``affinity_rows`` against
    ``repro.core.affinity``'s on both sides of 32 ready tasks;
  * the scorer's plain version under its ``s_missing`` flag (the layout the
    backend packs) against the reference's rows;
  * whole DADA(0.5) and DADA(0.5)+CP runs over the NT 6 / 8 tile graphs:
    fingerprint, bytes and the audit JSONL line for line.

(The CUDA kernel under the flag is held against this plain version in
test_torch_cuda.py.)"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.core import DADA as RefDADA
from repro.core.affinity import affinity_rows as ref_affinity_rows
from repro.core.affinity import score_missing_bytes as ref_score_missing_bytes
from repro.core.affinity import score_missing_bytes_matrix as ref_missing_bytes_matrix
from repro.core.simulator import Simulator as RefSimulator
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro.linalg.lu import lu_graph as ref_lu_graph
from repro.linalg.qr import qr_graph as ref_qr_graph
from repro.sched import resolve as ref_resolve
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import DADA, Simulator
from repro_torch.core.affinity import (AFFINITIES, MISSING_BYTES, affinity_matrix,
                                       affinity_rows, score_missing_bytes)
from repro_torch.kernels import sched_place as sp
from repro_torch.kernels import sched_score as port
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph
from repro_torch.sched import resolve
from repro_torch.verify import errors, verify_audit
from test_torch_backend import _pair, _ref_rows
from test_torch_cuda import activation_case
from test_torch_score_activation import _no_read_graphs, _score

KERNELS = {
    "cholesky": (ref_cholesky_graph, cholesky_graph),
    "lu": (ref_lu_graph, lu_graph),
    "qr": (ref_qr_graph, qr_graph),
}


def _ready(n_ready, machine_name="paper"):
    """The seeded scoring state of test_torch_backend's ``_pair``, with
    ``n_ready`` ready tasks (beyond its 40 roots and first tasks)."""
    ref_sim, sim, tids = _pair(machine_name, n_tiles=10)
    tids = (tids + [t for t in range(40, 200) if t not in tids])[:n_ready]
    return ref_sim, sim, tids


def _ref_scalar(ref_sim, tids):
    tasks = [ref_sim.graph.tasks[t] for t in tids]
    return np.asarray([[ref_score_missing_bytes(t, r, ref_sim.residency)
                        for r in ref_sim.machine.resources] for t in tasks])


def test_affinities_name_the_new_score():
    assert MISSING_BYTES == "missing_bytes" and AFFINITIES[-1] == MISSING_BYTES
    assert len(set(AFFINITIES)) == 5


@pytest.mark.parametrize("machine_name", ["paper", "scaled"])
def test_transfer_hops_equal_reference(machine_name):
    """Every datum of the seeded state (resident, moved, added copies,
    nowhere) at every memory of the machine, the host included."""
    ref_sim, sim, _ = _pair(machine_name, n_tiles=10)
    sim.residency.add_copy(sim.arrays.data_names[2], -1)  # a host copy beside a device one
    ref_sim.residency.add_copy(ref_sim.arrays.data_names[2], -1)
    mems = sorted({r.mem for r in sim.machine.resources})
    hops = {h: 0 for h in (0, 1, 2)}
    for name in sim.arrays.data_names:
        for mem in mems:
            got = sim.residency.transfer_hops(name, mem)
            assert got == ref_sim.residency.transfer_hops(name, mem)
            hops[got] += 1
    assert all(hops.values())  # each hop count occurs


@pytest.mark.parametrize("n_ready", [1, 3, 31, 32, 40, 120])
@pytest.mark.parametrize("machine_name", ["paper", "scaled"])
def test_host_rows_and_matrix_equal_reference(machine_name, n_ready):
    """The port's scalar form, matrix form and ``affinity_rows`` (scalar
    under 32 tasks, the matrix from 32) equal the reference's scalar and
    matrix forms entry for entry."""
    ref_sim, sim, tids = _ready(n_ready, machine_name)
    resources = sim.machine.resources
    scalar = _ref_scalar(ref_sim, tids)
    matrix = ref_missing_bytes_matrix(ref_sim.arrays, np.asarray(tids), ref_sim.machine.resources,
                                      ref_sim.residency)
    rows = np.asarray(ref_affinity_rows(MISSING_BYTES, ref_sim.arrays, tids,
                                        [ref_sim.graph.tasks[t] for t in tids],
                                        ref_sim.machine.resources, ref_sim.residency))
    assert (scalar == matrix).all() and (rows == scalar).all()
    mine_scalar = np.asarray([[score_missing_bytes(sim.arrays, t, r, sim.residency)
                               for r in resources] for t in tids])
    mine_matrix = affinity_matrix(MISSING_BYTES, sim.arrays, np.asarray(tids), resources,
                                  sim.residency)
    mine_rows = np.asarray(affinity_rows(MISSING_BYTES, sim.arrays, tids, resources, sim.residency))
    for got in (mine_scalar, mine_matrix, mine_rows):
        assert got.shape == scalar.shape and (got == scalar).all()
    assert (scalar <= 0).all() and (scalar < 0).any()
    # the same sign of zero as the reference's form on each side of 32
    want_rows = scalar if n_ready < 32 else matrix
    assert (np.signbit(mine_rows) == np.signbit(want_rows)).all()


@pytest.mark.parametrize("use_cp", [False, True], ids=["nocp", "cp"])
@pytest.mark.parametrize("n_ready", [1, 40])
@pytest.mark.parametrize("machine_name", ["paper", "scaled"])
def test_plain_scorer_S_equals_reference(machine_name, n_ready, use_cp):
    """The backend's packing with the ``s_missing`` flag: the plain
    version's S equals the reference's rows, C and X are unchanged."""
    ref_sim, sim, tids = _pair(machine_name, n_ready=n_ready)
    X_ref, S_ref, p_cpu, p_gpu, base = _ref_rows(ref_sim, tids, MISSING_BYTES)
    got = _score(sim, tids, use_cp=use_cp, affinity=MISSING_BYTES, x_rows=use_cp,
                 p=(p_cpu, p_gpu))
    assert (got["S"] == S_ref).all() and (got["S"] <= 0).all()
    assert (got["C"] == (base + X_ref if use_cp else base)).all()
    if use_cp:
        assert (got["X"] == X_ref).all()
    # no task prefers a resource under this score
    assert sp.preferences(got["S"], got["C"].tolist(), tids) == []


def test_plain_scorer_S_on_tasks_without_reads():
    """A task with no read scores -0.0 everywhere, as the reference's
    scalar form; data that exists nowhere costs 0 hops."""
    from repro.core import Simulator as RefSim

    ref_g, g = _no_read_graphs()
    ref_sim = RefSim(ref_g, ref_paper_machine(3), RefDADA(alpha=0.5, backend="numpy"), seed=0)
    sim = Simulator(g, paper_machine(3), DADA(alpha=0.5, device="cpu"), seed=0)
    for s in (ref_sim, sim):
        s.residency.write("a", 1)
        s.residency.add_copy("b", 2)
    tids = [0, 1, 2, 3, 4]
    scalar = _ref_scalar(ref_sim, tids)
    got = _score(sim, tids, use_cp=False, affinity=MISSING_BYTES)
    assert (got["S"] == scalar).all()
    assert np.signbit(got["S"][:3]).all() and not got["S"][:3].any()
    assert (got["S"][4] < 0).all()


def test_spec_refuses_missing_without_S():
    with pytest.raises(ValueError, match="s_missing"):
        port.ScoreSpec(n=2, nnz_r=0, nnz_w=0, n_u=3, n_res=4, want_c=True, s_missing=True)
    with pytest.raises(ValueError, match="s_missing"):
        port.ScoreSpec(n=2, nnz_r=0, nnz_w=3, n_u=3, n_res=4, want_s=True, accel_only=True,
                       s_missing=True)
    spec = port.ScoreSpec(n=2, nnz_r=0, nnz_w=3, n_u=3, n_res=4, want_s=True, s_missing=True)
    assert spec.flags == port.FLAG_S | port.FLAG_S_MISSING


@pytest.mark.parametrize("want_x,x_rows,want_c", [(False, False, False), (False, False, True),
                                                  (True, False, True), (True, True, True)])
def test_plain_scorer_missing_fold_by_hand(want_x, x_rows, want_c):
    """A seeded packed activation (masks with nowhere and host-only data,
    reads of size 0, a task with no accesses) under the flag: S is minus
    the in-order hop fold of the weights, computed here by loops."""
    layout, packed, machine = activation_case(5, 12, 9, 14, want_x=want_x, x_rows=x_rows,
                                              want_c=want_c, s_missing=True)
    out = port.score_activation_plain(torch.from_numpy(packed), layout, torch.from_numpy(machine))
    S = port.unpack_outputs(out.numpy(), layout)["S"]
    got_in = port.unpack(packed, layout.inputs)
    m = port.unpack(machine, layout.machine)
    indptr, masks, w = got_in["w_indptr"], got_in["w_masks"], got_in["w_weights"]
    for i in range(layout.spec.n):
        for r, u in enumerate(m["col_of"]):
            shift, hc = int(m["mem_shift"][u]), bool(m["host_col"][u])
            acc = 0.0
            for k in range(indptr[i], indptr[i + 1]):
                mk = int(masks[k])
                hops = 0.0 if mk == 0 or (mk >> shift) & 1 else (1.0 if hc or mk & 1 else 2.0)
                acc = acc + hops * float(w[k])
            assert S[i, r] == -acc and np.signbit(S[i, r]) == np.signbit(-acc)
    assert np.signbit(S[1]).all()  # task 1 has no access: -0.0


# ---------------------------------------------------------------------------
# whole runs


def _fp(res):
    return (
        res.makespan, res.total_bytes, res.n_transfers, tuple(sorted(res.busy.items())),
        tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals),
    )


@pytest.mark.parametrize("n_gpus", [3, 8])
@pytest.mark.parametrize("use_cp", [False, True], ids=["dada", "dada+cp"])
@pytest.mark.parametrize("nt", [6, 8])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_dada_missing_bytes_run_equals_reference(kernel, nt, use_cp, n_gpus, tmp_path):
    """DADA(0.5)(+CP) with ``affinity="missing_bytes"``, audited: the
    port's run and audit JSONL equal the reference's, 0 verifier errors."""
    ref_build, build = KERNELS[kernel]
    ref = RefSimulator(ref_build(nt, 256, with_fns=False), ref_paper_machine(n_gpus),
                       RefDADA(alpha=0.5, use_cp=use_cp, affinity=MISSING_BYTES, backend="numpy"),
                       seed=7, noise=0.03, audit=True)
    strat = DADA(alpha=0.5, use_cp=use_cp, affinity=MISSING_BYTES, device="cpu")
    port_sim = Simulator(build(nt, 256), paper_machine(n_gpus), strat, seed=7, noise=0.03,
                         audit=True)
    ref_res, res = ref.run(), port_sim.run()
    assert _fp(res) == _fp(ref_res) and res.strategy == ref_res.strategy
    ref.audit.to_jsonl(str(tmp_path / "ref.jsonl"))
    port_sim.audit.to_jsonl(str(tmp_path / "port.jsonl"))
    want = Path(tmp_path / "ref.jsonl").read_text().splitlines()
    got = Path(tmp_path / "port.jsonl").read_text().splitlines()
    assert got == want
    assert errors(verify_audit(port_sim.audit)) == []


@pytest.mark.parametrize("min_wide", [1, 1000])
def test_missing_bytes_spec_resolves_and_runs_like_the_reference(min_wide):
    """The registry spec, both placement paths of the port (the backend's
    from width 1, the host rows and plain search below ``min_wide``)."""
    spec = "dada?alpha=0.5&affinity=missing_bytes"
    strat = resolve(spec, device="cpu", min_wide=min_wide)
    assert isinstance(strat, DADA) and strat.affinity_name == MISSING_BYTES
    ref_res = RefSimulator(ref_cholesky_graph(8, 256, with_fns=False), ref_paper_machine(4),
                           ref_resolve(spec), seed=3).run()
    res = Simulator(cholesky_graph(8, 256), paper_machine(4), strat, seed=3).run()
    assert _fp(res) == _fp(ref_res)
