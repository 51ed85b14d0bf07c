"""The port's scoring backend against the reference's numpy formulas:
``TorchScoringBackend(device="cpu").score_matrices`` gives transfer
times ``X``, affinity ``S`` and cost ``C`` bit-equal to ``repro``'s host
rows (as ``tests/test_backend.py`` asserts for the jax backend), with and
without a pressure bias, and the port's own host rows (the path of
activations narrower than ``min_wide``) are bit-equal too."""
import numpy as np
import pytest

from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.configs.paper_machine import scaled_machine as ref_scaled_machine
from repro.core import DADA as RefDADA
from repro.core import Simulator as RefSimulator
from repro.core.affinity import affinity_rows as ref_affinity_rows
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro_torch.configs.paper_machine import paper_machine, scaled_machine
from repro_torch.core import DADA, Simulator
from repro_torch.core.affinity import RESIDENT_WEIGHTED, affinity_rows
from repro_torch.core.backend import TorchScoringBackend
from repro_torch.linalg.cholesky import cholesky_graph


def _pair(machine_name, n_tiles=8, n_ready=None):
    """The same seeded scoring state in both packages: graph, machine,
    residency (every third datum moved to a device memory) and ready set."""
    if machine_name == "scaled":
        ref_m, m, n_mem = ref_scaled_machine(n_gpus=12, n_cpus=4), scaled_machine(n_gpus=12, n_cpus=4), 12
    else:
        ref_m, m, n_mem = ref_paper_machine(8), paper_machine(8), 8
    ref_g = ref_cholesky_graph(n_tiles, 256, with_fns=False)
    ref_sim = RefSimulator(ref_g, ref_m, RefDADA(alpha=0.5, use_cp=True, backend="numpy"), seed=0)
    sim = Simulator(cholesky_graph(n_tiles, 256), m, DADA(alpha=0.5, use_cp=True, device="cpu"), seed=0)
    for k, name in enumerate(ref_sim.arrays.data_names):
        if k % 3 == 0:
            ref_sim.residency.write(name, k % n_mem)
            sim.residency.write(name, k % n_mem)
        elif k % 3 == 1:
            ref_sim.residency.add_copy(name, (k + 1) % n_mem)
            sim.residency.add_copy(name, (k + 1) % n_mem)
    roots = [t.tid for t in ref_g.tasks if not ref_g.pred[t.tid]]
    tids = sorted(set(roots) | set(range(40)))
    if n_ready is not None:
        tids = tids[:n_ready]
    return ref_sim, sim, tids


def _ref_rows(ref_sim, tids, affinity):
    resources = ref_sim.machine.resources
    X = np.asarray(ref_sim.transfer_model.task_input_transfer_rows(
        ref_sim.arrays, tids, [r.mem for r in resources], ref_sim.residency
    ))
    S = np.asarray(ref_affinity_rows(
        affinity, ref_sim.arrays, tids, [ref_sim.graph.tasks[t] for t in tids],
        resources, ref_sim.residency,
    ))
    m = ref_sim.machine
    p_cpu = ref_sim.predictor(m.cpus[0].cls).times(np.asarray(tids)).tolist()
    p_gpu = ref_sim.predictor(m.gpus[0].cls).times(np.asarray(tids)).tolist()
    gpu_col = np.asarray([r.is_accelerator for r in resources])
    base = np.where(gpu_col[None, :], np.asarray(p_gpu)[:, None], np.asarray(p_cpu)[:, None])
    return X, S, p_cpu, p_gpu, base


@pytest.mark.parametrize("affinity", RESIDENT_WEIGHTED)
@pytest.mark.parametrize("machine_name", ["scaled", "paper"])
def test_fused_matrices_bitwise_equal_numpy(machine_name, affinity):
    ref_sim, sim, tids = _pair(machine_name)
    X_ref, S_ref, p_cpu, p_gpu, base = _ref_rows(ref_sim, tids, affinity)
    m = sim.machine
    assert sim.predictor(m.cpus[0].cls).times(np.asarray(tids)).tolist() == p_cpu
    be = TorchScoringBackend(device="cpu")
    fused = be.score_matrices(
        sim, tids, m.resources, p_cpu=p_cpu, p_gpu=p_gpu,
        use_cp=True, affinity=affinity, x_rows=True,
    )
    assert (fused["X_np"] == X_ref).all()
    assert (fused["S_np"] == S_ref).all()
    assert (fused["C_np"] == base + X_ref).all()
    assert fused["C"] == (base + X_ref).tolist()
    assert fused["C_np"].shape == (len(tids), len(m.resources))
    assert X_ref.any() and S_ref.any()  # the state is non-trivial


def test_bias_and_row_maxima_bitwise_equal_numpy():
    """The additive pressure bias folds into X before C and the row
    maxima, exactly as the reference's host fold ``x + p``."""
    ref_sim, sim, tids = _pair("scaled")
    X_ref, _, p_cpu, p_gpu, base = _ref_rows(ref_sim, tids, "accel_write")
    rng = np.random.default_rng(5)
    bias = rng.random(X_ref.shape) * 1e-3
    bias[rng.random(X_ref.shape) < 0.5] = 0.0
    XB = np.asarray([[x + p for x, p in zip(xr, pr)] for xr, pr in zip(X_ref.tolist(), bias.tolist())])
    be = TorchScoringBackend(device="cpu")
    rows = be.score_matrices(sim, tids, sim.machine.resources, use_cp=True, x_rows=True, x_bias=bias)
    assert (rows["X_np"] == XB).all()
    maxima = be.score_matrices(
        sim, tids, sim.machine.resources, p_cpu=p_cpu, p_gpu=p_gpu,
        use_cp=True, x_bias=bias,
    )
    assert maxima["X_rowmax"] == [max(r) for r in XB.tolist()]
    assert maxima["X_np"] is None and maxima["S_np"] is None
    assert (maxima["C_np"] == base + XB).all()


def test_cost_without_transfers_is_class_duration():
    """DADA without +CP scores durations only: C is the class column."""
    ref_sim, sim, tids = _pair("paper")
    _, _, p_cpu, p_gpu, base = _ref_rows(ref_sim, tids, "accel_write")
    fused = TorchScoringBackend(device="cpu").score_matrices(
        sim, tids, sim.machine.resources, p_cpu=p_cpu, p_gpu=p_gpu
    )
    assert (fused["C_np"] == base).all()
    assert fused["X_rowmax"] is None and fused["S_np"] is None


@pytest.mark.parametrize("affinity", RESIDENT_WEIGHTED)
@pytest.mark.parametrize("n_ready", [3, 40])
def test_host_rows_bitwise_equal_numpy(n_ready, affinity):
    """The host path (narrow scalar and wide batched) of the port."""
    ref_sim, sim, tids = _pair("scaled", n_tiles=10)
    tids = (tids + list(range(40, 80)))[:n_ready]
    X_ref, S_ref, _, _, _ = _ref_rows(ref_sim, tids, affinity)
    resources = sim.machine.resources
    X = sim.transfer_model.task_input_transfer_rows(
        sim.arrays, tids, [r.mem for r in resources], sim.residency
    )
    S = affinity_rows(affinity, sim.arrays, tids, resources, sim.residency)
    assert X == X_ref.tolist()
    assert S == S_ref.tolist()


def test_unknown_affinity_rejected():
    with pytest.raises(ValueError, match="affinity"):
        DADA(affinity="no_such_score", device="cpu")
