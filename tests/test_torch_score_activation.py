"""The fused activation scorer's layout and plain version
(``repro_torch.kernels.sched_score.score_activation_plain``) against the
reference's numpy host rows.

An activation is packed through the layout by the backend's ``pack``
(CSR rows as they are, 8-byte slots); the plain version over that
buffer must give ``repro``'s ``task_input_transfer_rows``,
``affinity_rows`` and ``base + X`` bit for bit, on the paper and scaled
machines, for all four resident-weighted affinities, full rows and row
maxima, with and without a bias, with and without transfers. The layout
round-trips and refuses malformed specs and buffers. (The CUDA kernel is
held against this plain version in test_torch_cuda.py.)"""
import numpy as np
import pytest
import torch

from repro.core import DADA as RefDADA
from repro.core import Simulator as RefSimulator
from repro.core.dag import DataObject as RefData
from repro.core.dag import Mode as RefMode
from repro.core.dag import TaskGraph as RefGraph
from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import DADA, Simulator
from repro_torch.core.affinity import RESIDENT_WEIGHTED
from repro_torch.core.backend import TorchScoringBackend
from repro_torch.core.dag import DataObject, Mode, TaskGraph
from repro_torch.kernels import sched_score as port
from test_torch_backend import _pair, _ref_rows
from test_torch_cuda import FLAGS, activation_case


def _score(sim, tids, *, use_cp, affinity, x_rows=False, p=None, bias=None):
    """Pack one activation of ``sim`` through the layout, as the backend
    packs it, and run the plain version over it; returns the unpacked
    outputs (numpy)."""
    layout, packed, machine = TorchScoringBackend(device="cpu").pack(
        sim, tids, sim.machine.resources, use_cp=use_cp, affinity=affinity, x_rows=x_rows,
        p_cpu=None if p is None else p[0], p_gpu=None if p is None else p[1], x_bias=bias,
    )
    assert packed.shape == (layout.n_in,) and machine.shape == (layout.n_mach,)
    out = port.score_activation_plain(packed, layout, machine)
    assert out.shape == (layout.n_out,)
    return port.unpack_outputs(out.numpy(), layout)


def _biased(X, bias):
    """The reference's host fold of a pressure bias: x + p per entry."""
    return np.asarray([[x + b for x, b in zip(xr, br)] for xr, br in zip(X.tolist(), bias.tolist())])


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("x_rows", [False, True], ids=["rowmax", "rows"])
@pytest.mark.parametrize("affinity", RESIDENT_WEIGHTED)
@pytest.mark.parametrize("n_ready", [1, 40])
@pytest.mark.parametrize("machine_name", ["paper", "scaled"])
def test_plain_bit_equal_reference_rows(machine_name, n_ready, affinity, x_rows, with_bias):
    ref_sim, sim, tids = _pair(machine_name, n_ready=n_ready)
    X_ref, S_ref, p_cpu, p_gpu, base = _ref_rows(ref_sim, tids, affinity)
    bias = None
    if with_bias:
        rng = np.random.default_rng(n_ready)
        bias = rng.random(X_ref.shape) * 1e-3
        bias[rng.random(X_ref.shape) < 0.5] = 0.0
        X_ref = _biased(X_ref, bias)
    got = _score(sim, tids, use_cp=True, affinity=affinity, x_rows=x_rows,
                 p=(p_cpu, p_gpu), bias=bias)
    if x_rows:
        assert (got["X"] == X_ref).all() and got["X_max"] is None
    else:
        assert got["X_max"].tolist() == [max(r) for r in X_ref.tolist()] and got["X"] is None
    assert (got["S"] == S_ref).all()
    assert (got["C"] == base + X_ref).all()
    assert got["C"].shape == (len(tids), len(sim.machine.resources))


@pytest.mark.parametrize("affinity", RESIDENT_WEIGHTED + (None,))
@pytest.mark.parametrize("n_ready", [1, 40])
@pytest.mark.parametrize("machine_name", ["paper", "scaled"])
def test_plain_without_transfers_is_class_duration(machine_name, n_ready, affinity):
    """DADA without +CP: C is the class column, S the affinity rows."""
    ref_sim, sim, tids = _pair(machine_name, n_ready=n_ready)
    _, S_ref, p_cpu, p_gpu, base = _ref_rows(ref_sim, tids, affinity or "accel_write")
    got = _score(sim, tids, use_cp=False, affinity=affinity, p=(p_cpu, p_gpu))
    assert (got["C"] == base).all()
    assert got["X"] is None and got["X_max"] is None
    assert (got["S"] is None) if affinity is None else (got["S"] == S_ref).all()


@pytest.mark.parametrize("n_ready", [1, 40])
@pytest.mark.parametrize("machine_name", ["paper", "scaled"])
def test_plain_transfer_rows_alone(machine_name, n_ready):
    """HEFT's call: full transfer rows, no cost and no affinity."""
    ref_sim, sim, tids = _pair(machine_name, n_ready=n_ready)
    X_ref = _ref_rows(ref_sim, tids, "accel_write")[0]
    got = _score(sim, tids, use_cp=True, affinity=None, x_rows=True)
    assert (got["X"] == X_ref).all()
    assert got["C"] is None and got["S"] is None and got["X_max"] is None


def _no_read_graphs():
    """The same small graph in both packages: tasks that only write, a task
    with no access at all, and tasks that read what others wrote."""
    tasks = [
        ("init", [("a", 1 << 20, "w")]),
        ("init", [("b", 3 << 18, "w")]),
        ("noop", []),
        ("scale", [("a", 1 << 20, "rw")]),
        ("sum", [("a", 1 << 20, "r"), ("b", 3 << 18, "r"), ("c", 1 << 16, "w")]),
    ]
    ref_g, g = RefGraph(), TaskGraph()
    for kind, acc in tasks:
        ref_g.add_task(kind, [(RefData(nm, sz), RefMode(md)) for nm, sz, md in acc], flops=1e6)
        g.add_task(kind, [(DataObject(nm, sz), Mode(md)) for nm, sz, md in acc], flops=1e6)
    return ref_g, g


@pytest.mark.parametrize("affinity", RESIDENT_WEIGHTED)
def test_activation_with_tasks_without_reads(affinity):
    """Tasks with no read score a transfer row of +0.0 and C = base; a task
    with no access scores S = +0.0; the others match the reference."""
    ref_g, g = _no_read_graphs()
    ref_sim = RefSimulator(ref_g, ref_paper_machine(3), RefDADA(alpha=0.5, use_cp=True, backend="numpy"), seed=0)
    sim = Simulator(g, paper_machine(3), DADA(alpha=0.5, use_cp=True, device="cpu"), seed=0)
    for s in (ref_sim, sim):
        s.residency.write("a", 1)
        s.residency.add_copy("b", 2)
    tids = [0, 1, 2, 3, 4]
    X_ref, S_ref, p_cpu, p_gpu, base = _ref_rows(ref_sim, tids, affinity)
    got = _score(sim, tids, use_cp=True, affinity=affinity, x_rows=True, p=(p_cpu, p_gpu))
    assert (got["X"] == X_ref).all() and (got["S"] == S_ref).all()
    assert (got["C"] == base + X_ref).all()
    assert not np.signbit(got["X"][:3]).any() and not got["X"][:3].any()
    assert not got["S"][2].any() and X_ref[4].any()


def _ragged_graphs(seed):
    """The same seeded graph in both packages: data of assorted sizes, and
    tasks reading up to five of them, so that the order of a row's fold
    shows in its last bits."""
    rng = np.random.default_rng(seed)
    sizes = {f"d{k}": int(s) for k, s in enumerate(rng.integers(1, 1 << 24, 24))}
    names = sorted(sizes)
    tasks = [("init", [(nm, sizes[nm], "w")]) for nm in names]
    for _ in range(40):
        picked = rng.choice(names, rng.integers(1, 6), replace=False)
        tasks.append(("mix", [(nm, sizes[nm], "r") for nm in picked[1:]] + [(picked[0], sizes[picked[0]], "rw")]))
    ref_g, g = RefGraph(), TaskGraph()
    for kind, acc in tasks:
        ref_g.add_task(kind, [(RefData(nm, sz), RefMode(md)) for nm, sz, md in acc], flops=1e6)
        g.add_task(kind, [(DataObject(nm, sz), Mode(md)) for nm, sz, md in acc], flops=1e6)
    return ref_g, g, names


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_fold_order_on_ragged_sizes(seed):
    """Reads of assorted sizes and residencies: the transfer rows, S and C
    equal the reference's bit for bit (a fold in another order would not).
    24 tasks, so the reference takes its scalar rows, which fold in read
    order from +0.0 as its Pallas kernel does; its batched rows (32 tasks
    and more) use ``np.add.reduceat``, which adds the first term to the
    sum of the rest and can differ in the last bit on such sizes."""
    ref_g, g, names = _ragged_graphs(seed)
    ref_sim = RefSimulator(ref_g, ref_paper_machine(8), RefDADA(alpha=0.5, use_cp=True, backend="numpy"), seed=0)
    sim = Simulator(g, paper_machine(8), DADA(alpha=0.5, use_cp=True, device="cpu"), seed=0)
    rng = np.random.default_rng(100 + seed)
    for nm in names:
        mems = rng.choice(np.arange(-1, 8), rng.integers(1, 4), replace=False)
        for s in (ref_sim, sim):
            s.residency.write(nm, int(mems[0]))
            for mem in mems[1:]:
                s.residency.add_copy(nm, int(mem))
    tids = list(range(len(names), len(names) + 24))
    X_ref, S_ref, p_cpu, p_gpu, base = _ref_rows(ref_sim, tids, "all_resident")
    got = _score(sim, tids, use_cp=True, affinity="all_resident", x_rows=True, p=(p_cpu, p_gpu))
    assert (got["X"] == X_ref).all() and (got["S"] == S_ref).all()
    assert (got["C"] == base + X_ref).all()


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(k for k, v in f.items() if v))
def test_layout_round_trip(flags):
    """Every section lands at its offset, back to back in section order,
    and reads back bit for bit; the C offsets follow the section order."""
    layout, packed, machine = activation_case(3, 11, 9, 14, **flags)
    spec = layout.spec
    for sections, names, total in ((layout.inputs, port.IN_SECTIONS, layout.n_in),
                                   (layout.machine, port.MACHINE_SECTIONS, layout.n_mach),
                                   (layout.outputs, port.OUT_SECTIONS, layout.n_out)):
        assert tuple(sections) == names
        ends = [0] + [off + k for off, k in sections.values()]
        assert [off for off, _ in sections.values()] == ends[:-1] and ends[-1] == total
    assert list(layout.c_offsets) == [
        sec[name][0] for sec in (layout.inputs, layout.machine, layout.outputs) for name in sec
    ]
    got = port.unpack(torch.from_numpy(packed), layout.inputs)
    repacked = np.full(layout.n_in, -1, dtype=np.int64)
    port.pack_activation(
        repacked, layout,
        reads=(got["r_indptr"].numpy(), got["r_masks"].numpy(), got["r_sizes"].numpy()) if spec.want_x else None,
        writes=(got["w_indptr"].numpy(), got["w_masks"].numpy(), got["w_weights"].numpy()) if spec.want_s else None,
        p_cpu=got["p_cpu"].numpy() if spec.want_c else None,
        p_gpu=got["p_gpu"].numpy() if spec.want_c else None,
        x_bias=got["x_bias"].numpy().reshape(spec.n, spec.n_res) if spec.want_bias else None,
    )
    assert (repacked == packed).all()
    assert got["r_sizes"].dtype == torch.float64 and got["r_masks"].dtype == torch.int64
    mach = port.unpack(machine, layout.machine)
    assert mach["latency"].dtype == np.float64 and mach["col_of"].dtype == np.int64
    out = port.unpack_outputs(np.arange(layout.n_out, dtype=np.float64), layout)
    views = [v for v in out.values() if v is not None]
    assert sum(v.size for v in views) == layout.n_out
    assert (out["C"] is not None) == spec.want_c and (out["S"] is not None) == spec.want_s
    assert (out["X"] is not None) == spec.x_rows
    assert (out["X_max"] is not None) == (spec.want_x and not spec.x_rows)


BAD_SPECS = {
    "n0": dict(n=0),
    "n_res0": dict(n_res=0),
    "n_u0": dict(n_u=0),
    "n_u64": dict(n_u=64),
    "negative_nnz": dict(nnz_r=-1),
    "float_n": dict(n=4.0),
    "bool_n": dict(n=True),
    "reads_without_x": dict(want_x=False, x_rows=False),
    "writes_without_s": dict(want_s=False),
    "rows_without_x": dict(want_x=False, nnz_r=0, x_rows=True),
    "bias_without_x": dict(want_x=False, nnz_r=0, want_bias=True),
    "accel_without_s": dict(want_s=False, nnz_w=0, accel_only=True),
    "nothing_asked": dict(want_x=False, nnz_r=0, want_s=False, nnz_w=0, want_c=False),
}


@pytest.mark.parametrize("bad", sorted(BAD_SPECS))
def test_layout_rejects_malformed_specs(bad):
    good = dict(n=4, nnz_r=6, nnz_w=3, n_u=9, n_res=14, want_x=True, want_s=True, want_c=True)
    port.ScoreSpec(**good)
    with pytest.raises(ValueError):
        port.score_layout(port.ScoreSpec(**{**good, **BAD_SPECS[bad]}))


@pytest.mark.parametrize("bad", ["indptr_end", "indptr_start", "indptr_order", "indptr_length",
                                 "section_length", "missing_section", "extra_section",
                                 "buffer_length", "buffer_dtype"])
def test_pack_rejects_malformed_inputs(bad):
    spec = port.ScoreSpec(n=3, nnz_r=4, nnz_w=0, n_u=2, n_res=3, want_x=True, want_c=True)
    layout = port.score_layout(spec)
    buf = np.zeros(layout.n_in, dtype=np.int64)
    reads = [np.asarray([0, 1, 1, 4]), np.arange(4), np.ones(4)]
    kw = dict(p_cpu=np.ones(3), p_gpu=np.ones(3))
    if bad == "indptr_end":
        reads[0] = np.asarray([0, 1, 1, 3])
    elif bad == "indptr_start":
        reads[0] = np.asarray([1, 1, 1, 4])
    elif bad == "indptr_order":
        reads[0] = np.asarray([0, 3, 1, 4])
    elif bad == "indptr_length":
        reads[0] = np.asarray([0, 4])
    elif bad == "section_length":
        reads[2] = np.ones(5)
    elif bad == "missing_section":
        kw = {}
    elif bad == "extra_section":
        kw["x_bias"] = np.zeros((3, 3))
    elif bad == "buffer_length":
        buf = np.zeros(layout.n_in + 1, dtype=np.int64)
    else:
        buf = np.zeros(layout.n_in, dtype=np.float64)
    with pytest.raises(ValueError):
        port.pack_activation(buf, layout, reads=tuple(reads), **kw)


@pytest.mark.parametrize("bad", ["shift_high", "shift_negative", "no_memory", "col_of_range", "col_of_length"])
def test_machine_rejects_malformed_constants(bad):
    kw = dict(latency=1e-5, bandwidth=1e10, mem_shift=[0, 1, 2], host_col=[True, False, False],
              col_of=[0, 0, 1, 2], accel_res=[False, False, True, True])
    if bad == "shift_high":
        kw["mem_shift"] = [0, 1, 63]
    elif bad == "shift_negative":
        kw["mem_shift"] = [-1, 1, 2]
    elif bad == "no_memory":
        kw.update(mem_shift=[], host_col=[], col_of=[])
    elif bad == "col_of_range":
        kw["col_of"] = [0, 0, 1, 3]
    else:
        kw["col_of"] = [0, 1, 2]
    with pytest.raises(ValueError):
        port.pack_machine(4, **kw)


@pytest.mark.parametrize("bad", ["in_dtype", "in_length", "machine_length", "out_dtype", "out_length",
                                 "noncontiguous", "layout_type"])
def test_wrapper_rejects_malformed_buffers(bad):
    layout, packed, machine = activation_case(0, 6, 9, 14)
    args = dict(packed_in=torch.from_numpy(packed), layout=layout, machine=torch.from_numpy(machine))
    if bad == "in_dtype":
        args["packed_in"] = args["packed_in"].double()
    elif bad == "in_length":
        args["packed_in"] = torch.cat([args["packed_in"], args["packed_in"][:1]])
    elif bad == "machine_length":
        args["machine"] = args["machine"][:-1]
    elif bad == "out_dtype":
        args["out"] = torch.zeros(layout.n_out, dtype=torch.float32)
    elif bad == "out_length":
        args["out"] = torch.zeros(layout.n_out + 1, dtype=torch.float64)
    elif bad == "noncontiguous":
        args["packed_in"] = torch.stack([args["packed_in"]] * 2, dim=1)[:, 0]
    else:
        args["layout"] = layout.spec
    before = port.score_activation.launches
    with pytest.raises(ValueError):
        port.score_activation(**args)
    assert port.score_activation.launches == before


def test_wrapper_on_cpu_takes_the_plain_version():
    layout, packed, machine = activation_case(1, 40, 25, 29, host=False, x_rows=True, want_bias=True)
    args = (torch.from_numpy(packed), layout, torch.from_numpy(machine))
    before = port.score_activation.launches
    want = port.score_activation_plain(*args)
    out = torch.full((layout.n_out,), float("nan"), dtype=torch.float64)
    got = port.score_activation(*args, out=out)
    assert got is out and torch.equal(got, want)
    assert torch.equal(port.score_activation(*args), want)
    assert port.score_activation.launches == before
    assert torch.isfinite(want).all()


def test_backend_staging_buffer_grows_by_doubling():
    """The backend packs into one buffer it owns: reused while an
    activation fits, replaced by one at least twice as large when not."""
    _, sim, _ = _pair("paper", n_tiles=10)
    resources = sim.machine.resources
    tids = list(range(len(sim.graph.tasks)))
    be = TorchScoringBackend(device="cpu")
    be.pack(sim, tids[:4], resources, use_cp=True)
    first = be._host_in
    be.pack(sim, tids[:40], resources, use_cp=True, affinity="all_resident")
    assert be._host_in is first
    layout, packed, _ = be.pack(
        sim, tids, resources, use_cp=True, affinity="all_resident",
        p_cpu=[1.0] * len(tids), p_gpu=[2.0] * len(tids),
        x_bias=np.zeros((len(tids), len(resources))),
    )
    assert layout.n_in > first.shape[0]
    assert be._host_in.shape[0] >= max(2 * first.shape[0], layout.n_in)
    assert packed.data_ptr() == be._host_in.data_ptr()
