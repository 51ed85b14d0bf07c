"""The port's tile numerics against ``repro.linalg``'s, on the CPU.

Same inputs on both sides (the ``random_*`` matrices are drawn with numpy
from the same seed): the port's test matrices are bit-equal to the
reference's; each of the twelve tile bodies matches the reference's body at
tile 64 in f32 (relative max error 1e-5); ``execute_graph`` of the port
matches the reference's at N 256, tile 64, and passes the residual checks
of ``tests/test_linalg.py`` (1e-5 Cholesky and LU, 1e-4 QR); replays of the
port's HEFT, DADA(0.5) and DADA(1)+CP schedules equal the port's program
order exactly. On CPU tensors the GEMM-shaped bodies run the kernel's
plain version (``tests/test_torch_cuda.py`` runs the kernel).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.linalg import cholesky as ref_chol
from repro.linalg import lu as ref_lu
from repro.linalg import qr as ref_qr
from repro.linalg import tiles as RT
from repro.linalg.execute import execute_graph as ref_execute_graph
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import run_simulation
from repro_torch.core.simulator import SimResult
from repro_torch.kernels import tile_gemm
from repro_torch.linalg import cholesky, lu, qr
from repro_torch.linalg import tiles as T
from repro_torch.linalg.execute import execute_graph, execute_schedule
from repro_torch.sched import resolve

N, TILE = 256, 64
NT = N // TILE

FACTORIZATIONS = {
    "cholesky": (ref_chol.cholesky_graph, cholesky.cholesky_graph, RT.random_spd, T.random_spd),
    "lu": (ref_lu.lu_graph, lu.lu_graph, RT.random_dd, T.random_dd),
    "qr": (ref_qr.qr_graph, qr.qr_graph, RT.random_dense, T.random_dense),
}


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return float(np.abs(x - y).max() / (np.abs(y).max() + 1e-30))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("gen", ["random_spd", "random_dd", "random_dense"])
@pytest.mark.parametrize("n,seed", [(64, 0), (96, 3)])
def test_random_matrices_bit_equal_reference(gen, n, seed):
    want = np.asarray(getattr(RT, gen)(n, seed=seed, dtype=jnp.float32))
    got = getattr(T, gen)(n, seed=seed, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)


def test_random_matrices_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.random_spd(8)


def test_split_and_join_tiles_round_trip():
    a = T.random_dense(128, seed=1, device="cpu")
    tiles = T.split_tiles(a, 32)
    assert len(tiles) == 16
    assert tiles["A[1,2]"].data_ptr() == a[32:64, 64:96].data_ptr()  # a view
    assert torch.equal(T.join_tiles(tiles, 4, 32), a)
    with pytest.raises(ValueError):
        T.split_tiles(a, 48)


# ---------------------------------------------------------------------------
# the twelve tile bodies, port against reference


def _inputs():
    """Tile-64 f32 inputs on which each body is well conditioned."""
    b = TILE
    spd = np.array(RT.random_spd(b, seed=10, dtype=jnp.float32))
    dd = np.array(RT.random_dd(b, seed=11, dtype=jnp.float32))
    rng = np.random.default_rng(12)
    dense = [rng.standard_normal((b, b)).astype(np.float32) for _ in range(3)]
    low = np.array(ref_chol._potrf(jnp.asarray(spd))[0])
    packed = np.array(ref_lu._getrf(jnp.asarray(dd))[0])
    q_kk = np.array(ref_qr._geqrt(jnp.asarray(dense[0]))[1])
    q_ik = np.array(ref_qr._tsqrt(jnp.asarray(dense[0]), jnp.asarray(dense[1]))[2])
    d0, d1, d2 = dense
    return {
        "potrf": (ref_chol._potrf, cholesky._potrf, [spd]),
        "trsm": (ref_chol._trsm, cholesky._trsm, [low, d0]),
        "syrk": (ref_chol._syrk, cholesky._syrk, [d0, spd]),
        "gemm": (ref_chol._gemm, cholesky._gemm, [d0, d1, d2]),
        "getrf": (ref_lu._getrf, lu._getrf, [dd]),
        "gessm": (ref_lu._gessm, lu._gessm, [packed, d0]),
        "tstrf": (ref_lu._tstrf, lu._tstrf, [packed, d0]),
        "ssssm": (ref_lu._ssssm, lu._ssssm, [d0, d1, d2]),
        "geqrt": (ref_qr._geqrt, qr._geqrt, [d0]),
        "ormqr": (ref_qr._ormqr, qr._ormqr, [q_kk, d1]),
        "tsqrt": (ref_qr._tsqrt, qr._tsqrt, [d0, d1]),
        "tsmqr": (ref_qr._tsmqr, qr._tsmqr, [q_ik, d1, d2]),
    }


BODIES = ["potrf", "trsm", "syrk", "gemm", "getrf", "gessm", "tstrf", "ssssm",
          "geqrt", "ormqr", "tsqrt", "tsmqr"]


def _sign_fix(name, outs):
    """QR factors are unique up to the signs of R's rows (and Q's matching
    columns); LAPACK-style Householder picks the same signs on both sides,
    but the comparison does not rely on it."""
    if name not in ("geqrt", "tsqrt"):
        return outs
    r, q = (outs[0], outs[1]) if name == "geqrt" else (outs[0], outs[2])
    s = np.sign(np.diag(r))
    s[s == 0] = 1
    r = r * s[:, None]
    q = q.copy()
    q[:, : len(s)] *= s[None, :]
    return [r, q] if name == "geqrt" else [r, outs[1], q]


@pytest.mark.parametrize("name", BODIES)
def test_tile_body_matches_reference(name):
    ref_fn, port_fn, args = _inputs()[name]
    want = [np.asarray(x, np.float32) for x in ref_fn(*[jnp.asarray(a) for a in args])]
    got = [_np(x) for x in port_fn(*[torch.from_numpy(a) for a in args])]
    assert len(got) == len(want)
    want, got = _sign_fix(name, want), _sign_fix(name, got)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert _rel(g, w) < 1e-5, (name, _rel(g, w))


def test_bodies_leave_their_inputs_alone():
    for name in BODIES:
        _, port_fn, args = _inputs()[name]
        ins = [torch.from_numpy(a.copy()) for a in args]
        port_fn(*ins)
        for before, after in zip(args, ins):
            assert np.array_equal(before, after.numpy()), name


@pytest.mark.parametrize("kernel,kinds", [
    ("cholesky", ("syrk", "gemm")), ("lu", ("ssssm",)), ("qr", ("ormqr", "tsmqr")),
])
def test_gemm_shaped_bodies_call_the_kernel_wrapper(monkeypatch, kernel, kinds):
    """Every GEMM-shaped task goes through ``tile_gemm.gemm_update`` (the
    wrapper that launches the kernel on a CUDA tensor), once per task."""
    calls = [0]
    real = tile_gemm.gemm_update

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    for mod in (tile_gemm, cholesky, lu):
        monkeypatch.setattr(mod, "gemm_update", counted)
    _, build, _, gen = FACTORIZATIONS[kernel]
    graph = build(5, 16)
    execute_graph(graph, T.split_tiles(gen(80, seed=0, device="cpu"), 16))
    assert calls[0] == sum(t.kind in kinds for t in graph.tasks)


@pytest.mark.parametrize("kernel,count", [("cholesky", 680), ("lu", 1240), ("qr", 1360)])
def test_gemm_shaped_task_counts_at_the_paper_shape(kernel, count):
    """NT 16: 560 gemm + 120 syrk; 1 240 ssssm; 120 ormqr + 1 240 tsmqr."""
    kinds = {"cholesky": ("syrk", "gemm"), "lu": ("ssssm",), "qr": ("ormqr", "tsmqr")}[kernel]
    graph = FACTORIZATIONS[kernel][1](16, 512)
    assert sum(t.kind in kinds for t in graph.tasks) == count


# ---------------------------------------------------------------------------
# whole factorizations


def _residuals(kernel, a, m):
    if kernel == "cholesky":
        low = torch.tril(m)
        return [(_rel(low @ low.T, a), 1e-5), (_rel(low, torch.linalg.cholesky(a)), 1e-4)]
    if kernel == "lu":
        low = torch.tril(m, -1) + torch.eye(a.shape[0])
        return [(_rel(low @ torch.triu(m), a), 1e-5)]
    r = torch.triu(m)
    return [(_rel(r.T @ r, a.T @ a), 1e-4)]


def _r_rows_signed(m):
    r = np.triu(np.asarray(m, np.float64))
    s = np.sign(np.diag(r))
    s[s == 0] = 1
    return r * s[:, None]


@pytest.mark.parametrize("kernel", list(FACTORIZATIONS))
def test_execute_graph_matches_reference(kernel):
    ref_build, build, ref_gen, gen = FACTORIZATIONS[kernel]
    seed = {"cholesky": 0, "lu": 1, "qr": 2}[kernel]
    ref_a = ref_gen(N, seed=seed, dtype=jnp.float32)
    a = gen(N, seed=seed, device="cpu")
    a_before = a.clone()
    want = np.asarray(RT.join_tiles(ref_execute_graph(ref_build(NT, TILE), RT.split_tiles(ref_a, TILE)), NT, TILE))
    store = execute_graph(build(NT, TILE), T.split_tiles(a, TILE))
    got = T.join_tiles(store, NT, TILE)
    assert torch.equal(a, a_before)  # the caller's matrix is untouched
    assert got.dtype == torch.float32 and got.shape == (N, N)
    if kernel == "qr":
        assert _rel(_r_rows_signed(got), _r_rows_signed(want)) < 1e-5
    else:
        assert _rel(got.numpy(), want) < 1e-5
    for err, bound in _residuals(kernel, a, got):
        assert err < bound, (kernel, err, bound)


@pytest.mark.parametrize("spec", ["heft", "ws", "dada?alpha=0.5", "dada?alpha=1.0&use_cp=1"])
@pytest.mark.parametrize("kernel", list(FACTORIZATIONS))
def test_schedule_replay_equals_program_order(kernel, spec):
    """Replaying a simulated schedule gives exactly the numbers of program
    order: each tile's writers are serialised by the DAG, so the same
    per-tile op sequence runs in both orders."""
    _, build, _, gen = FACTORIZATIONS[kernel]
    a = gen(N, seed=3, device="cpu")
    want = T.join_tiles(execute_graph(build(NT, TILE), T.split_tiles(a, TILE)), NT, TILE)
    # ws scores nothing and takes no device
    strategy = resolve("ws") if spec == "ws" else resolve(spec, device="cpu")
    res = run_simulation(build(NT, TILE), paper_machine(2), strategy, seed=7)
    got = T.join_tiles(execute_schedule(build(NT, TILE), T.split_tiles(a, TILE), res), NT, TILE)
    assert torch.equal(got, want)


def _result_with(intervals):
    return SimResult(makespan=0.0, total_bytes=0, n_transfers=0, busy={}, intervals=intervals,
                     strategy="test", total_flops=0.0, n_events=0)


def test_replay_refuses_a_precedence_violation():
    graph = cholesky.cholesky_graph(3, 8)
    res = run_simulation(graph, paper_machine(2), resolve("heft", device="cpu"), seed=0)
    tiles = T.split_tiles(T.random_spd(24, device="cpu"), 8)
    # the first task (potrf 0) runs last: its successors start too early
    first = next(iv for iv in res.intervals if iv.tid == 0)
    late = dataclasses.replace(first, start=1e9, end=1e9 + 1.0)
    swapped = [late if iv.tid == 0 else iv for iv in res.intervals]
    with pytest.raises(AssertionError, match="violates precedence"):
        execute_schedule(graph, tiles, _result_with(swapped))


def test_replay_refuses_an_overlap():
    graph = cholesky.cholesky_graph(3, 8)
    res = run_simulation(graph, paper_machine(2), resolve("heft", device="cpu"), seed=0)
    tiles = T.split_tiles(T.random_spd(24, device="cpu"), 8)
    # potrf 0 still starts first but ends after its successors start
    first = next(iv for iv in res.intervals if iv.tid == 0)
    long = dataclasses.replace(first, end=1e9)
    stretched = [long if iv.tid == 0 else iv for iv in res.intervals]
    with pytest.raises(AssertionError, match="overlap"):
        execute_schedule(graph, tiles, _result_with(stretched))


def test_replay_refuses_a_missing_task():
    graph = cholesky.cholesky_graph(3, 8)
    res = run_simulation(graph, paper_machine(2), resolve("heft", device="cpu"), seed=0)
    tiles = T.split_tiles(T.random_spd(24, device="cpu"), 8)
    last = max(res.intervals, key=lambda iv: iv.start)
    short = [iv for iv in res.intervals if iv is not last]
    with pytest.raises(AssertionError, match="every task"):
        execute_schedule(graph, tiles, _result_with(short))


def test_graphs_without_bodies_cannot_execute():
    graph = lu.lu_graph(2, 8, with_fns=False)
    assert all(t.fn is None for t in graph.tasks)
    assert all(t.fn is not None for t in lu.lu_graph(2, 8).tasks)
    with pytest.raises(ValueError, match="no executable body"):
        execute_graph(graph, T.split_tiles(T.random_dd(16, device="cpu"), 8))


def test_bodies_do_not_change_the_schedule():
    """The scheduler never reads ``fn``: graphs with and without bodies
    give the same simulation."""
    def fingerprint(res):
        return (res.makespan, res.total_bytes, res.n_transfers,
                [(iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals])

    runs = [
        run_simulation(qr.qr_graph(4, 256, with_fns=fns), paper_machine(2),
                       resolve("dada?alpha=0.5&use_cp=1", device="cpu"), seed=1)
        for fns in (True, False)
    ]
    assert fingerprint(runs[0]) == fingerprint(runs[1])
