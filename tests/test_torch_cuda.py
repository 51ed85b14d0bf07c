"""The CUDA kernels against their plain versions, on the card (these tests
skip without a CUDA device: a kernel has no CPU mode). Imports only
torch, numpy and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
from functools import partial

import numpy as np
import pytest
import torch

from _episode_cases import FIGURE_SPECS, case_graph, cases, configs, plan_and_batch, tile_graph
from _place_cases import (LIVE_KINDS, MACHINES, MID_ROUND, dada_case, heft_case, live_case,
                          live_heft_case, packed_dada, packed_heft)
from _scan_cases import (FUSED_CASES, SCAN_CASES, fused_inputs, g_bf16_limit, g_bf16_reading,
                         scan_inputs)
from repro_torch.core import episode as ep
from repro_torch.core import run_batch
from repro_torch.kernels import sched_episode as se
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import sched_place as sp
from repro_torch.kernels import sched_score as port
from repro_torch.kernels import tile_gemm


def full_case(seed, n_pad, r_pad, shifts, host_col):
    """Full int64 masks over the host bit and the given memory shifts,
    with data that exists nowhere, host-only rows and padded reads."""
    rng = np.random.default_rng(seed)
    bits = np.asarray(sorted({0, *shifts}), dtype=np.int64)
    pick = rng.random((n_pad, r_pad, len(bits))) < 0.3
    masks = (pick * (np.int64(1) << bits)).sum(axis=2).astype(np.int64)
    per_read = rng.random((n_pad, r_pad)) * 1e-3
    per_read[rng.random((n_pad, r_pad)) < 0.1] = 0.0  # empty reads
    masks[0] = 0  # data that exists nowhere (per_read stays non-zero)
    masks[1] = 1  # host-only copies
    pad = rng.random(n_pad) < 0.5  # rows with fewer reads than r_pad
    pad[:2] = False
    masks[pad, r_pad - 1] = 0
    per_read[pad, r_pad - 1] = 0.0
    mem_shift = np.asarray(shifts, dtype=np.int64)
    return masks, per_read, mem_shift, np.asarray(host_col, dtype=bool)


# (n_u 9: paper_machine(8) — host plus eight GPU memories; n_u 13: no
# host column, an all-GPU machine; n_u 25: the scaled-machine width;
# shifts 31 and 62: device memories 30 and 61, the widest mask)
FULL_CASES = [
    (0, 64, 4, list(range(9)), [True] + [False] * 8),
    (1, 128, 2, list(range(1, 14)), [False] * 13),
    (2, 256, 4, list(range(25)), [True] + [False] * 24),
    (3, 8, 1, list(range(9)), [True] + [False] * 8),
    (4, 32, 4, [0, 1, 31, 62], [True, False, False, False]),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", FULL_CASES, ids=lambda c: f"seed{c[0]}")
def test_cuda_kernel_bit_equal_plain(cuda, case):
    masks, per_read, mem_shift, host_col = full_case(*case)
    cpu = [torch.from_numpy(a) for a in (masks, per_read, mem_shift, host_col)]
    want = port.transfer_matrix_from_full(*cpu).numpy()
    before = port.transfer_matrix.launches
    args = [t.to(cuda) for t in cpu]
    got = port.transfer_matrix(*args)
    col_bits = torch.tensor(
        [1 << (u + 1) for u in range(len(mem_shift))], dtype=torch.int32, device=cuda
    )
    compact = port.transfer_matrix_compact(
        port.compact_masks(args[0], args[2]), args[1], col_bits, args[3]
    )
    torch.cuda.synchronize()
    assert port.transfer_matrix.launches == before + 1
    assert (got.cpu().numpy() == want).all()
    assert (compact.cpu().numpy() == want).all()


def test_cuda_kernel_rejects_mixed_devices(cuda):
    masks, per_read, mem_shift, host_col = [
        torch.from_numpy(a) for a in full_case(*FULL_CASES[0])
    ]
    with pytest.raises(ValueError, match="devices"):
        port.transfer_matrix(masks.to(cuda), per_read, mem_shift, host_col)


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5",
                                  "dada?alpha=0.5&affinity=missing_bytes",
                                  "dada?alpha=0.5&use_cp=1&affinity=missing_bytes"])
def test_cuda_simulation_equals_cpu(cuda, spec):
    """A whole simulation scored on the card equals the CPU run."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import run_simulation
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve

    def fingerprint(res):
        return (res.makespan, res.total_bytes, res.n_transfers, sorted(res.busy.items()),
                [(iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals])

    strategy = resolve(spec)
    method = "place_heft" if spec == "heft" else "place_dada"
    place = getattr(strategy.backend, method)
    placed = [0]

    def counted(*args, **kwargs):
        placed[0] += 1
        return place(*args, **kwargs)

    setattr(strategy.backend, method, counted)
    port.score_activation.launches = port.transfer_matrix.launches = 0
    sp.dada_place.launches = sp.heft_select.launches = 0
    plain = sp.dada_place_plain.calls + sp.heft_select_plain.calls
    on_card = run_simulation(qr_graph(6, 256), paper_machine(8), strategy, seed=7)
    launches = port.score_activation.launches
    assert sp.dada_place_plain.calls + sp.heft_select_plain.calls == plain
    on_cpu = run_simulation(qr_graph(6, 256), paper_machine(8), resolve(spec, device="cpu"), seed=7)
    assert fingerprint(on_card) == fingerprint(on_cpu)
    # every activation placed on the card is one fused scoring launch and
    # one placement launch, DADA without +CP included; the standalone
    # transfer kernel is off the path, and so are the plain searches
    assert launches == sp.dada_place.launches + sp.heft_select.launches == placed[0] > 0
    assert port.transfer_matrix.launches == 0


# ---------------------------------------------------------------------------
# score_activation: one activation in one launch (csrc/sched_score.cu)

LATENCY, BANDWIDTH = 1.5e-5, 1.2e10  # a PCIe-like link


def activation_case(seed, n, n_u, n_res, *, want_x=True, x_rows=False, want_bias=False,
                    want_s=True, accel_only=False, want_c=True, host=True, s_missing=False):
    """A seeded packed activation: (layout, packed input, machine buffer),
    both int64 numpy arrays. Masks over the host bit and ``n_u`` memory
    shifts up to 62 (no host column when ``host`` is False), with data
    that exists nowhere, host-only data, reads of size 0, task 0 without
    reads and task 1 without affinity accesses. With ``s_missing`` the
    affinity accesses are read-like (weights are sizes, some 0) and S is
    the missing_bytes fold."""
    rng = np.random.default_rng(seed)
    n_dev = n_u - 1 if host else n_u
    shifts = np.sort(rng.choice(np.arange(1, port.MAX_SHIFT + 1), n_dev, replace=False))
    if host:
        shifts = np.concatenate([[0], shifts])
    host_col = shifts == 0
    col_of = rng.permutation(np.concatenate([np.arange(n_u), rng.integers(0, n_u, n_res - n_u)]))
    machine = port.pack_machine(
        n_res, latency=LATENCY, bandwidth=BANDWIDTH, mem_shift=shifts, host_col=host_col,
        col_of=col_of, accel_res=~host_col[col_of],
    )
    bits = np.concatenate([[0], shifts[shifts > 0]]).astype(np.int64)

    def csr(max_per_row, empty_row):
        counts = rng.integers(0, max_per_row + 1, n)
        counts[min(empty_row, n - 1)] = 0
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        pick = rng.random((indptr[-1], len(bits))) < 0.3
        masks = (pick * (np.int64(1) << bits)).sum(axis=1).astype(np.int64)
        masks[::5] = 0  # data that exists nowhere
        masks[1::7] = 1  # host-only copies
        return indptr, masks

    reads = writes = None
    if want_x:
        indptr, masks = csr(4, 0)
        sizes = rng.integers(0, 1 << 22, len(masks)).astype(np.float64)
        sizes[::6] = 0.0
        reads = (indptr, masks, sizes)
    if want_s or s_missing:
        indptr, masks = csr(3, 1)
        weights = rng.integers(1, 1 << 22, len(masks)).astype(np.float64)
        if s_missing:
            weights[::6] = 0.0
        writes = (indptr, masks, weights)
    bias = None
    if want_bias:
        bias = rng.random((n, n_res)) * 1e-3
        bias[rng.random((n, n_res)) < 0.5] = 0.0
    layout = port.score_layout(port.ScoreSpec(
        n=n, nnz_r=len(reads[1]) if reads else 0, nnz_w=len(writes[1]) if writes else 0,
        n_u=n_u, n_res=n_res, want_x=want_x, x_rows=x_rows, want_bias=want_bias,
        want_s=want_s or s_missing, accel_only=accel_only, want_c=want_c, s_missing=s_missing,
    ))
    packed = np.zeros(layout.n_in, dtype=np.int64)
    port.pack_activation(
        packed, layout, reads=reads, writes=writes,
        p_cpu=rng.random(n) if want_c else None, p_gpu=rng.random(n) * 0.1 if want_c else None,
        x_bias=bias,
    )
    return layout, packed, machine


def flag_combinations():
    """Every valid combination of the spec's six flags (29)."""
    out = []
    for x in ("none", "max", "max+bias", "rows", "rows+bias"):
        for s in ("none", "s", "s+accel"):
            for c in (False, True):
                if x == "none" and s == "none" and not c:
                    continue
                out.append(dict(
                    want_x=x != "none", x_rows=x.startswith("rows"), want_bias="bias" in x,
                    want_s=s != "none", accel_only=s == "s+accel", want_c=c,
                ))
    return out


FLAGS = flag_combinations()
# (n, n_u, n_res, host): paper_machine(8) (9 memories, 14 resources), the
# scaled-machine width, a wide all-GPU machine and n_u above a warp
ACTIVATION_SHAPES = [(1, 9, 14, True), (128, 9, 14, True), (40, 25, 29, False),
                     (256, 30, 34, True), (37, 40, 47, True), (5, 63, 70, True)]


def _flag_id(f):
    return "-".join(k for k, v in f.items() if v)


@pytest.mark.parametrize("flags", FLAGS, ids=_flag_id)
@pytest.mark.parametrize("shape", [ACTIVATION_SHAPES[1], ACTIVATION_SHAPES[4]], ids=lambda s: f"n{s[0]}-u{s[1]}")
def test_cuda_score_activation_equals_plain_every_flag(cuda, shape, flags):
    n, n_u, n_res, host = shape
    layout, packed, machine = activation_case(n + n_u, n, n_u, n_res, host=host, **flags)
    cpu_in, cpu_mach = torch.from_numpy(packed), torch.from_numpy(machine)
    want = port.score_activation_plain(cpu_in, layout, cpu_mach)
    before = port.score_activation.launches
    got = port.score_activation(cpu_in.to(cuda), layout, cpu_mach.to(cuda))
    plain_card = port.score_activation_plain(cpu_in.to(cuda), layout, cpu_mach.to(cuda))
    torch.cuda.synchronize()
    assert port.score_activation.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(plain_card.cpu(), want)


# the missing_bytes flag (s_missing: S from the reads' sizes, hop-folded and
# negated) with every X / C combination
MISSING_FLAGS = [dict(want_x=x != "none", x_rows=x.startswith("rows"), want_bias="bias" in x,
                      want_c=c, s_missing=True)
                 for x in ("none", "max", "max+bias", "rows", "rows+bias") for c in (False, True)]


@pytest.mark.parametrize("flags", MISSING_FLAGS, ids=_flag_id)
@pytest.mark.parametrize("shape", ACTIVATION_SHAPES, ids=lambda s: f"n{s[0]}-u{s[1]}-r{s[2]}")
def test_cuda_score_activation_missing_bytes_equals_plain(cuda, shape, flags):
    """Bit for bit (torch.equal: -0.0 where the plain version has it)."""
    n, n_u, n_res, host = shape
    layout, packed, machine = activation_case(n * 3 + n_u, n, n_u, n_res, host=host, **flags)
    cpu_in, cpu_mach = torch.from_numpy(packed), torch.from_numpy(machine)
    want = port.score_activation_plain(cpu_in, layout, cpu_mach)
    before = port.score_activation.launches
    got = port.score_activation(cpu_in.to(cuda), layout, cpu_mach.to(cuda))
    torch.cuda.synchronize()
    assert port.score_activation.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(torch.signbit(got.cpu()), torch.signbit(want))


@pytest.mark.parametrize("shape", ACTIVATION_SHAPES, ids=lambda s: f"n{s[0]}-u{s[1]}-r{s[2]}")
def test_cuda_score_activation_equals_plain_every_shape(cuda, shape):
    n, n_u, n_res, host = shape
    for k, flags in enumerate((FLAGS[-1], dict(want_x=True, x_rows=True))):
        layout, packed, machine = activation_case(k, n, n_u, n_res, host=host, **flags)
        args = (torch.from_numpy(packed), layout, torch.from_numpy(machine))
        want = port.score_activation_plain(*args)
        out = torch.full((layout.n_out,), float("nan"), dtype=torch.float64, device=cuda)
        got = port.score_activation(args[0].to(cuda), layout, args[2].to(cuda), out=out)
        assert got.data_ptr() == out.data_ptr()
        assert torch.equal(got.cpu(), want)


def test_cuda_score_activation_rejects_mixed_devices(cuda):
    layout, packed, machine = activation_case(0, 8, 9, 14)
    before = port.score_activation.launches
    with pytest.raises(ValueError, match="devices"):
        port.score_activation(torch.from_numpy(packed).to(cuda), layout, torch.from_numpy(machine))
    assert port.score_activation.launches == before


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5", "dada?alpha=0"])
def test_cuda_score_matrices_is_one_launch(cuda, spec):
    """Each score_matrices call on the card launches the fused kernel once
    and equals the CPU backend's call bit for bit."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve

    sims = {
        dev: Simulator(qr_graph(6, 256), paper_machine(8), resolve(spec, device=dev), seed=7)
        for dev in ("cuda", "cpu")
    }
    for sim in sims.values():  # every third datum moved to a device memory
        for k, name in enumerate(sim.arrays.data_names):
            if k % 3 == 0:
                sim.residency.write(name, k % 8)
    tids = list(range(40))
    kwargs = dict(use_cp=True, x_rows=True) if spec == "heft" else dict(
        p_cpu=[1.0 + t for t in tids], p_gpu=[0.5 + t for t in tids],
        use_cp="use_cp" in spec, affinity="accel_write" if "0.5" in spec else None,
    )
    calls = {}
    for dev, sim in sims.items():
        before = port.score_activation.launches
        calls[dev] = sim.strategy.backend.score_matrices(sim, tids, sim.machine.resources, **kwargs)
        assert port.score_activation.launches == before + (dev == "cuda")
    for key, want in calls["cpu"].items():
        got = calls["cuda"][key]
        assert (got is None) == (want is None)
        if isinstance(want, np.ndarray):
            assert np.array_equal(got, want)
        else:
            assert got == want


# ---------------------------------------------------------------------------
# gemm_update (csrc/tile_gemm.cu)

GEMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # tests/test_kernels.py:21


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (256, 128, 384), (512, 512, 512), (1024, 512, 1024)])
def test_cuda_gemm_update_matches_plain(cuda, m, n, k, trans_b, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m + n + k)
    c, a, b = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
        for s in ((m, n), (m, k), (n, k) if trans_b else (k, n))
    )
    want = tile_gemm.gemm_update_plain(c, a, b, alpha=-1.0, trans_b=trans_b)
    before = tile_gemm.gemm_update.launches
    got = tile_gemm.gemm_update(c.to(cuda), a.to(cuda), b.to(cuda), alpha=-1.0, trans_b=trans_b)
    torch.cuda.synchronize()
    assert tile_gemm.gemm_update.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    tol = GEMM_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol * k ** 0.5, rtol=tol)


@pytest.mark.parametrize("m,n,k", [(100, 100, 100), (8, 24, 40), (200, 72, 136)])
def test_cuda_gemm_update_ragged_edges(cuda, m, n, k):
    """Shapes that tile under their own block sizes but are not multiples
    of the kernel's 64 x 64 block tile and 16-deep stage: the edges load
    zeros and skip their stores."""
    rng = np.random.default_rng(k)
    c, a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((m, n), (m, k), (k, n)))
    got = tile_gemm.gemm_update(c.to(cuda), a.to(cuda), b.to(cuda), alpha=0.5, bm=m, bn=n, bk=k)
    want = tile_gemm.gemm_update_plain(c, a, b, alpha=0.5)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4 * k ** 0.5, rtol=2e-4)


def test_cuda_gemm_update_reads_strided_views(cuda):
    """Tiles that are views of a whole matrix (row stride above the
    width) give the same bits as contiguous copies."""
    whole = torch.from_numpy(np.random.default_rng(1).standard_normal((1024, 1024)).astype(np.float32)).to(cuda)
    c, a, b = whole[:512, 512:], whole[512:, :512], whole[512:, 512:]
    got = tile_gemm.gemm_update(c, a, b, trans_b=True)
    want = tile_gemm.gemm_update(c.contiguous(), a.contiguous(), b.contiguous(), trans_b=True)
    assert torch.equal(got, want)


def test_cuda_gemm_update_refuses_f64_and_non_tiling(cuda):
    x = torch.zeros(64, 64, dtype=torch.float64, device=cuda)
    before = tile_gemm.gemm_update.launches
    with pytest.raises(ValueError, match="float32"):
        tile_gemm.gemm_update(x, x, x)
    y = torch.zeros(100, 100, device=cuda)
    with pytest.raises(ValueError, match="tile evenly"):
        tile_gemm.gemm_update(y, y, y, bm=64, bn=64, bk=64)
    assert tile_gemm.gemm_update.launches == before


def _gemm_operands(seed, m, n, k, trans_b, dtype):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dtype)
        for sh in ((m, n), (m, k), (n, k) if trans_b else (k, n))
    ]


def _assert_gemm_close(got, want, k, dtype):
    tol = GEMM_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol * k ** 0.5, rtol=tol)


# (m, n, k): the main path's shapes and others whose plan splits k, then
# shapes whose plan does not
SPLIT_SHAPES = [(512, 512, 512), (1024, 512, 1024), (128, 128, 512), (256, 128, 384), (100, 72, 384)]
WHOLE_SHAPES = [(64, 64, 64), (128, 128, 128), (2048, 1024, 256), (100, 100, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("m,n,k", SPLIT_SHAPES + WHOLE_SHAPES)
def test_cuda_gemm_update_plans(cuda, m, n, k, trans_b, dtype):
    """Split and whole-k plans against the plain version; launches counts
    the call, launches_split counts it when its plan splits k."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c, a, b = _gemm_operands(m * n + k, m, n, k, trans_b, dtype)
    n_split = tile_gemm.gemm_plan(m, n, k)[2]
    assert (n_split > 1) == ((m, n, k) in SPLIT_SHAPES)
    before = (tile_gemm.gemm_update.launches, tile_gemm.gemm_update.launches_split)
    got = tile_gemm.gemm_update(c.to(cuda), a.to(cuda), b.to(cuda), alpha=-1.0, trans_b=trans_b)
    torch.cuda.synchronize()
    assert (tile_gemm.gemm_update.launches, tile_gemm.gemm_update.launches_split) == (
        before[0] + 1, before[1] + (n_split > 1))
    assert got.dtype == dtype and got.shape == (m, n)
    _assert_gemm_close(got, tile_gemm.gemm_update_plain(c, a, b, alpha=-1.0, trans_b=trans_b), k, dtype)
    split = tile_gemm.gemm_update_split_plain(c, a, b, alpha=-1.0, trans_b=trans_b, n_split=n_split)
    _assert_gemm_close(got, split, k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("m,n,k,plan", [
    (64, 64, 528, (64, 64, 5, 128)),     # the last split is one 16-deep stage
    (130, 70, 528, (64, 64, 5, 128)),    # and ragged m, n
    (130, 70, 100, (64, 64, 2, 64)),     # ragged k: the last split is 36 deep
    (77, 45, 33, (64, 64, 3, 16)),       # ragged everything, a split a stage
])
def test_cuda_gemm_update_split_edges(cuda, m, n, k, plan, trans_b, dtype):
    """Plans that leave the last split a single stage or a ragged one, on
    ragged m, n and k (plans the planner does not pick, launched as they
    are)."""
    c, a, b = _gemm_operands(k, m, n, k, trans_b, dtype)
    got = tile_gemm._launch(c.to(cuda), a.to(cuda), b.to(cuda), alpha=0.5, trans_b=trans_b, plan=plan)
    _assert_gemm_close(got, tile_gemm.gemm_update_plain(c, a, b, alpha=0.5, trans_b=trans_b), k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("shape", [(512, 512, 512), (128, 128, 128)])
def test_cuda_gemm_update_misaligned_views_give_the_contiguous_bits(cuda, shape, trans_b, dtype):
    """Views one element off a 16-byte boundary, with an odd row stride,
    take the kernel's narrow copies and give the bits of their contiguous
    copies."""
    m, n, k = shape
    rng = np.random.default_rng(7)
    whole = torch.from_numpy(rng.standard_normal((1200, 1201)).astype(np.float32)).to(dtype).to(cuda)
    assert whole.stride(0) % 2 == 1
    c = whole[1:1 + m, 1:1 + n]
    a = whole[3:3 + m, 5:5 + k]
    b = whole[600:600 + (n if trans_b else k), 601:601 + (k if trans_b else n)]
    got = tile_gemm.gemm_update(c, a, b, trans_b=trans_b)
    want = tile_gemm.gemm_update(c.contiguous(), a.contiguous(), b.contiguous(), trans_b=trans_b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,k,trans_b", [(512, 512, 512, True), (1024, 512, 1024, False)])
def test_cuda_gemm_update_is_deterministic_and_graph_capturable(cuda, m, n, k, trans_b):
    """Two calls give equal bits, and a CUDA-graph replay equals eager."""
    c, a, b = (t.to(cuda) for t in _gemm_operands(0, m, n, k, trans_b, torch.float32))
    first = tile_gemm.gemm_update(c, a, b, trans_b=trans_b)
    assert torch.equal(first, tile_gemm.gemm_update(c, a, b, trans_b=trans_b))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tile_gemm.gemm_update(c, a, b, trans_b=trans_b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = tile_gemm.gemm_update(c, a, b, trans_b=trans_b)
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, first)


def test_cuda_gemm_update_refusals_launch_nothing(cuda):
    """Refusals at a shape whose plan would split k move neither counter."""
    x = torch.zeros(512, 512, device=cuda)
    before = (tile_gemm.gemm_update.launches, tile_gemm.gemm_update.launches_split)
    for call, match in [
        (lambda: tile_gemm.gemm_update(x, x.bfloat16(), x), "float32"),
        (lambda: tile_gemm.gemm_update(x, x, x.T), "unit column stride"),
        (lambda: tile_gemm.gemm_update(x, x, x.cpu()), "devices"),
        (lambda: tile_gemm.gemm_update(x, x, x[:384], trans_b=False), "chain"),
    ]:
        with pytest.raises(ValueError, match=match):
            call()
    assert (tile_gemm.gemm_update.launches, tile_gemm.gemm_update.launches_split) == before


def test_cuda_matmul_launches_with_no_c(cuda):
    """matmul passes no C (the kernel reads zero) and matches A @ B."""
    _, a, b = _gemm_operands(5, 512, 512, 512, False, torch.float32)
    got = tile_gemm.matmul(a.to(cuda), b.to(cuda))
    _assert_gemm_close(got, tile_gemm.matmul_plain(a, b), 512, torch.float32)


@pytest.mark.parametrize("kernel", ["cholesky", "lu", "qr"])
def test_cuda_schedule_replay_equals_cpu(cuda, kernel):
    """A small factorization scheduled and replayed on the card equals the
    CPU run within rel 1e-5 (QR's R compared up to row signs), and every
    GEMM-shaped task launched the kernel once."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import run_simulation
    from repro_torch.linalg import cholesky, lu, qr
    from repro_torch.linalg import tiles as T
    from repro_torch.linalg.execute import execute_graph, execute_schedule
    from repro_torch.sched import resolve

    build, gen, kinds = {
        "cholesky": (cholesky.cholesky_graph, T.random_spd, ("syrk", "gemm")),
        "lu": (lu.lu_graph, T.random_dd, ("ssssm",)),
        "qr": (qr.qr_graph, T.random_dense, ("ormqr", "tsmqr")),
    }[kernel]
    nt, tile = 4, 128
    res = run_simulation(build(nt, tile), paper_machine(2), resolve("dada?alpha=0.5&use_cp=1"), seed=7)
    tile_gemm.gemm_update.launches = 0
    on_card = T.join_tiles(
        execute_schedule(build(nt, tile), T.split_tiles(gen(nt * tile, seed=3), tile), res), nt, tile
    ).cpu()
    launches = tile_gemm.gemm_update.launches
    on_cpu = T.join_tiles(
        execute_graph(build(nt, tile), T.split_tiles(gen(nt * tile, seed=3, device="cpu"), tile)), nt, tile
    )
    assert launches == sum(t.kind in kinds for t in build(nt, tile).tasks)
    if kernel == "qr":
        on_card, on_cpu = (torch.triu(m) * torch.sign(torch.diagonal(m))[:, None] for m in (on_card, on_cpu))
    err = ((on_card - on_cpu).abs().max() / on_cpu.abs().max()).item()
    assert err < 1e-5, err


# ---------------------------------------------------------------------------
# flash_attention (csrc/flash_attention.cu) and flash_decode (csrc/flash_decode.cu)

# tests/test_kernels.py's tolerances: f32 2e-5 (flash_decode 1e-5), bf16 3e-2
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DECODE_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def _draw(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "hq,hk,sq,sk,d",
    [(4, 4, 128, 128, 128), (4, 2, 128, 128, 128), (8, 1, 128, 256, 128), (4, 2, 128, 128, 256),
     (4, 2, 100, 100, 64), (6, 3, 37, 130, 32), (32, 2, 1, 9, 128), (4, 4, 65, 65, 256)],
)
def test_cuda_flash_attention_matches_plain(cuda, hq, hk, sq, sk, d, causal, dtype):
    q, k, v = _draw(hq + sq + sk + d, ((hq, sq, d), (hk, sk, d), (hk, sk, d)), dtype)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (hq, sq, d)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol, rtol=tol)


def test_cuda_flash_attention_batched_views(cuda):
    """The model's call: (B, S, H, d) projections as transpose(1, 2) views;
    the output's transpose(1, 2) is contiguous."""
    B, S, hq, hk, d = 2, 300, 32, 2, 128
    q, k, v = (t.to(cuda) for t in _draw(5, ((B, S, hq, d), (B, S, hk, d), (B, S, hk, d)),
                                          torch.bfloat16))
    got = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


def test_cuda_flash_attention_refusals(cuda):
    before = fa.flash_attention.launches
    x = torch.zeros(4, 20, 32, device=cuda)
    with pytest.raises(ValueError, match="sq 20 > sk 10"):
        fa.flash_attention(x, x[:2, :10], x[:2, :10])
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        y = x.double()
        fa.flash_attention(y, y, y)
    with pytest.raises(ValueError, match="devices"):
        fa.flash_attention(x, x.cpu(), x.cpu())
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,hq,hk,s,d,length",
    [(2, 8, 2, 512, 128, 512), (2, 4, 1, 1024, 128, 700), (2, 16, 16, 256, 128, 256),
     (4, 32, 2, 96, 128, 65), (2, 4, 2, 300, 32, 171), (3, 16, 16, 50, 256, 1)],
)
def test_cuda_flash_decode_matches_plain(cuda, B, hq, hk, s, d, length, dtype):
    q, k, v = _draw(s + length, ((B, hq, d), (B, s, hk, d), (B, s, hk, d)), dtype)
    want = fd.flash_decode_plain(q, k, v, length)
    before = fd.flash_decode.launches
    got = fd.flash_decode(q.to(cuda), k.to(cuda), v.to(cuda), length)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, hq, d)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol, rtol=tol)


def test_cuda_flash_decode_refusals(cuda):
    before = fd.flash_decode.launches
    q = torch.zeros(2, 8, 32, device=cuda)
    k = torch.zeros(2, 16, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        fd.flash_decode(q, k, k, 0)
    with pytest.raises(ValueError, match="devices"):
        fd.flash_decode(q, k.cpu(), k.cpu(), 4)
    assert fd.flash_decode.launches == before


@pytest.mark.parametrize("arch", ["chatglm3-6b", "granite-8b", "gemma-7b"])
def test_cuda_serving_equals_cpu(cuda, arch):
    """The smoke config served on the card (both kernels) equals the CPU run
    (plain versions) at f32: the same greedy tokens, logits within 1e-4."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(arch).scaled(compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    on_card = to(params)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)))
    out = {}
    for dev, p in (("cuda", on_card), ("cpu", params)):
        fa.flash_attention.launches = fd.flash_decode.launches = 0
        logits = make_prefill_step(cfg)(p, {"tokens": prompt.to(dev)})
        last, cache = prefill_into_cache(p, cfg, prompt.to(dev), 14)
        toks = [last]
        step = make_serve_step(cfg)
        for i in range(4):
            nxt, _, cache = step(p, cache, toks[-1][:, None], 9 + i)
            toks.append(nxt)
        out[dev] = (logits.cpu(), torch.stack(toks, 1).cpu(),
                    fa.flash_attention.launches, fd.flash_decode.launches)
    assert out["cuda"][2] == cfg.n_layers and out["cuda"][3] == 13 * cfg.n_layers
    assert out["cpu"][2] == out["cpu"][3] == 0
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=1e-4)
    assert torch.equal(out["cuda"][1], out["cpu"][1])



# ---------------------------------------------------------------------------
# the tensor-core routes: flash_attention "tc" (csrc/flash_attention_sm90.cu)
# and flash_decode "split" (csrc/flash_decode_split.cu), at the same bf16
# tolerance (3e-2) against the plain versions


def _bshd(seed, B, sq, sk, hq, hk, d, device):
    """The model's layout: (B, S, H, d) projections as (B, H, S, d) views."""
    q, k, v = _draw(seed, ((B, sq, hq, d), (B, sk, hk, d), (B, sk, hk, d)), torch.bfloat16)
    return [t.to(device).transpose(1, 2) for t in (q, k, v)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize(
    "B,hq,hk,sq,sk,causal",
    [(1, 4, 4, 128, 128, True), (2, 8, 2, 100, 100, True), (2, 8, 2, 77, 300, True),
     (1, 4, 1, 1, 129, True), (2, 6, 3, 200, 65, False), (3, 32, 2, 257, 257, True),
     (2, 4, 2, 130, 1000, False),
     # jamba's prompt and prefill (32 query heads over 8 KV heads)
     (4, 32, 8, 64, 64, True), (4, 32, 8, 2048, 2048, True)],
)
def test_cuda_flash_attention_tc_matches_plain(cuda, B, hq, hk, sq, sk, causal, d):
    """Ragged sq and sk (no multiple of 128 or 64), causal with sk > sq,
    strided (B, S, H, d) views: all on the tensor-core route."""
    q, k, v = _bshd(B * 7 + sq + sk + d, B, sq, sk, hq, hk, d, cuda)
    assert fa.attention_route(q, k, v) == "tc"
    before, before_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.launches_tc == before_tc + 1
    assert got.shape == (B, hq, sq, d) and got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_attention_tc_three_dim(cuda, d):
    """The reference's 3-D call (a batch of one) on the tensor-core route."""
    q, k, v = (t.to(cuda) for t in _draw(d, ((8, 300, d), (2, 300, d), (2, 300, d)), torch.bfloat16))
    before_tc = fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_tc == before_tc + 1
    want = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize(
    "case", ["f32", "unaligned", "d32", "d256"],
)
def test_cuda_flash_attention_simt_route(cuda, case):
    """An f32 call, a view whose base is not 16-byte aligned, and head dims
    the tensor-core kernel does not take: the SIMT route, by the counters."""
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    d = {"d32": 32, "d256": 256}.get(case, 128)
    q, k, v = (t.to(cuda) for t in _draw(3, ((4, 96, d + 8), (2, 96, d + 8), (2, 96, d + 8)), dtype))
    sl = slice(1, d + 1) if case == "unaligned" else slice(0, d)
    q, k, v = q[..., sl], k[..., sl], v[..., sl]
    assert fa.attention_route(q, k, v) == "simt"
    before, before_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.launches_tc == before_tc
    want = fa.flash_attention_plain(q, k, v)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _cache(seed, B, hq, hk, S, d, device, dtype=torch.bfloat16):
    return [t.to(device) for t in _draw(seed, ((B, hq, d), (B, S, hk, d), (B, S, hk, d)), dtype)]


def _decode_cases():
    cases = []
    for group in (1, 16, 32):
        hk = 2
        S = 700
        chunk, _ = fd.decode_splits(2, hk, S)
        for length in sorted({1, chunk + 1, S}):
            cases.append((2, group * hk, hk, S, 128, length))
    return cases + [(4, 32, 2, 96, 128, 96), (3, 8, 1, 300, 64, 171), (2, 4, 4, 64, 256, 33),
                    (1, 24, 1, 130, 16, 130),
                    # jamba's serving cache (group 4) at its first and last length
                    (4, 32, 8, 96, 128, 1), (4, 32, 8, 96, 128, 96)]


@pytest.mark.parametrize("B,hq,hk,S,d,length", _decode_cases())
def test_cuda_flash_decode_split_matches_plain(cuda, B, hq, hk, S, d, length):
    """Lengths 1, chunk + 1 and S with groups 1, 16 and 32, and ragged
    shapes: all on the split route."""
    q, k, v = _cache(S + length + hq, B, hq, hk, S, d, cuda)
    assert fd.decode_route(q, k, v) == "split"
    before, before_split = fd.flash_decode.launches, fd.flash_decode.launches_split
    got = fd.flash_decode(q, k, v, length)
    want = fd.flash_decode_plain(q, k, v, length)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    assert fd.flash_decode.launches_split == before_split + 1
    assert got.shape == (B, hq, d) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


def test_cuda_flash_decode_split_reads_strided_layer(cuda):
    """The model's call: q a view of the projection, the cache one layer of
    a (L, B, S, Hkv, hd) tensor."""
    L, B, S, hq, hk, d = 3, 4, 96, 32, 2, 128
    rng = np.random.default_rng(11)
    cache = torch.from_numpy(rng.standard_normal((2, L, B, S, hk, d)).astype(np.float32))
    cache = cache.to(torch.bfloat16).to(cuda)
    proj = torch.from_numpy(rng.standard_normal((B, 1, hq * d)).astype(np.float32))
    q = proj.to(torch.bfloat16).to(cuda).view(B, 1, hq, d)[:, 0]
    k, v = cache[0, 1], cache[1, 1]
    assert fd.decode_route(q, k, v) == "split"
    got = fd.flash_decode(q, k, v, 70)
    want = fd.flash_decode_plain(q, k, v, 70)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("case", ["f32", "unaligned", "group64", "hd24"])
def test_cuda_flash_decode_simt_route(cuda, case):
    """An f32 call, an unaligned view, a group over 32 and a head dim that
    is no multiple of 16: the SIMT route, by the counters."""
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    hq, hk = (64, 1) if case == "group64" else (16, 2)
    d = 24 if case == "hd24" else 128
    q, k, v = _cache(5, 2, hq, hk, 200, d + 8, cuda, dtype)
    sl = slice(1, d + 1) if case == "unaligned" else slice(0, d)
    q, k, v = q[..., sl], k[..., sl], v[..., sl]
    assert fd.decode_route(q, k, v) == "simt"
    before, before_split = fd.flash_decode.launches, fd.flash_decode.launches_split
    got = fd.flash_decode(q, k, v, 150)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    assert fd.flash_decode.launches_split == before_split
    want = fd.flash_decode_plain(q, k, v, 150)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# a value head dim of its own (MLA: dk 96, dv 64), on every route


@pytest.mark.parametrize("dk,dv", [(96, 64), (48, 32), (128, 64), (64, 16)])
@pytest.mark.parametrize(
    "B,hq,hk,sq,sk,causal",
    [(2, 40, 40, 200, 200, True), (2, 8, 2, 77, 300, True), (1, 4, 1, 130, 65, False)],
)
def test_cuda_flash_attention_dv_tc_matches_plain(cuda, B, hq, hk, sq, sk, causal, dk, dv):
    q, k = (t.to(cuda).transpose(1, 2) for t in _draw(
        dk + dv + sq, ((B, sq, hq, dk), (B, sk, hk, dk)), torch.bfloat16))
    v = _draw(dv + sk, ((B, sk, hk, dv),), torch.bfloat16)[0].to(cuda).transpose(1, 2)
    assert fa.attention_route(q, k, v) == "tc"
    before_tc = fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v, causal=causal, scale=dk ** -0.5)
    want = fa.flash_attention_plain(q, k, v, causal=causal, scale=dk ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_tc == before_tc + 1
    assert got.shape == (B, hq, sq, dv) and got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", [(96, 64), (48, 32), (32, 16), (256, 64)])
def test_cuda_flash_attention_dv_simt_matches_plain(cuda, dk, dv, dtype):
    """f32, and bf16 head dims the tensor-core kernel does not take
    (dk 32 and 256; bf16 (96, 64) and (48, 32) go in unaligned)."""
    q, k = (t.to(cuda) for t in _draw(dk, ((6, 90, dk + 8), (3, 90, dk + 8)), dtype))
    v = _draw(dv, ((3, 90, dv + 8),), dtype)[0].to(cuda)
    off = 1 if dtype == torch.bfloat16 and dk in (96, 48) else 0
    q, k, v = q[..., off:off + dk], k[..., off:off + dk], v[..., off:off + dv]
    assert fa.attention_route(q, k, v) == "simt"
    before = (fa.flash_attention.launches, fa.flash_attention.launches_tc)
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.launches_tc) == (before[0] + 1, before[1])
    assert got.shape == (6, 90, dv)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dk,dv", [(96, 64), (48, 32), (256, 64), (128, 16)])
@pytest.mark.parametrize("B,hq,hk,S,length", [(4, 40, 40, 96, 96), (2, 8, 2, 700, 65),
                                              (2, 32, 1, 300, 1)])
def test_cuda_flash_decode_dv_split_matches_plain(cuda, B, hq, hk, S, length, dk, dv):
    q, k = (t.to(cuda) for t in _draw(dk + length, ((B, hq, dk), (B, S, hk, dk)), torch.bfloat16))
    v = _draw(dv + S, ((B, S, hk, dv),), torch.bfloat16)[0].to(cuda)
    assert fd.decode_route(q, k, v) == "split"
    before_split = fd.flash_decode.launches_split
    got = fd.flash_decode(q, k, v, length, scale=dk ** -0.5)
    want = fd.flash_decode_plain(q, k, v, length, scale=dk ** -0.5)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches_split == before_split + 1
    assert got.shape == (B, hq, dv)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", [(96, 64), (48, 32), (24, 8)])
def test_cuda_flash_decode_dv_simt_matches_plain(cuda, dk, dv, dtype):
    """f32, and bf16 views the split kernel does not take (unaligned, or a
    head dim that is no multiple of 16)."""
    q, k = (t.to(cuda) for t in _draw(dk, ((2, 16, dk + 8), (2, 200, 2, dk + 8)), dtype))
    v = _draw(dv, ((2, 200, 2, dv + 8),), dtype)[0].to(cuda)
    off = 1 if dtype == torch.bfloat16 else 0
    q, k, v = q[..., off:off + dk], k[..., off:off + dk], v[..., off:off + dv]
    assert fd.decode_route(q, k, v) == "simt"
    before = (fd.flash_decode.launches, fd.flash_decode.launches_split)
    got = fd.flash_decode(q, k, v, 150)
    want = fd.flash_decode_plain(q, k, v, 150)
    torch.cuda.synchronize()
    assert (fd.flash_decode.launches, fd.flash_decode.launches_split) == (before[0] + 1, before[1])
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_cuda_mla_serving_takes_the_tensor_core_routes(cuda):
    """minicpm3-4b's attention widths (40 heads, dk 96, dv 64) at two layers
    and d 256, bf16: every prefill layer on "tc", every decode layer on
    "split"; the card's logits near the CPU's (plain versions) and the two
    paths' last logits near each other."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    cfg = get_config("minicpm3-4b").scaled(n_layers=2, d_model=256, d_ff=512, vocab=1000)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    prompt = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)))
    out = {}
    for dev, p in (("cuda", to(params)), ("cpu", params)):
        counts = (fa.flash_attention.launches_tc, fd.flash_decode.launches_split)
        logits = make_prefill_step(cfg)(p, {"tokens": prompt.to(dev)})
        _, cache = prefill_into_cache(p, cfg, prompt.to(dev), 13)
        _, step_logits, _ = make_serve_step(cfg)(p, cache, prompt[:, -1:].to(dev), 11)
        out[dev] = (logits.cpu(), step_logits.cpu(),
                    fa.flash_attention.launches_tc - counts[0],
                    fd.flash_decode.launches_split - counts[1])
    assert out["cuda"][2:] == (cfg.n_layers, 13 * cfg.n_layers) and out["cpu"][2:] == (0, 0)
    for k in (0, 1):
        scale = out["cpu"][k].abs().max()
        assert (out["cuda"][k] - out["cpu"][k]).abs().max() < 6e-2 * scale
    assert (out["cuda"][0] - out["cuda"][1]).abs().max() < 6e-2 * out["cuda"][0].abs().max()


# ---------------------------------------------------------------------------
# MoE (models/moe.py): routing, dispatch, expert products and combine on the
# card against the CPU


def _moe_inputs(E, K, cf, dtype, seed, shape=(4, 16), d=64, ff=48):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe

    cfg = MoEConfig(n_experts=E, top_k=K, d_ff=ff, capacity_factor=cf)
    params = moe.moe_init(torch.Generator().manual_seed(seed), d, cfg, dtype, "cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape + (d,))).to(dtype)
    return cfg, params, x


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 4])
@pytest.mark.parametrize("E,K,cf", [(8, 2, 0.1), (8, 2, 1.25), (16, 4, 8.0), (384, 8, 1.25)])
def test_cuda_moe_apply_equals_cpu_f32(cuda, E, K, cf, n_chunks, perm):
    """f32, TF32 off around the router: the same routes, drops and
    outputs within 1e-5 of max |y| (tests/test_torch_moe.py's tolerance),
    the aux loss within 1e-6."""
    from repro_torch.models import moe

    cfg, params, x = _moe_inputs(E, K, cf, torch.float32, E + K)
    p = torch.as_tensor(np.random.default_rng(E).permutation(E)) if perm else None
    want = moe.moe_apply(params, x, moe_cfg=cfg, n_chunks=n_chunks, expert_perm=p)
    card = {k: v.to(cuda) for k, v in params.items()}
    got = moe.moe_apply(card, x.to(cuda), moe_cfg=cfg, n_chunks=n_chunks,
                        expert_perm=None if p is None else p.to(cuda))
    torch.cuda.synchronize()
    assert got[0].device.type == "cuda" and got[0].dtype == torch.float32
    _, _, idx_cpu = moe.route(params, x.reshape(-1, x.shape[-1]), cfg, p)
    _, _, idx_card = moe.route(card, x.to(cuda).reshape(-1, x.shape[-1]), cfg,
                               None if p is None else p.to(cuda))
    assert torch.equal(idx_card.cpu(), idx_cpu)
    scale = max(float(want[0].abs().max()), 1.0)
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-5 * scale
    assert abs(float(got[1]) - float(want[1])) <= 1e-6


def test_cuda_moe_router_stays_f32_under_tf32(cuda):
    """With TF32 switched on for the process, the router product still runs
    in true f32 (the routes equal the CPU's), and the setting comes back."""
    from repro_torch.models import moe

    cfg, params, x = _moe_inputs(384, 8, 1.25, torch.float32, 3, shape=(8, 64), d=512)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, _, idx = moe.route({k: v.to(cuda) for k, v in params.items()},
                              x.to(cuda).reshape(-1, 512), cfg)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    _, _, want = moe.route(params, x.reshape(-1, 512), cfg)
    assert torch.equal(idx.cpu(), want)


def test_cuda_moe_relabelling_is_exact(cuda):
    """An expert_perm from plan_expert_placement with the expert weights
    moved to their new slots: bf16 outputs equal bit for bit on the card,
    drops included (the check chip_smoke.py's moe phase makes at full
    width)."""
    from repro_torch.dist.sched_bridge import plan_expert_placement
    from repro_torch.models import moe

    cfg, params, x = _moe_inputs(16, 4, 1.25, torch.bfloat16, 5, shape=(4, 64), d=256, ff=128)
    card = {k: v.to(cuda) for k, v in params.items()}
    pl = plan_expert_placement(np.random.default_rng(0).pareto(1.5, 16) * 100, 4)
    moved = dict(card, **{k: card[k][torch.as_tensor(pl.perm, device=cuda)]
                          for k in ("w_up", "w_gate", "w_down")})
    base = moe.moe_apply(card, x.to(cuda), moe_cfg=cfg)[0]
    got = moe.moe_apply(moved, x.to(cuda), moe_cfg=cfg,
                        expert_perm=torch.as_tensor(pl.inv_perm, device=cuda))[0]
    assert torch.equal(got, base)


def test_cuda_moe_serving_takes_the_tensor_core_routes(cuda):
    """grok-1-314b's attention widths (48 query heads over 8 KV heads, hd
    128) with 8 experts top-2 at two layers and d 256, bf16: every prefill
    layer on "tc", every decode layer on "split"; at f32 the card's logits
    and greedy tokens equal the CPU's (1e-4)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    base = get_config("grok-1-314b")
    cfg = base.scaled(n_layers=2, d_model=256, d_ff=512, vocab=1000,
                      moe=dataclasses.replace(base.moe, d_ff=128))

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    prompt = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    counts = (fa.flash_attention.launches_tc, fd.flash_decode.launches_split)
    logits = make_prefill_step(cfg)(to(params), {"tokens": prompt.to(cuda)})
    _, cache = prefill_into_cache(to(params), cfg, prompt.to(cuda), 13)
    assert (fa.flash_attention.launches_tc - counts[0],
            fd.flash_decode.launches_split - counts[1]) == (cfg.n_layers, 12 * cfg.n_layers)
    assert torch.isfinite(logits).all()
    f32 = cfg.scaled(compute_dtype="float32")
    params = init_params(f32, torch.Generator().manual_seed(0), "cpu")
    out = {}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, p in (("cuda", to(params)), ("cpu", params)):
            lg = make_prefill_step(f32)(p, {"tokens": prompt.to(dev)})
            last, c = prefill_into_cache(p, f32, prompt.to(dev), 16)
            seq = [last]
            for i in range(3):
                nxt, _, c = make_serve_step(f32)(p, c, seq[-1][:, None], 12 + i)
                seq.append(nxt)
            out[dev] = (lg.cpu(), torch.stack(seq, 1).cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert (out["cuda"][0] - out["cpu"][0]).abs().max() < 1e-4 * max(out["cpu"][0].abs().max(), 1)
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def test_cuda_tensor_core_routes_replay_in_a_graph(cuda):
    """Both new kernels captured in one CUDA graph: replays equal eager."""
    q, k, v = _bshd(21, 2, 300, 300, 8, 2, 128, cuda)
    qd, kc, vc = _cache(22, 4, 32, 2, 96, 128, cuda)
    eager = (fa.flash_attention(q, k, v), fd.flash_decode(qd, kc, vc, 80))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        fa.flash_attention(q, k, v)
        fd.flash_decode(qd, kc, vc, 80)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before_tc, before_split = fa.flash_attention.launches_tc, fd.flash_decode.launches_split
    with torch.cuda.graph(graph):
        outs = (fa.flash_attention(q, k, v), fd.flash_decode(qd, kc, vc, 80))
    assert fa.flash_attention.launches_tc == before_tc + 1
    assert fd.flash_decode.launches_split == before_split + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)


def test_cuda_tensor_core_routes_refusals_launch_nothing(cuda):
    counts = lambda: (fa.flash_attention.launches, fa.flash_attention.launches_tc,  # noqa: E731
                      fd.flash_decode.launches, fd.flash_decode.launches_split)
    before = counts()
    x = torch.zeros(2, 4, 20, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="sq 20 > sk 10"):
        fa.flash_attention(x, x[:, :2, :10], x[:, :2, :10])
    with pytest.raises(ValueError, match="batch sizes differ"):
        fa.flash_attention(x, x[:1], x[:1])
    q = torch.zeros(2, 32, 128, dtype=torch.bfloat16, device=cuda)
    c = torch.zeros(2, 64, 2, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        fd.flash_decode(q, c, c, 65)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fd.flash_decode(q, c.float(), c.float(), 4)
    assert counts() == before


# ---------------------------------------------------------------------------
# placement: dada_place and heft_select (csrc/sched_place.cu)

# resource classes by position: paper_machine(8) (4 CPUs, 8 GPUs), a wide
# GPU-only machine, a two-CPU machine, the interleaved one of the CPU tests
# and two wide interleaved ones (2, 4 and 8 rids a lane in the DADA kernel)
PLACE_MACHINES = {"paper": [False] * 4 + [True] * 8, "gpu40": [True] * 40, "cpu2": [False] * 2,
                  "mixed": MACHINES["both"], "mixed70": [i % 2 == 1 for i in range(70)],
                  "mixed130": [i % 3 != 0 for i in range(130)]}


@pytest.mark.parametrize("n", [1, 3, 37, 128, 256])
@pytest.mark.parametrize("machine", sorted(PLACE_MACHINES))
def test_cuda_dada_place_equals_plain(cuda, machine, n):
    """36 seeds a shape: α 0 / 0.5 / 1, ±CP, ±area bound, both iteration
    limits, ties, rows without affinity, dedicated tasks."""
    for seed in range(36):
        layout, buf, scores = packed_dada(dada_case(seed, n=n, accel=PLACE_MACHINES[machine]))
        want = sp.dada_place(buf, scores, layout)
        before = sp.dada_place.launches
        got = sp.dada_place(buf.to(cuda), scores.to(cuda), layout)
        torch.cuda.synchronize()
        assert sp.dada_place.launches == before + 1
        assert torch.equal(got.cpu(), want), (machine, n, seed)
        assert sp.read_placement(want.numpy(), layout).status == sp.STATUS_OK


@pytest.mark.parametrize("n", [1, 3, 37, 128, 256])
@pytest.mark.parametrize("n_res", [2, 14, 40, 70])
def test_cuda_heft_select_equals_plain(cuda, n_res, n):
    for seed in range(8):
        layout, buf, scores = packed_heft(heft_case(seed, n=n, n_res=n_res))
        want = sp.heft_select(buf, scores, layout)
        out = torch.full((layout.n_out,), -5, dtype=torch.int64, device=cuda)
        before = sp.heft_select.launches
        got = sp.heft_select(buf.to(cuda), scores.to(cuda), layout, out=out)
        torch.cuda.synchronize()
        assert got.data_ptr() == out.data_ptr() and sp.heft_select.launches == before + 1
        assert torch.equal(got.cpu(), want), (n_res, n, seed)


def _dada_equals_plain(cuda, case):
    layout, buf, scores = packed_dada(case)
    want = sp.dada_place(buf, scores, layout)
    before = sp.dada_place.launches
    got = sp.dada_place(buf.to(cuda), scores.to(cuda), layout)
    torch.cuda.synchronize()
    assert sp.dada_place.launches == before + 1
    assert torch.equal(got.cpu(), want), (layout.spec, sp.read_placement(got.cpu().numpy(), layout),
                                          sp.read_placement(want.numpy(), layout))
    return sp.read_placement(want.numpy(), layout)


@pytest.mark.parametrize("n", [5, 37, 128])
@pytest.mark.parametrize("machine", sorted(PLACE_MACHINES))
def test_cuda_dada_place_mid_round_equals_plain(cuda, machine, n):
    """Searches that stop partway through a round of the midpoint tree (the
    iteration limit 2..7, the stopping rule between two levels): λ, the
    probe count and the placement of the last feasible probe equal the
    plain version's bit for bit."""
    for seed, max_iters, eps_rel in MID_ROUND:
        got = _dada_equals_plain(cuda, dada_case(seed, n=n, accel=PLACE_MACHINES[machine],
                                                 max_iters=max_iters, eps_rel=eps_rel))
        assert got.status == sp.STATUS_OK and got.iters <= max_iters


@pytest.mark.parametrize("n,plan", [(1000, (5, 2)), (1500, (5, 1)), (4000, (4, 0)),
                                    (8000, (2, 0))])
def test_cuda_dada_place_wide_activations_equal_plain(cuda, n, plan):
    """Thousands of ready tasks on paper_machine(8): C and the task vectors
    staged, the task vectors only, or nothing (read from global memory),
    under a shallower tree where the shared memory runs out."""
    accel = PLACE_MACHINES["paper"]
    assert sp.PlaceSpec("dada", n, len(accel), n_cpu=4, n_gpu=8).plan[:2] == plan
    for seed in (0, 4, 9, 13):  # α 0 / 0.5, ±CP, ±area bound
        assert _dada_equals_plain(cuda, dada_case(seed, n=n, accel=accel)).status == sp.STATUS_OK


@pytest.mark.parametrize("n,n_res", [(4000, 440), (3, 440), (100, 512), (2000, 14), (1700, 14),
                                     (40, 129)])
def test_cuda_heft_select_ring_and_wide_equal_plain(cuda, n, n_res):
    """HEFT through its ring of staged rows (n 4 000 at 440 resources, 512
    resources, 2 000 tasks at 14) and in one pass at the ring's edge and
    at 440 resources: equal to the plain version bit for bit."""
    for seed in range(2):
        layout, buf, scores = packed_heft(heft_case(seed, n=n, n_res=n_res))
        want = sp.heft_select(buf, scores, layout)
        got = sp.heft_select(buf.to(cuda), scores.to(cuda), layout)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (n, n_res, seed)


def test_cuda_place_plan_matches_the_launcher(cuda):
    """PlaceSpec.plan mirrors the launchers' own plan (repro_place_plan of
    csrc/sched_place.cu) across widths, resource counts and the edges."""
    import ctypes

    sp.build()
    got = (ctypes.c_int64 * 4)()
    for n in (1, 8, 37, 128, 512, 1000, 1500, 2000, 4000, 8000, 12885, 12886):
        for n_res, n_cpu in ((2, 2), (12, 4), (14, 6), (33, 11), (65, 20), (129, 43), (256, 0),
                             (257, 0)):
            for live in (False, True):
                spec = sp.PlaceSpec("dada", n, n_res, n_cpu=n_cpu, n_gpu=n_res - n_cpu, live=live)
                err = sp._lib.repro_place_plan(0, n, n_res, n_cpu, n_res - n_cpu, 0, int(live),
                                               got)
                assert (err == 0) == spec.fits_kernel, spec
                if err == 0:
                    assert tuple(got[:3]) == spec.plan
                    assert got[3] == 32 * ((1 << spec.plan[0]) - 1)
        for n_res in (1, 14, 440, 512, 513):
            spec = sp.PlaceSpec("heft", n, n_res, n_cls=2)
            err = sp._lib.repro_place_plan(1, n, n_res, 0, 0, 2, 0, got)
            assert (err == 0) == spec.fits_kernel, spec
            if err == 0:
                assert tuple(got[:3]) == spec.plan and got[3] == sp.HEFT_THREADS


@pytest.mark.parametrize("n", [1, 37, 128, 1500])
@pytest.mark.parametrize("kind", LIVE_KINDS)
def test_cuda_dada_place_liveness_equals_plain(cuda, kind, n):
    """A machine that lost resources: a dead rid 0, every GPU or every CPU
    dead but one, noticed columns paying their window, a dead and a
    noticed one; ±CP, ±area bound; C staged (n up to 128) and read from
    global memory (n 1 500): the kernel equals the plain version bit for
    bit and places nothing on a dead rid."""
    for seed in range(12 if n < 1500 else 3):
        accel = PLACE_MACHINES["paper"] if seed % 2 and kind not in ("one_gpu", "one_cpu") else None
        case = live_case(seed, kind, n=n, accel=accel,
                         area_bound=bool(seed % 3 == 1) if seed % 4 else None)
        got = _dada_equals_plain(cuda, case)
        assert got.status == sp.STATUS_OK
        dead = {j for j, sk in enumerate(case["skip"]) if sk and case["pen"][j] == 0.0}
        assert not dead & set(got.rids)


@pytest.mark.parametrize("dead,noticed", [((0,), ()), ((0, 2), (1,)), ((), (0, 3)),
                                          ((1, 3, 4, 5, 6), ())])
@pytest.mark.parametrize("n_res", [3, 14, 40, 70])
def test_cuda_heft_select_with_dead_columns_equals_plain(cuda, n_res, dead, noticed):
    """+inf transfer columns (detached resources) and notice penalties:
    heft_fold's fast path stays exact (order_key(+inf) below kNoKey, a
    dead rid 0 never taken), equal to the plain scan bit for bit."""
    for seed in range(6):
        case = live_heft_case(seed, dead=dead, noticed=noticed, n=(1, 37, 128)[seed % 3],
                              n_res=n_res)
        layout, buf, scores = packed_heft(case)
        want = sp.heft_select(buf, scores, layout)
        got = sp.heft_select(buf.to(cuda), scores.to(cuda), layout)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (n_res, dead, noticed, seed)


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1",
                                  "dada?alpha=0.5&use_cp=1&recover=1", "ws", "locality"])
@pytest.mark.parametrize("mode", ["drain", "kill"])
def test_cuda_faulted_run_equals_cpu(cuda, spec, mode):
    """Two GPUs lost and one back, each detach noticed ahead: the card's
    run, fault counters and audit log equal the CPU's, and every activation
    is one scoring launch plus one placement launch (HEFT, DADA), dead or
    noticed resources present."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.sched import resolve
    from repro_torch.verify import errors, verify_audit

    out = {}
    for dev in ("cuda", "cpu"):
        strat = resolve(spec) if spec == "ws" else resolve(spec, device=dev)
        sim = Simulator(tile_graph("cholesky", 8), paper_machine(4), strat, seed=3, noise=0.0,
                        audit=True, notice_s=0.002)
        gpus = [r.rid for r in sim.machine.gpus]
        for event, rid, at in (("detach", gpus[0], 0.004), ("detach", gpus[1], 0.006),
                               ("attach", gpus[0], 0.01)):
            sim.inject(event, rid, at=at, mode=mode if event == "detach" else None)
        before = (port.score_activation.launches, sp.dada_place.launches,
                  sp.heft_select.launches, sp.dada_place_plain.calls + sp.heft_select_plain.calls)
        res = sim.run()
        torch.cuda.synchronize()
        after = (port.score_activation.launches, sp.dada_place.launches,
                 sp.heft_select.launches, sp.dada_place_plain.calls + sp.heft_select_plain.calls)
        out[dev] = (sim, res, [a - b for a, b in zip(after, before)])
        assert errors(verify_audit(sim.audit)) == []
    (sim, res, card), (cpu_sim, cpu_res, cpu) = out["cuda"], out["cpu"]
    assert [(iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals] == [
        (iv.tid, iv.rid, iv.start, iv.end) for iv in cpu_res.intervals]
    assert (res.makespan, res.total_bytes, res.faults) == (
        cpu_res.makespan, cpu_res.total_bytes, cpu_res.faults)
    assert res.faults["n_detaches"] == 2 and res.faults["n_notices"] == 2
    assert cpu[:3] == [0, 0, 0] and card[3] == 0
    if spec == "ws":
        assert card == [0, 0, 0, 0]
    elif spec == "locality":
        assert card[0] > 0 and card[1:] == [0, 0, 0]
    else:
        assert card[0] == card[1] + card[2] > 0


def test_cuda_dada_place_reports_an_infeasible_upper_bound(cuda):
    case = dada_case(3, n=37, accel=PLACE_MACHINES["paper"])
    case["C"] = [[1e9] * len(row) for row in case["C"]]
    layout, buf, scores = packed_dada(case)
    got = sp.read_placement(sp.dada_place(buf.to(cuda), scores.to(cuda), layout).cpu().numpy(),
                            layout)
    assert got.status == sp.STATUS_INFEASIBLE
    assert got == sp.read_placement(sp.dada_place(buf, scores, layout).numpy(), layout)


def test_cuda_placement_beyond_its_envelope_raises(cuda):
    """Beyond the kernels' shared memory the wrappers raise before any
    launch; there is no fallback to the plain version."""
    layout, buf, scores = packed_dada(dada_case(0, n=13000, accel=PLACE_MACHINES["paper"]))
    hlayout, hbuf, hscores = packed_heft(heft_case(0, n=3, n_res=513))
    before = (sp.dada_place.launches, sp.heft_select.launches)
    plain = sp.dada_place_plain.calls + sp.heft_select_plain.calls
    wide = packed_dada(dada_case(1, n=4, accel=[True] * 300))
    for lay, b, sc in ((layout, buf, scores), wide):
        with pytest.raises(ValueError, match="beyond the kernel"):
            sp.dada_place(b.to(cuda), sc.to(cuda), lay)
    with pytest.raises(ValueError, match="beyond the kernel"):
        sp.heft_select(hbuf.to(cuda), hscores.to(cuda), hlayout)
    assert (sp.dada_place.launches, sp.heft_select.launches) == before
    assert sp.dada_place_plain.calls + sp.heft_select_plain.calls == plain


def test_cuda_placement_rejects_mixed_devices(cuda):
    layout, buf, scores = packed_dada(dada_case(1, n=5))
    before = sp.dada_place.launches
    with pytest.raises(ValueError, match="devices"):
        sp.dada_place(buf.to(cuda), scores, layout)
    assert sp.dada_place.launches == before


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5",
                                  "dada?alpha=0&area_bound=1"])
def test_cuda_place_backend_equals_cpu(cuda, spec):
    """place_dada / place_heft on the card equal the CPU backend's call
    bit for bit, with one launch of each kernel."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve

    tids = list(range(40))
    p_cpu, p_gpu = [1.0 + t for t in tids], [0.5 + 0.25 * t for t in tids]
    got = {}
    for dev in ("cuda", "cpu"):
        sim = Simulator(qr_graph(6, 256), paper_machine(8), resolve(spec, device=dev), seed=7)
        for k, name in enumerate(sim.arrays.data_names):
            if k % 3 == 0:
                sim.residency.write(name, k % 8)
        be, res, st = sim.strategy.backend, sim.machine.resources, sim.strategy
        before = (port.score_activation.launches, sp.dada_place.launches + sp.heft_select.launches)
        if spec == "heft":
            got[dev] = be.place_heft(sim, tids, res, order=tids[::-1], durations=[p_cpu, p_gpu],
                                     cls_of_res=[int(r.is_accelerator) for r in res],
                                     load_ts=[0.125 * (j % 5) for j in range(len(res))], now=0.25)
        else:
            got[dev] = be.place_dada(
                sim, tids, res, p_cpu=p_cpu, p_gpu=p_gpu, use_cp=st.use_cp,
                affinity="accel_write" if st.alpha > 0.0 else None, area_bound=st.area_bound,
                offsets=[0.0625 * (j % 3) for j in range(len(res))], flex_order=tids,
                max_off=0.125, sum_max=sum(max(a, b) for a, b in zip(p_cpu, p_gpu)),
                area=sum(min(a, b) for a, b in zip(p_cpu, p_gpu)), off_total=0.1875,
                alpha=st.alpha, eps_rel=st.eps_rel, max_iters=st.max_iters,
                cpu_rids=[r.rid for r in sim.machine.cpus], gpu_rids=[r.rid for r in sim.machine.gpus],
            )
        after = (port.score_activation.launches, sp.dada_place.launches + sp.heft_select.launches)
        assert after == tuple(b + (dev == "cuda") for b in before)
    assert got["cuda"] == got["cpu"]


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0"])
def test_cuda_cholesky_places_with_two_launches_per_activation(cuda, spec):
    """A warm Cholesky NT 6 simulation issues exactly two kernel launches
    and two copies per activation placed on the card (the profiler counts
    the runtime calls), and no plain search runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import run_simulation
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.sched import resolve

    strategy = resolve(spec)
    method = "place_heft" if spec == "heft" else "place_dada"
    place = getattr(strategy.backend, method)
    placed = [0]

    def counted(*args, **kwargs):
        placed[0] += 1
        return place(*args, **kwargs)

    setattr(strategy.backend, method, counted)
    run_simulation(cholesky_graph(6, 256), paper_machine(8), strategy, seed=0)  # warm buffers
    placed[0] = 0
    plain = sp.dada_place_plain.calls + sp.heft_select_plain.calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run_simulation(cholesky_graph(6, 256), paper_machine(8), strategy, seed=0)
        torch.cuda.synchronize()
    launch_calls = sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CUDA
                       and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    memcpy_calls = sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CUDA
                       and e.key.startswith("cudaMemcpy"))
    assert placed[0] > 0
    assert (launch_calls, memcpy_calls) == (2 * placed[0], 2 * placed[0])
    assert sp.dada_place_plain.calls + sp.heft_select_plain.calls == plain
    cpu = run_simulation(cholesky_graph(6, 256), paper_machine(8), resolve(spec, device="cpu"), seed=0)
    assert res.makespan == cpu.makespan and res.intervals == cpu.intervals


# ---------------------------------------------------------------------------
# the surrogate episode scan: one launch per group, bit-equal to the plain scan


def _episode_check(cuda, items, pad_to=None, extra=0):
    plan, batch = plan_and_batch(items)
    use_cap = bool(np.isfinite(batch.cap).any())
    n_steps = plan.n + extra
    args = ep.episode_inputs(plan, batch, torch.device("cpu"), pad_to)
    want = se.episode_plain(*args, n_steps=n_steps, use_cap=use_cap, emit=True)
    before = se.episode_scan.launches
    dargs = ep.episode_inputs(plan, batch, cuda, pad_to)
    got = se.episode_scan(*dargs, n_steps=n_steps, use_cap=use_cap, emit=True,
                          tables=ep.episode_tables(plan, cuda))
    torch.cuda.synchronize()
    assert se.episode_scan.launches == before + 1
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.cpu(), w)
    for name, g, w in zip(se.SCHEDULE_COLUMNS, got[3], want[3]):
        assert torch.equal(g.cpu(), w), name
    assert (got[2].cpu()[:len(batch)] == plan.n).all()


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_cuda_episode_scan_equals_plain(cuda, case):
    label, graph_key, gpus, specs, seeds, caps, pad_to, extra = case
    items = configs(case_graph(graph_key), gpus, specs, seeds, caps)
    _episode_check(cuda, items, pad_to, extra)


@pytest.mark.parametrize("label", ["assorted", "cap-mixed"])
def test_cuda_episode_scan_spare_warp(cuda, label):
    """An odd batch: the last block's spare warp leaves at once, and every
    configuration still equals the plain scan."""
    label, graph_key, gpus, specs, seeds, caps, pad_to, extra = next(
        c for c in cases() if c[0] == label)
    items = configs(case_graph(graph_key), gpus, specs, seeds, caps)
    items = items[:len(items) - 1 + len(items) % 2]
    assert len(items) % se.WARPS == 1
    _episode_check(cuda, items, None, extra)


def test_cuda_episode_plan_matches_the_launcher(cuda):
    """launch_plan mirrors the launcher's own plan (repro_episode_plan) on
    every case's shapes, and both refuse a warp whose shared memory cannot
    fit and a machine of more than 32 resources."""
    shapes = set()
    for label, graph_key, gpus, specs, seeds, caps, pad_to, extra in cases():
        plan, _ = plan_and_batch(configs(case_graph(graph_key), gpus, specs[:1], seeds[:1]))
        shapes.add((plan.n_res, plan.r_pad, plan.w_pad, plan.s_pad))
    shapes |= {(12, 2048, 2, 16), (12, 16384, 2, 16), (32, 64, 32, 128), (33, 4, 2, 16)}
    shapes.add((12, 8192, 2, 16))  # one warp a block
    for shape in sorted(shapes):
        assert se.launcher_plan(*shape) == se.launch_plan(*shape), shape
    assert se.launcher_plan(12, 16384, 2, 16) is None and se.launcher_plan(33, 4, 2, 16) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_episode_scan_on_tied_and_cut_priorities(cuda, seed):
    """Priorities of three values with a few -inf (the order ends early and
    later steps are inactive on task 0): the kernel, reading the order of
    those priorities (derived from the inputs, or by the wrapper when none
    are passed), equals the plain scan; the plan's tables are refused."""
    items = configs(tile_graph("cholesky", 6), (2, 8), FIGURE_SPECS, (seed,))
    plan, batch = plan_and_batch(items)
    args = list(ep.episode_inputs(plan, batch, torch.device("cpu")))
    rng = np.random.default_rng(seed)
    prio = rng.choice(np.array([1.0, 2.0, 3.0], np.float32), size=plan.n_pad)
    prio[rng.choice(np.arange(1, plan.n), size=seed, replace=False)] = -np.inf
    args[7] = torch.from_numpy(prio)
    want = se.episode_plain(*args, n_steps=plan.n + 2, use_cap=False, emit=True)
    dargs = list(ep.episode_inputs(plan, batch, cuda))
    dargs[7] = args[7].to(cuda)
    run = partial(se.episode_scan, *dargs, n_steps=plan.n + 2, use_cap=False, emit=True)
    with pytest.raises(ValueError, match="derived from other inputs"):
        run(tables=ep.episode_tables(plan, cuda))
    for got in (run(tables=se.plan_tables(dargs)), run()):
        for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
            assert torch.equal(g.cpu(), w)
    assert (want[2] < plan.n).all() == (seed > 0)


@pytest.mark.parametrize("kind", ["cholesky", "lu", "qr"])
def test_cuda_episode_scan_paper_size(cuda, kind):
    """NT 16, tile 512, paper_machine(1..8), the figure specs."""
    items = configs(tile_graph(kind, 16, 512), range(1, 9), FIGURE_SPECS, (1234,))
    _episode_check(cuda, items)


def test_cuda_run_batch_is_one_launch_per_group(cuda):
    items = configs(tile_graph("cholesky", 4), (1, 4, 8), FIGURE_SPECS, (1, 2))
    items += configs(tile_graph("lu", 4), (2, 8), FIGURE_SPECS, (3,), (0, 2 << 20))
    before = se.episode_scan.launches
    got = run_batch(items)
    assert se.episode_scan.launches == before + 2
    want = run_batch(items, device="cpu")
    assert se.episode_scan.launches == before + 2
    for a, b in zip(got, want):
        assert a == b


# ---------------------------------------------------------------------------
# the paper's experiment (repro_torch.bench) on the card

@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1"])
def test_cuda_run_many_equals_cpu(cuda, spec):
    """Every Summary field of the card's run_many equals the CPU's, and
    every activation was scored and placed on the card."""
    import dataclasses
    from functools import partial

    from repro_torch.bench.common import graphs_for, strategy_for
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import run_many

    graph = graphs_for(6, 256)["cholesky"]
    before = (port.score_activation.launches, sp.dada_place.launches + sp.heft_select.launches)
    got = run_many(graph, paper_machine(4), partial(strategy_for, spec, "cuda"), n_runs=3)
    after = (port.score_activation.launches, sp.dada_place.launches + sp.heft_select.launches)
    want = run_many(graph, paper_machine(4), partial(strategy_for, spec, "cpu"), n_runs=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert after[0] - before[0] == after[1] - before[1] > 0


@pytest.mark.parametrize("engine", ["exact", "surrogate"])
def test_cuda_two_engine_sweep(cuda, engine):
    """fig2's strategies at NT 4 on 2 and 8 GPUs through the sweep: the
    card's summaries equal the CPU's; the exact engine launches the
    scorer, the surrogate one episode_scan for the whole figure."""
    from repro_torch.bench.common import STRATEGIES, sweep_summaries

    before = (port.score_activation.launches, se.episode_scan.launches)
    got = sweep_summaries("cholesky", STRATEGIES, 2, (2, 8), engine=engine, nt=4, tile=256)
    launched = (port.score_activation.launches - before[0], se.episode_scan.launches - before[1])
    want = sweep_summaries("cholesky", STRATEGIES, 2, (2, 8), engine=engine, device="cpu",
                           nt=4, tile=256)
    assert got == want
    assert launched == ((launched[0], 0) if engine == "exact" else (0, 1))
    assert launched[0] > 0 or engine == "surrogate"
    ws = [s for _, label, s in got if label == "ws"]
    assert ws and (engine == "surrogate" or all(s.steals_mean > 0 for s in ws))


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "ws"])
@pytest.mark.parametrize("kind", ["cholesky", "lu", "qr"])
def test_cuda_audited_run_equals_cpu_and_verifies(cuda, kind, spec):
    """An audited run scored and placed on the card: its log equals the CPU
    run's record for record, verifies clean, and the result equals the
    audit-off run's."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.sched import resolve
    from repro_torch.verify import errors, verify_audit

    def run(device, audit):
        strategy = resolve(spec) if spec == "ws" else resolve(spec, device=device)
        sim = Simulator(tile_graph(kind, 8), paper_machine(8), strategy, seed=3, audit=audit)
        return sim, sim.run()

    card, res = run("cuda", True)
    cpu, _ = run("cpu", True)
    _, off = run("cuda", False)
    log, want = card.audit, cpu.audit
    assert (log.machine, log.graphs, log.result) == (want.machine, want.graphs, want.result)
    assert (log.execs, log.hops, log.landings) == (want.execs, want.hops, want.landings)
    assert errors(verify_audit(log)) == []
    assert [(iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals] == [
        (iv.tid, iv.rid, iv.start, iv.end) for iv in off.intervals]


def test_cuda_surrogate_audit_logs_equal_cpu(cuda):
    """episode_audit_logs over one episode_scan launch with the schedule
    emitted equals the CPU plain scan's logs, and every log verifies."""
    from repro_torch.verify import errors, verify_audit

    items = configs(tile_graph("lu", 8), (2, 8), ("heft", "dada?alpha=0.5&use_cp=1"), (1, 2, 3))
    plan, batch = plan_and_batch(items)
    se.episode_scan.launches = 0
    got = ep.episode_audit_logs(items[0]["graph"], batch,
                                ep.run_episodes(plan, batch, device="cuda", emit_schedule=True))
    assert se.episode_scan.launches == 1
    want = ep.episode_audit_logs(items[0]["graph"], batch,
                                 ep.run_episodes(plan, batch, device="cpu", emit_schedule=True))
    for a, b in zip(got, want):
        assert (a.machine, a.graphs, a.result, a.execs, a.hops) == (
            b.machine, b.graphs, b.result, b.execs, b.hops)
        assert errors(verify_audit(a)) == []
    assert len(got) == len(want) == len(items)


MB = 1024 * 1024


def _memory_fp(sim, res):
    m = sim.metrics
    return ([(iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals], res.makespan,
            res.total_bytes, res.n_transfers, m.n_evictions, m.n_writebacks, m.writeback_bytes,
            sorted(sim.memory.max_resident.items()))


@pytest.mark.parametrize("cap,eviction", [(0, "lru"), (24 * MB, "affinity"), (12 * MB, "lru")])
@pytest.mark.parametrize("spec", ["locality", "priority", "wfq", "heft",
                                  "dada?alpha=0.5&use_cp=1"])
def test_cuda_policy_and_bounded_runs_equal_cpu(cuda, spec, cap, eviction):
    """The score-matrix policies and the paper's strategies, unbounded and
    under a capacity, scored (and placed) on the card: the result, the
    memory's counters and the audit log equal the CPU run's, the log
    verifies clean, and every activation is one scoring launch (plus one
    placement launch for HEFT and DADA)."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.sched import resolve
    from repro_torch.verify import errors, verify_audit

    def run(device):
        strategy = resolve(spec, device=device)
        acts = [0]
        place = strategy.place

        def counted(sim, ready, src):
            acts[0] += 1
            place(sim, ready, src)

        strategy.place = counted
        sim = Simulator(tile_graph("lu", 8, 512), paper_machine(4), strategy, seed=3, audit=True,
                        mem_capacity=cap, eviction=eviction)
        before = (port.score_activation.launches, sp.dada_place.launches + sp.heft_select.launches)
        res = sim.run()
        after = (port.score_activation.launches, sp.dada_place.launches + sp.heft_select.launches)
        return sim, res, acts[0], (after[0] - before[0], after[1] - before[1])

    card, res, acts, launches = run("cuda")
    cpu, cpu_res, cpu_acts, cpu_launches = run("cpu")
    assert _memory_fp(card, res) == _memory_fp(cpu, cpu_res) and acts == cpu_acts
    assert (card.audit.execs, card.audit.hops, card.audit.landings, card.audit.evictions) == (
        cpu.audit.execs, cpu.audit.hops, cpu.audit.landings, cpu.audit.evictions)
    assert card.audit.machine["capacity"] == cap and errors(verify_audit(card.audit)) == []
    assert cpu_launches == (0, 0)
    placing = spec in ("heft", "dada?alpha=0.5&use_cp=1")
    assert launches == (acts, acts if placing else 0)
    assert (card.metrics.n_evictions > 0) == (cap > 0)


def test_cuda_random_policy_launches_nothing(cuda):
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.sched import resolve

    before = port.score_activation.launches
    res = Simulator(tile_graph("qr", 6), paper_machine(8), resolve("random"), seed=1,
                    mem_capacity=32 * MB).run()
    assert port.score_activation.launches == before and res.makespan > 0


@pytest.mark.parametrize("spec", ["priority", "wfq"])
def test_cuda_two_tenants_equal_cpu(cuda, spec):
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.runtime import Engine
    from repro_torch.sched import resolve

    out = {}
    for device in ("cuda", "cpu"):
        eng = Engine(paper_machine(4), resolve(spec, device=device), seed=2, mem_capacity=32 * MB)
        eng.submit(tile_graph("cholesky", 8), priority=1.0)
        eng.submit(tile_graph("lu", 6), priority=2.0)
        results = eng.run()
        out[device] = ([[(iv.tid, iv.rid, iv.start, iv.end) for iv in r.intervals]
                        for r in results], list(getattr(eng.strategy, "_vt", {}).items()))
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1"])
def test_cuda_x_bias_reaches_the_placement(cuda, spec):
    """place_heft / place_dada with a memory-pressure x_bias: the card's
    placement equals the CPU backend's bit for bit, and the bias moves
    it (the same call without it places otherwise)."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.runtime.memory import pressure_rows_for
    from repro_torch.sched import resolve

    tids = list(range(40))
    p_cpu, p_gpu = [1e-3 * (1.0 + t) for t in tids], [1e-3 * (0.5 + 0.25 * t) for t in tids]
    got = {}
    for dev in ("cuda", "cpu"):
        sim = Simulator(tile_graph("qr", 6), paper_machine(8), resolve(spec, device=dev), seed=7,
                        mem_capacity=2 * MB)
        for k, name in enumerate(sim.arrays.data_names):
            sim.residency.write(name, k % 8)  # every memory past its capacity
        bias = pressure_rows_for(sim, tids, sim.machine.resources)
        assert bias is not None and bias.max() > 0.0
        be, res, st = sim.strategy.backend, sim.machine.resources, sim.strategy
        for x_bias in (bias, None):
            if spec == "heft":
                placed = be.place_heft(sim, tids, res, order=tids[::-1],
                                       durations=[p_cpu, p_gpu],
                                       cls_of_res=[int(r.is_accelerator) for r in res],
                                       load_ts=[0.0] * len(res), now=0.0, x_bias=x_bias)
            else:
                placed = be.place_dada(
                    sim, tids, res, p_cpu=p_cpu, p_gpu=p_gpu, use_cp=True,
                    affinity="accel_write", area_bound=False, offsets=[0.0] * len(res),
                    flex_order=tids, max_off=0.0,
                    sum_max=sum(max(a, b) for a, b in zip(p_cpu, p_gpu)), area=0.0,
                    off_total=0.0, alpha=0.5, eps_rel=st.eps_rel, max_iters=st.max_iters,
                    cpu_rids=[r.rid for r in sim.machine.cpus],
                    gpu_rids=[r.rid for r in sim.machine.gpus], x_bias=x_bias)
            got[dev, x_bias is None] = placed
    assert got["cuda", False] == got["cpu", False]
    assert got["cuda", True] == got["cpu", True]
    assert got["cuda", False] != got["cuda", True]


# ---------------------------------------------------------------------------
# the serving pool: every round's dirty rows in one score_activation launch


def _pool_groups(seed):
    """Three tenant graphs under a seeded residency with device copies and
    their pool groups: a Cholesky NT 6 graph whole (56 rows: the
    reference's reduceat order), half of an LU NT 4 and a third of a QR NT
    3, for an engine per device."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.runtime.engine import Engine
    from repro_torch.sched import resolve

    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(seed)
        eng = Engine(paper_machine(8), resolve("heft", device="cpu"), seed=seed)
        groups = []
        for g, share in ((cholesky_graph(6, 256), 1), (lu_graph(4, 256), 2), (qr_graph(3, 256), 3)):
            ctx = eng.submit(g)
            for name in ctx.arrays.data_names:
                for mem in range(8):
                    if rng.random() < 0.25:
                        ctx.residency.add_copy(name, mem)
                if rng.random() < 0.2:
                    ctx.residency.write(name, int(rng.integers(8)))
            groups.append((ctx, list(range(0, len(g), share))))
        out[dev] = (eng, groups)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_pool_rows_equal_plain(cuda, seed):
    from repro_torch.core.backend import TorchScoringBackend

    runs = _pool_groups(seed)
    got = {}
    for dev, (eng, groups) in runs.items():
        be = TorchScoringBackend(dev)
        before = port.score_activation.launches
        got[dev] = torch.from_numpy(be.score_pool(groups, eng.machine.resources,
                                                  eng.transfer_model))
        assert port.score_activation.launches - before == (dev == "cuda")
        # each group alone equals its rows of the pooled call
        at = 0
        for ctx, tids in groups:
            one = be.score_pool([(ctx, tids)], eng.machine.resources, eng.transfer_model)
            assert torch.equal(torch.from_numpy(one), got[dev][at:at + len(tids)])
            at += len(tids)
    assert max(len(t) for _, t in runs["cuda"][1]) >= 32
    assert torch.equal(got["cuda"], got["cpu"])


def _serving_fp(out):
    e = out["engine"]
    return (out["tenants"], out["report"], out["n_events"], out["rows_built"],
            [(c.gid, iv.tid, iv.rid, iv.start, iv.end) for c in e._ctxs for iv in c.intervals],
            e._serving.n_rounds)


@pytest.mark.parametrize("mode", ["incremental", "full"])
def test_cuda_serving_pool_one_launch_per_round(cuda, mode):
    """A serving engine's run: one score_activation launch per round with
    a row to build (min_wide 1), the standalone transfer kernel none, and
    the run equal to the CPU's."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.load import default_catalog, make_arrivals
    from repro_torch.runtime.rescore import ServingScheduler
    from repro_torch.sched import resolve

    arr, catalog = make_arrivals("bursty", 48, rate=2000.0, seed=3), default_catalog()
    rounds, rebuild = [], ServingScheduler._rebuild

    def counted(self, engine, keys):
        rounds.append(sum(1 for k in keys if k in self.entries))
        return rebuild(self, engine, keys)

    fps = {}
    ServingScheduler._rebuild = counted
    try:
        for dev in ("cuda", "cpu"):
            rounds.clear()
            eng = Engine(paper_machine(4), resolve("wfq", device=dev), seed=0, rescore=mode,
                         device=dev)
            for a in arr:
                eng.submit(catalog[a.kind](), at=a.t, priority=a.priority)
            before, xfer = port.score_activation.launches, port.transfer_matrix.launches
            results = eng.run()
            torch.cuda.synchronize()
            launches = port.score_activation.launches - before
            assert port.transfer_matrix.launches == xfer
            assert launches == (sum(n >= 1 for n in rounds) if dev == "cuda" else 0)
            fps[dev] = ([(r.makespan, [(iv.tid, iv.rid, iv.start, iv.end) for iv in r.intervals])
                         for r in results], eng.metrics.n_events, eng._serving.rows_built,
                        eng._serving.n_rounds)
    finally:
        ServingScheduler._rebuild = rebuild
    assert fps["cuda"] == fps["cpu"]


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1"])
def test_cuda_run_serving_equals_cpu(cuda, spec):
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.runtime.load import make_arrivals, run_serving

    arr = make_arrivals("poisson", 64, rate=2000.0, seed=7)
    card = run_serving(arr, paper_machine(4), spec, seed=0, device="cuda")
    cpu = run_serving(arr, paper_machine(4), spec, seed=0, device="cpu")
    assert _serving_fp(card) == _serving_fp(cpu)
    assert card["report"]["n_tenants"] == 64


def test_cuda_serving_engine_raises_without_a_card(cuda, monkeypatch):
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.load import make_arrivals, run_serving
    from repro_torch.sched import resolve

    strategy = resolve("heft", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(paper_machine(2), strategy, rescore="incremental")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving(make_arrivals("poisson", 2), paper_machine(2), "heft")


# ---------------------------------------------------------------------------
# the selective scan (kernels/selective_scan.py, csrc/selective_scan.cu) at
# tests/_scan_cases.py's shapes and the hybrid model (jamba-v0.1-52b) on the card
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(map(str, c[:4])))
def test_cuda_selective_scan_equals_plain(cuda, case):
    """y and hT each within 1e-5 of their largest magnitude (f32; the sum
    over n and the fused multiply-adds run in another order than the plain
    loop's), one launch a call."""
    from repro_torch.kernels import selective_scan as ssk

    B, S, din, N, h0_zero = case
    args = scan_inputs(B, S, din, N, sum(case[:4]), cuda, h0_zero)
    want = ssk.selective_scan_plain(*args)
    before = ssk.selective_scan.launches
    got = ssk.selective_scan(*args)
    torch.cuda.synchronize()
    assert ssk.selective_scan.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32 and g.device.type == "cuda"
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    assert torch.equal(ssk.selective_scan(*args)[0], got[0])  # no atomics: the same bits


def test_cuda_selective_scan_refuses_and_launches_nothing(cuda):
    from repro_torch.kernels import selective_scan as ssk

    args = scan_inputs(2, 5, 70, 16, 1, cuda)
    before = ssk.selective_scan.launches
    with pytest.raises(ValueError, match="float32"):
        ssk.selective_scan(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ssk.selective_scan(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ssk.selective_scan(*args[:4], args[4][:, :8], args[5])
    with pytest.raises(ValueError, match="state size"):
        ssk.selective_scan(*scan_inputs(2, 5, 70, 12, 1, cuda))
    with pytest.raises(ValueError, match="devices"):
        ssk.selective_scan(*args[:5], args[5].cpu())
    assert ssk.selective_scan.launches == before


# the fused Mamba scan (mamba_scan) at tests/_scan_cases.py's FUSED_CASES:
# g at f32 and the state within 1e-5 of their largest magnitude (chip_smoke's
# SCAN_TOL: the recurrence takes ex2 and sums over n in another order), g at
# bf16 within 2^-7 (one bf16 ulp of a value can flip where y rounds) and,
# element by element, within _scan_cases.g_bf16_limit
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_mamba_scan_equals_plain(cuda, case, dtype):
    """One launch a call on mamba_apply's strided views; the state written
    in place (same storage); two calls from the same state give equal
    bits."""
    from repro_torch.kernels import selective_scan as ssk

    args = fused_inputs(*case, seed=sum(case), dev=cuda, dtype=dtype)
    state0 = None if args[8] is None else args[8].clone()
    want_state = None if state0 is None else state0.clone()
    want = ssk.mamba_scan_plain(*args[:8], want_state)
    before = ssk.mamba_scan.launches
    got = ssk.mamba_scan(*args)
    torch.cuda.synchronize()
    assert ssk.mamba_scan.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype and got.device.type == "cuda"
    assert (got.float() - want.float()).abs().max() <= FUSED_TOL[dtype] * want.float().abs().max()
    if dtype == torch.bfloat16:
        limit = g_bf16_limit(args[:8] + [state0], want, ssk.selective_scan_plain)
        assert g_bf16_reading(got, want, limit)[3]
    again_state = None if state0 is None else state0.clone()
    ptr = None if state0 is None else again_state.data_ptr()
    again = ssk.mamba_scan(*args[:8], again_state)
    assert torch.equal(again, got)
    if state0 is not None:
        assert again_state.data_ptr() == ptr and torch.equal(again_state, args[8])
        assert not torch.equal(args[8], state0)
        assert (args[8] - want_state).abs().max() <= 1e-5 * want_state.abs().max()


def test_cuda_mamba_scan_refuses_and_launches_nothing(cuda):
    from repro_torch.kernels import selective_scan as ssk

    args = fused_inputs(2, 5, 70, True, 8, seed=1, dev=cuda, dtype=torch.bfloat16)
    before = ssk.mamba_scan.launches
    with pytest.raises(ValueError, match="compute dtype"):
        ssk.mamba_scan(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="state must be float32"):
        ssk.mamba_scan(*args[:8], args[8].bfloat16())
    with pytest.raises(ValueError, match="unit stride"):
        ssk.mamba_scan(args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2), *args[2:])
    with pytest.raises(ValueError, match="state size"):
        ssk.mamba_scan(*args[:3], args[3][..., :12], args[4][..., :12], args[5][:, :12],
                       *args[6:8], args[8][..., :12].contiguous())
    with pytest.raises(ValueError, match="devices"):
        ssk.mamba_scan(*args[:8], args[8].cpu())
    assert ssk.mamba_scan.launches == before


def test_cuda_mamba_apply_is_one_launch(cuda):
    """A Mamba layer is one mamba_scan launch a call (prefill and a decode
    step), and no selective_scan launch."""
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.models import mamba as mamba_mod

    kw = dict(expand=2, d_state=16, d_conv=4)
    params = mamba_mod.mamba_init(torch.Generator(device=cuda).manual_seed(0), 64,
                                  dtype=torch.bfloat16, device=cuda, **kw)
    x = torch.randn(2, 9, 64, device=cuda).bfloat16()
    state = mamba_mod.mamba_state_init(2, 64, dtype=torch.bfloat16, device=cuda, **kw)
    before = (ssk.mamba_scan.launches, ssk.selective_scan.launches)
    mamba_mod.mamba_apply(params, x, **kw)
    mamba_mod.mamba_apply(params, x[:, :1], state=state, **kw)
    torch.cuda.synchronize()
    assert (ssk.mamba_scan.launches, ssk.selective_scan.launches) == (before[0] + 2, before[1])
    assert state["ssm"].abs().max() > 0


def _jamba_narrow(n_layers=8):
    """jamba-v0.1-52b's attention widths (32 query heads over 8 KV heads,
    hd 128), its pattern, 16 experts top-2 and d_state 16, at d 256."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    base = get_config("jamba-v0.1-52b")
    return base.scaled(n_layers=n_layers, d_model=256, d_ff=512, vocab=1000,
                       moe=dataclasses.replace(base.moe, d_ff=128))


@pytest.mark.parametrize("arch", ["smoke", "narrow"])
def test_cuda_jamba_serving_equals_cpu(cuda, arch):
    """The hybrid served on the card at f32 equals the CPU run (plain
    versions): greedy tokens equal, logits within 1e-4; one mamba_scan
    launch a Mamba layer and forward, one flash_attention / flash_decode
    launch an attention layer and forward, none on the CPU."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    cfg = (smoke_config("jamba-v0.1-52b") if arch == "smoke" else _jamba_narrow(16)).scaled(
        compute_dtype="float32")
    n_mamba = sum(cfg.block_pattern[i % cfg.period] == "mamba" for i in range(cfg.n_layers))
    n_attn = cfg.n_layers - n_mamba
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (2, 9)))
    out = {}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, p in (("cuda", to(params)), ("cpu", params)):
            fa.flash_attention.launches = fd.flash_decode.launches = ssk.mamba_scan.launches = 0
            logits = make_prefill_step(cfg)(p, {"tokens": prompt.to(dev)})
            last, cache = prefill_into_cache(p, cfg, prompt.to(dev), 14)
            toks = [last]
            step = make_serve_step(cfg)
            for i in range(4):
                nxt, _, cache = step(p, cache, toks[-1][:, None], 9 + i)
                toks.append(nxt)
            out[dev] = (logits.cpu(), torch.stack(toks, 1).cpu(), fa.flash_attention.launches,
                        fd.flash_decode.launches, ssk.mamba_scan.launches)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert out["cuda"][2:] == (n_attn, 13 * n_attn, 14 * n_mamba)
    assert out["cpu"][2:] == (0, 0, 0)
    assert (out["cuda"][0] - out["cpu"][0]).abs().max() < 1e-4 * max(out["cpu"][0].abs().max(), 1)
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def test_cuda_jamba_takes_the_tensor_core_routes(cuda):
    """At bf16 and jamba's attention widths every prefill attention layer
    takes "tc" and every decode one "split"; the Mamba layers launch the
    fused scan; logits finite."""
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.decode import make_prefill_step

    cfg = _jamba_narrow()
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)), device=cuda)
    counts = (fa.flash_attention.launches_tc, fd.flash_decode.launches_split,
              ssk.mamba_scan.launches)
    logits = make_prefill_step(cfg)(params, {"tokens": prompt})
    _, cache = prefill_into_cache(params, cfg, prompt, 13)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_tc - counts[0], fd.flash_decode.launches_split - counts[1],
            ssk.mamba_scan.launches - counts[2]) == (1, 12, 13 * 7)
    assert torch.isfinite(logits).all()
    assert cache["p0"]["ssm"].dtype == torch.float32 and cache["p0"]["conv"].dtype == torch.bfloat16
    assert torch.isfinite(cache["p0"]["ssm"]).all() and cache["p0"]["ssm"].abs().max() > 0
