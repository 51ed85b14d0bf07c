"""The CUDA kernel against its plain versions, on the card (these tests
skip without a CUDA device: the kernel has no CPU mode). Imports only
torch, numpy and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import sched_score as port


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


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5"])
def test_cuda_simulation_equals_cpu(cuda, spec):
    """A whole simulation scored on the card equals the CPU run."""
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import run_simulation
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve

    def fingerprint(res):
        return (res.makespan, res.total_bytes, res.n_transfers, sorted(res.busy.items()),
                [(iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals])

    port.transfer_matrix.launches = 0
    on_card = run_simulation(qr_graph(6, 256), paper_machine(8), resolve(spec), seed=7)
    launches = port.transfer_matrix.launches
    on_cpu = run_simulation(qr_graph(6, 256), paper_machine(8), resolve(spec, device="cpu"), seed=7)
    assert fingerprint(on_card) == fingerprint(on_cpu)
    assert (launches > 0) == ("heft" in spec or "use_cp" in spec)
