"""Seeded inputs of the selective scan shared by the card tests
(test_torch_cuda.py) and ``chip_smoke.py``'s hybrid phase. Imports only
numpy and torch."""
import numpy as np
import torch

# (B, S, din, N, h0 zeros): jamba's prefill and decode step (B 4, din 8 192,
# N 16), odd S, channels no multiple of the kernel's 64 a block, one channel
SCAN_CASES = [(4, 2048, 8192, 16, True), (4, 1, 8192, 16, False), (3, 37, 70, 16, False),
              (2, 33, 130, 16, False), (1, 100, 200, 16, True), (2, 65, 64, 16, False),
              (1, 7, 9, 16, False), (5, 1, 1, 16, False)]


def scan_inputs(B, S, din, N, seed, dev, h0_zero=False):
    """f32 inputs of selective_scan on ``dev``: dt a softplus of normal
    draws less 2 (as small as mamba_apply's at random weights), x, B and C
    standard normal, A = -(1..N) for every channel (jamba's -exp(a_log)),
    h0 zeros (a prefill) or normal (a decode state)."""
    rng = np.random.default_rng(seed)
    arrays = [np.log1p(np.exp(rng.standard_normal((B, S, din)) - 2.0)),
              rng.standard_normal((B, S, din)), rng.standard_normal((B, S, N)),
              rng.standard_normal((B, S, N)), -np.tile(np.arange(1, N + 1), (din, 1)),
              (np.zeros if h0_zero else rng.standard_normal)((B, din, N))]
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]
