"""Seeded inputs of the selective scan and the fused Mamba scan shared by
the CPU and card tests (test_torch_mamba_scan.py, test_torch_cuda.py) and
``chip_smoke.py``'s hybrid phase. Imports only numpy and torch."""
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


# the fused scan (mamba_scan), each case at f32 and bf16: (B, S, din, with a
# state, dt_rank). jamba's prefill (from zeros) and decode step (a state; its
# dt_rank 256), then ragged shapes that take both stagings: 16-byte rows
# (din 64, 200: S past a whole run, the last warp partly live) and element
# by element (din 70, 130, 9, 1; at din 64 with dt_rank 3, B and C off their
# 16-byte rows)
FUSED_CASES = [(4, 2048, 8192, False, 256), (4, 1, 8192, True, 256), (3, 37, 70, True, 4),
               (2, 33, 130, False, 8), (1, 100, 200, True, 8), (2, 65, 64, True, 8),
               (2, 40, 64, False, 3), (1, 7, 9, False, 1), (5, 1, 1, True, 1)]


def fused_inputs(B, S, din, with_state, rank, seed, dev, dtype):
    """The arguments of mamba_scan on ``dev`` as mamba_apply slices them:
    ``dt_pre`` and ``xc`` contiguous, ``z`` the second half of an ``xz`` (B,
    S, 2 din), ``Bm`` and ``Cm`` views of a ``proj`` (B, S, rank + 32) after
    its ``rank`` columns of dt_r; ``a_log`` log(1..16) plus noise, ``dt_bias``
    and ``d_skip`` drawn, all in ``dtype``; a standard normal f32 ``state``
    or None. ``dt_pre`` is a normal draw less 2 (small steps, as at random
    weights) with one value in 200 drawn in [20, 30), past softplus's
    threshold. Drawn on ``dev`` by a torch generator seeded with ``seed``
    (jamba's prefill shape takes seconds to draw on a host)."""
    N = 16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    dt_pre = normal(B, S, din) - 2.0
    dt_pre = torch.where(uniform(B, S, din) < 0.005, 20.0 + 10.0 * uniform(B, S, din), dt_pre)
    xc, xz, proj = normal(B, S, din), normal(B, S, 2 * din), normal(B, S, rank + 2 * N)
    a_log = torch.log(torch.arange(1, N + 1, device=dev, dtype=torch.float32))
    a_log = a_log + 0.1 * normal(din, N)
    dt_bias, d_skip = 0.5 * normal(din), 1.0 + 0.1 * normal(din)
    state = normal(B, din, N) if with_state else None
    xz, proj = xz.to(dtype), proj.to(dtype)
    return [dt_pre.to(dtype), xc.to(dtype), xz[..., din:], proj[..., rank:rank + N],
            proj[..., rank + N:], a_log.to(dtype), dt_bias.to(dtype), d_skip.to(dtype), state]


# mamba_scan's g at bf16 against mamba_scan_plain, element by element: the
# two f32 y may differ in their last bits (the kernel's ex2 and its order of
# the sum over n), so where y sits near a rounding boundary its bf16 value
# moves one ulp, and with it the gate's product (and silu(z), by the fast
# division): a few bf16 ulps of each value, G_BF16_REL. Where y cancels (a
# sum of terms far larger than itself) its f32 error is measured against
# those terms: Y_F32_REL of their magnitudes, scaled by |silu(z)|. Besides,
# at most G_BF16_SHARE of the elements (and at least one) may differ at all.
G_BF16_REL = 2.0 ** -5
Y_F32_REL = 1e-5
G_BF16_SHARE = 0.01


def g_bf16_limit(args, want, scan_plain):
    """The largest |got - want| each element of mamba_scan's bf16 ``g`` may
    take: G_BF16_REL |want| + Y_F32_REL |silu(z)| m, where m bounds the
    magnitudes y is summed from: the plain f32 scan ``scan_plain``
    (selective_scan_plain) of |x|, |B|, |C| and |h0| (each state at least
    |h|, since exp(dt A) > 0) plus |x d_skip|. ``args`` as fused_inputs
    returns them, the state as it was before the call."""
    import torch.nn.functional as F

    dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state = args
    dt = F.softplus(dt_pre + dt_bias).float().contiguous()
    A = (-torch.exp(a_log)).float().contiguous()
    x = xc.float().contiguous()
    h0 = (torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32, device=x.device)
          if state is None else state.abs())
    mag, _ = scan_plain(dt, x.abs(), Bm.float().abs().contiguous(),
                        Cm.float().abs().contiguous(), A, h0)
    mag = mag + (x * d_skip.float()).abs()
    return G_BF16_REL * want.float().abs() + Y_F32_REL * F.silu(z).float().abs() * mag


def g_bf16_reading(got, want, limit):
    """(max |got - want| over the limit, the share of elements over it, the
    share not bit-equal, whether it holds: none over and at most
    G_BF16_SHARE of the elements, and at least one, not bit-equal)."""
    diff = (got.float() - want.float()).abs()
    differ = diff != 0
    n_diff = int(differ.sum())
    ratio = (diff[differ] / limit[differ]).max().item() if n_diff else 0.0
    over = (diff > limit).float().mean().item()
    return ratio, over, n_diff / diff.numel(), (
        over == 0 and n_diff <= max(1, G_BF16_SHARE * diff.numel()))
