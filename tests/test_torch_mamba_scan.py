"""The fused Mamba scan (``kernels/selective_scan.py::mamba_scan``) on the CPU.

On the CPU ``mamba_scan`` takes its plain version, ``mamba_scan_plain``,
which must be exactly the composition ``mamba_apply`` ran before the fusion
(softplus, ``A``, f32 copies, the plain scan, skip, cast, gate): bit for
bit, at f32 and bf16, prefill and decode, odd S and din, on the strided
views ``mamba_apply`` makes (``tests/_scan_cases.py``). ``mamba_apply`` on
the fused interface is held bit for bit against that composition, and the
plain version against the reference's lines (``repro/models/mamba.py:79-100``)
within ``test_torch_models.py``'s tolerances. The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _scan_cases import FUSED_CASES, fused_inputs, g_bf16_limit, g_bf16_reading
from repro.models import recurrent as jrec
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import mamba as tmamba
from test_torch_models import JDT, REL, TDT, _close

# the cases small enough for the CPU (jamba's own run on the card)
CPU_CASES = [c for c in FUSED_CASES if c[1] * c[2] < 100_000]
DTYPES = ["float32", "bfloat16"]
MAMBA_KW = dict(expand=2, d_state=16, d_conv=4)


def _case_id(c):
    return f"B{c[0]}-S{c[1]}-din{c[2]}-{'state' if c[3] else 'zeros'}-rank{c[4]}"


def _old_composition(dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state):
    """``mamba_apply``'s lines from ``dt_r @ w_dt`` to ``@ w_out`` before the
    fusion, as they stood, with the plain scan."""
    dt = F.softplus(dt_pre + dt_bias)
    A = -torch.exp(a_log)
    xs_f32 = xc.float()
    h0 = (state if state is not None
          else torch.zeros((xc.shape[0], xc.shape[2], 16), dtype=torch.float32))
    ys, hT = ssk.selective_scan(
        dt.float().contiguous(), xs_f32.contiguous(), Bm.float().contiguous(),
        Cm.float().contiguous(), A.float().contiguous(), h0,
    )
    y = ys + xs_f32 * d_skip
    return y.to(xc.dtype) * F.silu(z), hT


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CPU_CASES, ids=_case_id)
def test_mamba_scan_plain_is_the_old_composition(case, dtype):
    """Bit for bit, ``g`` and the state written in place; one call of the
    wrapper on CPU tensors launches nothing."""
    args = fused_inputs(*case, seed=sum(case), dev="cpu", dtype=TDT[dtype])
    state0 = None if args[8] is None else args[8].clone()
    want, want_h = _old_composition(*args[:8], state0)
    before = (ssk.mamba_scan.launches, ssk.selective_scan.launches)
    got = ssk.mamba_scan(*args)
    assert (ssk.mamba_scan.launches, ssk.selective_scan.launches) == before
    assert got.dtype == TDT[dtype] and got.shape == args[1].shape
    assert torch.equal(got, want)
    if args[8] is not None:
        assert torch.equal(args[8], want_h)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_scan_plain_matches_the_reference_lines(dtype):
    """The plain version against ``repro/models/mamba.py:79-100`` run in JAX
    (softplus, ``A``, the step through the reference's ``chunked_scan``, the
    skip, the cast and the gate) on the same draws, prefill and decode."""
    for case in ((2, 24, 64, False, 8), (3, 1, 70, True, 4)):
        args = fused_inputs(*case, seed=7, dev="cpu", dtype=TDT[dtype])
        j = [None if a is None else jnp.asarray(a.float().numpy(), JDT[dtype]) for a in args]
        j[8] = None if args[8] is None else jnp.asarray(args[8].numpy())
        dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state = j
        dt = jax.nn.softplus(dt_pre + dt_bias)
        A = -jnp.exp(a_log)

        def step(h, inp):
            dt_t, b_t, c_t, x_t = inp
            a_bar = jnp.exp(dt_t[..., None] * A[None])
            bx = (dt_t * x_t)[..., None] * b_t[:, None, :]
            h = a_bar * h + bx
            return h, (h * c_t[:, None, :]).sum(-1)

        xs_f32 = xc.astype(jnp.float32)
        seq = (dt.astype(jnp.float32).swapaxes(0, 1), Bm.astype(jnp.float32).swapaxes(0, 1),
               Cm.astype(jnp.float32).swapaxes(0, 1), xs_f32.swapaxes(0, 1))
        h0 = state if state is not None else jnp.zeros((case[0], case[2], 16), jnp.float32)
        hT, ys = jrec.chunked_scan(step, h0, seq)
        y = ys.swapaxes(0, 1) + xs_f32 * d_skip
        want = y.astype(JDT[dtype]) * jax.nn.silu(z)
        got = ssk.mamba_scan(*args)
        _close(got, want, REL[dtype])
        if state is not None:  # f32, but from dt rounded to bf16 where JAX rounds it
            _close(args[8], hT, REL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 19])
def test_mamba_apply_is_the_old_composition(S, dtype):
    """``mamba_apply`` on the fused interface returns exactly what it
    returned before: its in-projection, conv, ``x_proj`` and ``dt`` product
    done by hand, then the old composition, then ``@ w_out``; a decode step
    (S 1, from a non-zero state) writes the same ssm and conv states."""
    d, rng = 48, np.random.default_rng(S)
    p = tmamba.mamba_init(torch.Generator().manual_seed(S), d, dtype=TDT[dtype], device="cpu",
                          **MAMBA_KW)
    p["dt_bias"] = torch.as_tensor(rng.standard_normal(2 * d), dtype=TDT[dtype])
    x = torch.as_tensor(rng.standard_normal((2, S, d)), dtype=TDT[dtype])
    state = None
    if S == 1:
        state = tmamba.mamba_state_init(2, d, dtype=TDT[dtype], device="cpu", **MAMBA_KW)
        state["ssm"].copy_(torch.as_tensor(rng.standard_normal(state["ssm"].shape)))
        state["conv"].copy_(torch.as_tensor(rng.standard_normal(state["conv"].shape)))
    saved = None if state is None else {k: v.clone() for k, v in state.items()}
    got, _ = tmamba.mamba_apply(p, x, state=state, **MAMBA_KW)

    din, rank = 2 * d, d // 16
    xz = x @ p["w_in"]
    xs, z = xz[..., :din], xz[..., din:]
    if saved is None:
        xc = tmamba._conv1d_causal(xs, p["conv_w"], p["conv_b"])
    else:
        ctx = torch.cat([saved["conv"], xs], dim=1)
        xc = (ctx * p["conv_w"][None]).sum(dim=1, keepdim=True) + p["conv_b"]
    xc = F.silu(xc)
    proj = xc @ p["w_x"]
    g, hT = _old_composition(proj[..., :rank] @ p["w_dt"], xc, z, proj[..., rank:rank + 16],
                             proj[..., rank + 16:], p["a_log"], p["dt_bias"], p["d_skip"],
                             None if saved is None else saved["ssm"])
    assert torch.equal(got, g @ p["w_out"])
    if saved is not None:
        assert torch.equal(state["ssm"], hT)
        assert torch.equal(state["conv"], ctx[:, 1:])


def test_mamba_scan_writes_the_state_in_place():
    """The state tensor passed in is the one updated (same storage), with
    the plain scan's last state; g is a fresh tensor."""
    args = fused_inputs(2, 5, 24, True, 8, seed=3, dev="cpu", dtype=torch.float32)
    state = args[8]
    ptr, h0 = state.data_ptr(), state.clone()
    g = ssk.mamba_scan(*args)
    dt = F.softplus(args[0] + args[6])
    _, hT = ssk.selective_scan_plain(dt, args[1], args[3].contiguous(), args[4].contiguous(),
                                     -torch.exp(args[5]), h0)
    assert state.data_ptr() == ptr and torch.equal(state, hT)
    assert not torch.equal(state, h0)
    assert g.data_ptr() not in {a.data_ptr() for a in args[:8]}


def test_mamba_scan_refuses_what_the_kernel_does_not_take():
    """The CPU path refuses what the kernel would: mixed or unsupported
    dtypes, a non-f32 state, wrong shapes, N other than 16, an empty S or
    din, views without unit stride along the last axis, non-contiguous
    parameters or state, several devices; nothing launches."""
    args = fused_inputs(2, 5, 24, True, 8, seed=1, dev="cpu", dtype=torch.bfloat16)
    before = ssk.mamba_scan.launches

    def call(**swap):
        names = ("dt_pre", "xc", "z", "Bm", "Cm", "a_log", "dt_bias", "d_skip", "state")
        kw = dict(zip(names, args))
        kw.update(swap)
        return ssk.mamba_scan(**kw)

    refusals = [
        ("compute dtype", dict(dt_pre=args[0].float())),
        ("compute dtype", dict(Bm=args[3].float())),
        ("compute dtype", dict(d_skip=args[7].float())),
        ("float32 or bfloat16", {k: v.half() for k, v in zip(
            ("dt_pre", "xc", "z", "Bm", "Cm", "a_log", "dt_bias", "d_skip"), args[:8])}),
        ("state must be float32", dict(state=args[8].double())),
        ("shape", dict(state=args[8][:, :8])),
        ("shape", dict(z=args[2][:, :4])),
        ("shape", dict(dt_bias=args[6][:8])),
        ("state size", dict(a_log=args[5][:, :12], Bm=args[3][..., :12], Cm=args[4][..., :12],
                            state=args[8][..., :12].contiguous())),
        ("at least 1", {k: v[:, :0] for k, v in zip(("dt_pre", "xc", "z", "Bm", "Cm"),
                                                     args[:5])}),
        ("unit stride", dict(xc=args[1].transpose(1, 2).contiguous().transpose(1, 2))),
        ("contiguous", dict(a_log=args[5].t().contiguous().t())),
        ("contiguous", dict(state=args[8].transpose(1, 2).contiguous().transpose(1, 2))),
        ("several devices", dict(state=args[8].to("meta"))),
    ]
    for match, swap in refusals:
        with pytest.raises(ValueError, match=match):
            call(**swap)
    assert ssk.mamba_scan.launches == before


def _f64_recurrence(dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state):
    """The composition with the recurrence in f64, rounded to f32 before
    the skip: a sound scan whose y differs from the plain f32 loop's in its
    last bits, as the kernel's does."""
    dt = F.softplus(dt_pre + dt_bias).double()
    A = (-torch.exp(a_log)).double()
    x = xc.double()
    h = (torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float64)
         if state is None else state.double())
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None].double())
        ys.append((h * Cm[:, t, None].double()).sum(-1).float())
    y = torch.stack(ys, 1) + xc.float() * d_skip
    return y.to(xc.dtype) * F.silu(z)


def _ungated_rounding(dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state):
    """The gate's product taken on the f32 y (one rounding where the plain
    version has two)."""
    dt = F.softplus(dt_pre + dt_bias)
    A = -torch.exp(a_log)
    h0 = torch.zeros((xc.shape[0], xc.shape[2], 16)) if state is None else state
    ys, _ = ssk.selective_scan_plain(dt.float().contiguous(), xc.float().contiguous(),
                                     Bm.float().contiguous(), Cm.float().contiguous(),
                                     A.float().contiguous(), h0)
    return ((ys + xc.float() * d_skip) * F.silu(z).float()).to(xc.dtype)


# (name, the fault as a function of the inputs and the plain g)
_PLANTED = [
    ("skip left out", lambda a, want: ssk.mamba_scan_plain(*a[:7], torch.zeros_like(a[7]), a[8])),
    ("y not rounded before the gate", lambda a, want: _ungated_rounding(*a)),
    ("O(1) error below 1", lambda a, want: torch.where(want.abs() < 1, want + 0.5, want)),
]


@pytest.mark.parametrize("case", CPU_CASES, ids=_case_id)
def test_g_bf16_limit_holds_a_sound_scan(case):
    """The card's element-by-element limit on bf16 g (chip_smoke.py's
    scan_check, test_torch_cuda.py) takes a sound scan whose f32 y differs
    from the plain loop's in its last bits."""
    args = fused_inputs(*case, seed=sum(case), dev="cpu", dtype=torch.bfloat16)
    state0 = None if args[8] is None else args[8].clone()
    want = ssk.mamba_scan_plain(*args[:8], None if state0 is None else state0.clone())
    limit = g_bf16_limit(args[:8] + [state0], want, ssk.selective_scan_plain)
    assert g_bf16_reading(want, want, limit) == (0.0, 0.0, 0.0, True)
    assert g_bf16_reading(_f64_recurrence(*args[:8], state0), want, limit)[3]


@pytest.mark.parametrize("fault", [f[0] for f in _PLANTED])
def test_g_bf16_limit_catches_planted_faults(fault):
    """Each planted fault breaks the limit: too far from the plain g in
    some element, or not bit-equal in more than G_BF16_SHARE of them."""
    args = fused_inputs(2, 65, 64, True, 8, seed=7, dev="cpu", dtype=torch.bfloat16)
    state0 = args[8].clone()
    want = ssk.mamba_scan_plain(*args[:8], state0.clone())
    limit = g_bf16_limit(args[:8] + [state0], want, ssk.selective_scan_plain)
    bad = dict(_PLANTED)[fault](args[:8] + [state0.clone()], want)
    assert not g_bf16_reading(bad, want, limit)[3]
