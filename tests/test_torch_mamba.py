"""The port's Mamba block and the hybrid model (jamba-v0.1-52b) against the
JAX package.

Inputs are numpy draws with a seed; weights come from the reference's own
``mamba_init`` / ``init_params``, carried over as numpy arrays (through
``convert.params_from_jax`` for the whole model). On the CPU the selective
scan takes its plain version (the reference's ``step`` looped in PyTorch),
so no kernel launches here; ``tests/test_torch_cuda.py`` holds the kernel
against that plain version on the card.

Tolerances: ``F32_REL`` 1e-5 and ``BF16_REL`` 2e-2 of the largest magnitude,
the tolerances of ``test_torch_models.py`` and for its reasons (measured:
under 2e-7 for ``mamba_apply`` at f32, about one bf16 ulp, 7e-3, at bf16),
and greedy tokens equal at f32. One more, stated with its reason: the whole
jamba smoke model at bf16 is held block by block, each block on the
reference's own bf16 input, within ``BF16_REL``. Its whole-model bf16 logits
are not compared, because the reference's own bf16 forward lies 0.045 to
0.41 of the largest logit from its f32 forward on this config (seeds 0..2):
one ulp apart, a token's top-2 experts flip among the smoke config's four,
and the flip moves the logits by far more than rounding does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config, smoke_config
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache
from repro.models import mamba as jmamba
from repro.models import recurrent as jrec
from repro.models import transformer as JT
from repro.serve.decode import make_prefill_step as jax_make_prefill_step
from repro.serve.decode import make_serve_step as jax_make_serve_step
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import selective_scan as ssk
from repro_torch.launch import serve as tlaunch
from repro_torch.models import mamba as tmamba
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as T
from repro_torch.serve import decode as tdecode
from test_torch_models import F32_REL, JDT, REL, TDT, _close

ARCH = "jamba-v0.1-52b"
MAMBA_KW = dict(expand=2, d_state=16, d_conv=4)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def _mamba_case(dtype, d=64, seed=0):
    """The reference's Mamba weights in both packages, cast to the compute
    dtype as the reference's ``_cast_floats`` casts them (``a_log``,
    ``dt_bias`` and ``d_skip`` too)."""
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), d, dtype=jnp.float32, **MAMBA_KW)
    jp = {k: v.astype(JDT[dtype]) for k, v in jp.items()}
    return jp, {k: _to_torch(v, TDT[dtype]) for k, v in jp.items()}


def _input(shape, dtype, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32),
                    JDT[dtype])
    return x, _to_torch(x, TDT[dtype])


def _state(B, d, dtype, seed):
    """A non-zero decode state in both packages (``ssm`` f32, ``conv`` in
    the compute dtype)."""
    rng = np.random.default_rng(seed)
    din = MAMBA_KW["expand"] * d
    ssm = rng.standard_normal((B, din, MAMBA_KW["d_state"])).astype(np.float32)
    conv = jnp.asarray(rng.standard_normal((B, MAMBA_KW["d_conv"] - 1, din)), JDT[dtype])
    return ({"ssm": jnp.asarray(ssm), "conv": conv},
            {"ssm": torch.from_numpy(ssm.copy()), "conv": _to_torch(conv, TDT[dtype])})


# ---------------------------------------------------------------------------
# the scan
def test_chunked_scan_equals_lax_scan():
    """A step over a pair of inputs at S 300 (one chunk of the reference's)
    and S 512 (its chunked branch)."""

    def step(h, inp):
        a, b = inp
        h = 0.9 * h + a * b
        return h, h.sum(-1)

    for S in (300, 512):
        rng = np.random.default_rng(S)
        a, b = (rng.standard_normal((S, 3, 8)).astype(np.float32) for _ in range(2))
        h0 = rng.standard_normal((3, 8)).astype(np.float32)
        jh, jy = jrec.chunked_scan(step, jnp.asarray(h0), (jnp.asarray(a), jnp.asarray(b)))
        th, ty = trec.chunked_scan(step, torch.from_numpy(h0),
                                   (torch.from_numpy(a), torch.from_numpy(b)))
        _close(th, jh, F32_REL)
        _close(ty, jy, F32_REL)


def _ref_step_scan(dt, x, Bm, Cm, A, h0):
    """The reference's ``step`` (``repro/models/mamba.py:82-88``, copied
    verbatim: it is a closure inside ``mamba_apply``) through its
    ``chunked_scan``, on (B, S, .) inputs."""

    def step(h, inp):
        dt_t, b_t, c_t, x_t = inp
        a_bar = jnp.exp(dt_t[..., None] * A[None])
        bx = (dt_t * x_t)[..., None] * b_t[:, None, :]
        h = a_bar * h + bx
        y = (h * c_t[:, None, :]).sum(-1)
        return h, y

    seq = tuple(jnp.asarray(a).swapaxes(0, 1) for a in (dt, Bm, Cm, x))
    hT, ys = jrec.chunked_scan(step, jnp.asarray(h0), seq)
    return ys.swapaxes(0, 1), hT


def _scan_inputs(B, S, din, N, seed, h0_zero=False):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, din)))).astype(np.float32)  # softplus > 0
    x = rng.standard_normal((B, S, din)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (din, 1))
    h0 = (np.zeros if h0_zero else rng.standard_normal)((B, din, N)).astype(np.float32)
    return dt, x, Bm, Cm, A, h0


@pytest.mark.parametrize("B,S,din,N,h0_zero", [
    (2, 1, 24, 16, False), (2, 24, 24, 16, True), (1, 512, 8, 16, True), (3, 37, 70, 16, False),
    (2, 5, 9, 16, False), (1, 3, 5, 16, False),
])
def test_selective_scan_plain_matches_reference_step(B, S, din, N, h0_zero):
    args = _scan_inputs(B, S, din, N, seed=S + din, h0_zero=h0_zero)
    want_y, want_h = _ref_step_scan(*args)
    before = ssk.selective_scan.launches
    y, hT = ssk.selective_scan(*(torch.from_numpy(a) for a in args))
    assert ssk.selective_scan.launches == before  # the CPU: the plain version, no launch
    assert y.shape == (B, S, din) and hT.shape == (B, din, N)
    assert y.dtype == hT.dtype == torch.float32
    _close(y, want_y, F32_REL)
    _close(hT, want_h, F32_REL)


def test_selective_scan_refuses_what_the_kernel_does_not_take():
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 5, 8, 16, seed=1)]
    with pytest.raises(ValueError, match="float32"):
        ssk.selective_scan(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ssk.selective_scan(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ssk.selective_scan(*args[:5], args[5][:, :4])
    with pytest.raises(ValueError, match="shape"):
        ssk.selective_scan(args[0], args[1][:, :4], *args[2:])
    odd = [torch.from_numpy(a) for a in _scan_inputs(2, 5, 8, 12, seed=1)]
    with pytest.raises(ValueError, match="state size"):
        ssk.selective_scan(*odd)
    with pytest.raises(ValueError, match="at least 1"):
        ssk.selective_scan(*(a[:, :0] if a.shape[1] == 5 else a for a in args))
    with pytest.raises(ValueError, match="several devices"):
        ssk.selective_scan(*args[:5], args[5].to("meta"))


@pytest.mark.parametrize("N", [4, 8, 32, 64])
def test_selective_scan_takes_state_size_16_only(N):
    """The kernel is built for N 16 alone (every Mamba config of the repo);
    the wrapper refuses other state sizes on the CPU too."""
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 3, 8, N, seed=N)]
    with pytest.raises(ValueError, match="state size"):
        ssk.selective_scan(*args)


# ---------------------------------------------------------------------------
# the Mamba block
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 24, 512])
def test_conv1d_causal_matches_reference(S, dtype):
    xj, xt = _input((2, S, 48), dtype, seed=S)
    wj, wt = _input((4, 48), dtype, seed=S + 1)
    bj, bt = _input((48,), dtype, seed=S + 2)
    want = jmamba._conv1d_causal(xj, wj, bj)
    got = tmamba._conv1d_causal(xt, wt, bt)
    assert got.dtype == TDT[dtype]
    _close(got, want, REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 24, 512])
def test_mamba_apply_full_sequence_matches_reference(S, dtype):
    """S 512 takes the reference's chunked branch of ``chunked_scan``
    (S > 256, S % 256 == 0)."""
    jp, tp = _mamba_case(dtype, seed=S)
    xj, xt = _input((2, S, 64), dtype, seed=S + 3)
    want, jstate = jmamba.mamba_apply(jp, xj, **MAMBA_KW)
    got, state = tmamba.mamba_apply(tp, xt, **MAMBA_KW)
    assert jstate is None and state is None and got.dtype == TDT[dtype]
    _close(got, want, REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_decode_step_matches_reference(dtype):
    """One step from a non-zero state: the output and the new ``ssm`` and
    ``conv``, written in place into the state passed in."""
    jp, tp = _mamba_case(dtype, seed=4)
    xj, xt = _input((2, 1, 64), dtype, seed=5)
    jstate, tstate = _state(2, 64, dtype, seed=6)
    buffers = dict(tstate)
    want, jnew = jmamba.mamba_apply(jp, xj, state=jstate, **MAMBA_KW)
    got, new = tmamba.mamba_apply(tp, xt, state=tstate, **MAMBA_KW)
    assert new is tstate and all(new[k] is buffers[k] for k in buffers)  # in place
    assert new["ssm"].dtype == torch.float32 and new["conv"].dtype == TDT[dtype]
    _close(got, want, REL[dtype])
    _close(new["ssm"], jnew["ssm"], REL[dtype])
    _close(new["conv"], jnew["conv"], REL[dtype])


def test_mamba_decode_steps_equal_the_full_sequence():
    """Twelve decode steps from the zero state give the full sequence's
    outputs, and the reference's state after them."""
    jp, tp = _mamba_case("float32", seed=7)
    xj, xt = _input((2, 12, 64), "float32", seed=8)
    full, _ = tmamba.mamba_apply(tp, xt, **MAMBA_KW)
    state = tmamba.mamba_state_init(2, 64, dtype=torch.float32, device="cpu", **MAMBA_KW)
    jstate = jmamba.mamba_state_init(2, 64, dtype=jnp.float32, **MAMBA_KW)
    steps = []
    for t in range(12):
        y, state = tmamba.mamba_apply(tp, xt[:, t : t + 1], state=state, **MAMBA_KW)
        steps.append(y)
        _, jstate = jmamba.mamba_apply(jp, xj[:, t : t + 1], state=jstate, **MAMBA_KW)
    _close(torch.cat(steps, 1), full, F32_REL)
    _close(state["ssm"], jstate["ssm"], F32_REL)
    _close(state["conv"], jstate["conv"], F32_REL)


def test_mamba_apply_refuses_a_multi_token_step():
    _, tp = _mamba_case("float32")
    _, tstate = _state(2, 64, "float32", seed=1)
    with pytest.raises(ValueError, match="single-token"):
        tmamba.mamba_apply(tp, torch.zeros(2, 3, 64), state=tstate, **MAMBA_KW)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_init_and_state_match_the_reference_layout(dtype):
    d = 96
    p = tmamba.mamba_init(torch.Generator().manual_seed(0), d, dtype=dtype, device="cpu",
                          **MAMBA_KW)
    jp = jmamba.mamba_init(jax.random.PRNGKey(0), d, dtype=jnp.float32, **MAMBA_KW)
    assert set(p) == set(jp)
    for k, t in p.items():
        assert tuple(t.shape) == jp[k].shape and t.dtype == dtype
    for k in ("conv_b", "dt_bias", "d_skip"):  # not random: equal after the cast
        assert torch.equal(p[k], _to_torch(jp[k], dtype))
    # log(1..N) by torch and by XLA: within an f32 ulp (equal once cast to bf16)
    _close(p["a_log"], jp["a_log"].astype(jnp.float32 if dtype == torch.float32 else jnp.bfloat16),
           F32_REL)
    for k in ("w_in", "w_x", "w_dt", "w_out", "conv_w"):  # N(0, 1/fan_in); conv 1/width
        scale = 1.0 / MAMBA_KW["d_conv"] if k == "conv_w" else p[k].shape[0] ** -0.5
        got = float(p[k].float().std())
        assert abs(got - scale) < 0.1 * scale
    st = tmamba.mamba_state_init(3, d, dtype=dtype, device="cpu", **MAMBA_KW)
    jst = jmamba.mamba_state_init(3, d, dtype=jnp.float32, **MAMBA_KW)
    assert tuple(st["ssm"].shape) == jst["ssm"].shape and st["ssm"].dtype == torch.float32
    assert tuple(st["conv"].shape) == jst["conv"].shape and st["conv"].dtype == dtype
    assert not any(bool(t.any()) for t in st.values())


# ---------------------------------------------------------------------------
# the hybrid model
def _setup_model(periods=1, compute_dtype="float32", cf=None):
    cfg = smoke_config(ARCH).scaled(compute_dtype=compute_dtype)
    tcfg = treg.smoke_config(ARCH).scaled(compute_dtype=compute_dtype)
    cfg = cfg.scaled(n_layers=periods * cfg.period)
    tcfg = tcfg.scaled(n_layers=periods * tcfg.period)
    if cf is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        tcfg = tcfg.scaled(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, tcfg, params, tparams


def test_check_supported_takes_the_hybrid_and_refuses_the_rest():
    for cfg in (treg.get_config(ARCH), treg.smoke_config(ARCH)):
        T.check_supported(cfg)
        assert cfg.family == "hybrid" and set(cfg.block_pattern) == {"attn", "mamba"}
    for arch in ("xlstm-1.3b", "seamless-m4t-medium", "internvl2-76b"):
        for cfg in (treg.get_config(arch), treg.smoke_config(arch)):
            with pytest.raises(NotImplementedError, match=r"items 7\(4\)-7\(6\)"):
                T.check_supported(cfg)
    # a hybrid whose attention is MLA, or an xLSTM block in the pattern, is not served
    cfg = treg.smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.check_supported(cfg.scaled(block_pattern=("mamba", "mlstm")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.check_supported(cfg.scaled(mla=treg.smoke_config("minicpm3-4b").mla))


@pytest.mark.parametrize("periods", [1, 2])
def test_params_layout_matches_reference(periods):
    """Layer ``period * k + j`` is the reference's ``p{j}`` at period ``k``,
    every leaf in the compute dtype (f32 ``a_log`` and the router too); MoE
    at the odd pattern positions; init_params makes the same tree."""
    cfg, tcfg, params, tparams = _setup_model(periods, "bfloat16")
    blocks = tparams["blocks"]
    assert len(blocks) == cfg.n_layers == 8 * periods
    for i, bp in enumerate(blocks):
        j, k = i % cfg.period, i // cfg.period
        kind = cfg.block_pattern[j]
        ref = params["blocks"][f"p{j}"]
        assert set(bp) == set(ref)
        assert ("mamba" in bp) == (kind == "mamba") and ("attn" in bp) == (kind == "attn")
        assert ("moe" in bp) == (j % 2 == 1)
        for sub in bp:
            for name, t in bp[sub].items():
                want = np.asarray(ref[sub][name][k]).astype(np.float32)
                assert tuple(t.shape) == want.shape and t.dtype == torch.bfloat16
                assert torch.equal(t, torch.from_numpy(want).to(torch.bfloat16))
    mine = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert len(mine["blocks"]) == len(blocks)
    for a, b in zip(mine["blocks"], blocks):
        assert set(a) == set(b)
        for sub in a:
            assert {n: (t.shape, t.dtype) for n, t in a[sub].items()} == {
                n: (t.shape, t.dtype) for n, t in b[sub].items()}


@pytest.mark.parametrize("periods", [1, 2])
def test_forward_matches_reference(periods):
    cfg, tcfg, params, tparams = _setup_model(periods)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 24))
    want, _, want_aux = JT.forward(params, cfg, jnp.asarray(tok, jnp.int32))
    before = (fa.flash_attention.launches, ssk.selective_scan.launches)
    got, cache, aux = T.forward(tparams, tcfg, torch.as_tensor(tok))
    assert before == (fa.flash_attention.launches, ssk.selective_scan.launches)
    assert cache is None and got.dtype == torch.float32
    _close(got, want, F32_REL)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 and float(aux) > 0.0
    last = T.forward(tparams, tcfg, torch.as_tensor(tok), last_logit_only=True)[0]
    assert last.shape == (2, 1, cfg.vocab)
    _close(last[:, 0], got[:, -1], F32_REL)


def test_blocks_match_reference_bf16():
    """Every block of the bf16 smoke model (Mamba with an MLP, Mamba with
    MoE, attention with an MLP) on the reference's own bf16 input, within
    BF16_REL of the block's output (the module docstring says why the
    whole model is not compared at bf16)."""
    cfg, tcfg, params, tparams = _setup_model(1, "bfloat16")
    cast = JT._cast_floats(params, jnp.bfloat16)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 24))
    x = cast["embed"]["table"][jnp.asarray(tok)]
    for i in range(cfg.n_layers):
        j = i % cfg.period
        kind = cfg.block_pattern[j]
        bp = jax.tree.map(lambda a: a[i // cfg.period], cast["blocks"][f"p{j}"])
        want, _, want_aux = JT.block_apply(cfg, kind, j, bp, x, rope_cos=None, rope_sin=None)
        got, aux = T.block_apply(tcfg, kind, j, tparams["blocks"][i], _to_torch(x, torch.bfloat16),
                                 rope_cos=None, rope_sin=None)
        assert got.dtype == torch.bfloat16
        _close(got, want, REL["bfloat16"])
        assert abs(float(aux) - float(want_aux)) <= 2e-5
        x = want


@pytest.mark.parametrize("periods", [1, 2])
def test_cache_matches_reference(periods):
    """``cache_init``'s keys, shapes and dtypes equal the reference's, in
    f32 and bf16; an attention-only config keeps ``{"p0": ...}``."""
    for dtype in ("float32", "bfloat16"):
        cfg, tcfg = (c.scaled(compute_dtype=dtype, n_layers=8 * periods)
                     for c in (smoke_config(ARCH), treg.smoke_config(ARCH)))
        want = JT.cache_init(cfg, 2, 24)
        got = T.cache_init(tcfg, 2, 24, "cpu")
        assert set(got) == set(want) == {f"p{j}" for j in range(8)}
        for key in want:
            assert set(got[key]) == set(want[key])
            for name, t in got[key].items():
                assert tuple(t.shape) == want[key][name].shape
                assert t.dtype == TDT[str(want[key][name].dtype)]
                assert not bool(t.any())
    dense = T.cache_init(treg.smoke_config("chatglm3-6b"), 2, 24, "cpu")
    assert set(dense) == {"p0"} and dense["p0"]["k"].shape[0] == 2


@pytest.mark.parametrize("periods", [1, 2])
def test_incremental_decode_matches_forward(periods):
    """tests/test_decode_equivalence.py's check on the port: at capacity
    factor 16 nothing drops, and decoding token by token through the cache
    gives the full forward's logits within 2e-3 of their scale."""
    _, tcfg, _, tparams = _setup_model(periods, cf=16.0)
    S, B = 24, 2
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, tcfg.vocab, (B, S)))
    full = T.forward(tparams, tcfg, tok)[0]
    cache = T.cache_init(tcfg, B, S, "cpu")
    before = (fd.flash_decode.launches, ssk.selective_scan.launches)
    errs = []
    for i in range(S):
        logits, cache, _ = T.forward(tparams, tcfg, tok[:, i : i + 1], cache=cache, cache_pos=i)
        errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert before == (fd.flash_decode.launches, ssk.selective_scan.launches)
    assert max(errs) < 2e-3 * max(float(full.abs().max()), 1.0)


def test_prefill_step_matches_reference():
    cfg, tcfg, params, tparams = _setup_model(1)
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (3, 20))
    want = jax_make_prefill_step(cfg)(params, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tdecode.make_prefill_step(tcfg)(tparams, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (3, 1, cfg.vocab)
    _close(got, want, F32_REL)


@pytest.mark.parametrize("periods", [1, 2])
def test_serving_tokens_equal_reference_at_f32(periods):
    """prefill_into_cache then greedy decode at the config's own capacity
    factor: the reference's tokens, logits and, at the end, its cache."""
    cfg, tcfg, params, tparams = _setup_model(periods)
    B, P, N = 2, 7, 6
    prompt = np.random.default_rng(10).integers(0, cfg.vocab, (B, P))
    cache_len = P + N
    jlast, jcache = jax_prefill_into_cache(params, cfg, jnp.asarray(prompt, jnp.int32), cache_len)
    tlast, tcache = tlaunch.prefill_into_cache(tparams, tcfg, torch.as_tensor(prompt), cache_len)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    jserve = jax.jit(jax_make_serve_step(cfg))
    tserve = tdecode.make_serve_step(tcfg)
    jtoks, ttoks = [jlast], [tlast]
    for i in range(N - 1):
        jn, jl, jcache = jserve(params, jcache, jtoks[-1][:, None], jnp.int32(P + i))
        tn, tl, tcache = tserve(tparams, tcache, ttoks[-1][:, None], P + i)
        _close(tl, jl, F32_REL)
        jtoks.append(jn)
        ttoks.append(tn)
    np.testing.assert_array_equal(torch.stack(ttoks, 1).numpy(), np.asarray(jnp.stack(jtoks, 1)))
    for key in jcache:
        for name in jcache[key]:
            _close(tcache[key][name], jcache[key][name], F32_REL)


def test_serve_main_runs_on_the_cpu(capsys):
    assert tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "5", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "decoded 3 steps x 2 reqs" in out and "on cpu" in out


def test_config_equals_reference():
    for ours, theirs in ((treg.get_config(ARCH), get_config(ARCH)),
                         (treg.smoke_config(ARCH), smoke_config(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    cfg = treg.get_config(ARCH)
    assert (cfg.n_layers, cfg.period, cfg.d_model, cfg.mamba_d_state) == (32, 8, 4096, 16)
