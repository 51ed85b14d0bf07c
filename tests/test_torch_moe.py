"""The port's Mixture-of-Experts serving path (grok-1-314b, kimi-k2-1t-a32b)
against the JAX package.

``moe_apply`` is held against ``repro.models.moe.moe_apply`` on the same
inputs (numpy draws with a seed; weights from the reference's own
``moe_init`` carried over as numpy arrays) over E/K 8/2, 16/4 and 384/8,
capacity factors 0.1 (most assignments dropped), 1.25 and 8, one and four
token chunks (and a token count four does not divide), with and without
``expert_perm``, and a zero router, where every probability ties (the
tie order decides which assignments overflow). The reference's own MoE
tests (``tests/test_moe.py``) run on the port. The smoke MoE configs run
through ``forward``, the cache, greedy serving and the CLI against the
reference (weights made by the reference, ``convert.params_from_jax``).

Tolerances: f32 ``y`` within ``F32_REL`` 1e-5 of ``max|y|`` (the same f32
math summed in other orders) and the aux loss within 1e-6; bf16 within
``BF16_REL`` 2e-2 of ``max|y|``, the tolerance of test_torch_models.py and
for its reasons (a whole bf16 model's aux loss within 2e-5). A wrong drop
or a wrong tie removes a whole expert's contribution from a token, far
outside both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig
from repro.configs.registry import smoke_config
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache
from repro.models import moe as jmoe
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serve.decode import make_prefill_step as jax_make_prefill_step
from repro.serve.decode import make_serve_step as jax_make_serve_step
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.convert import params_from_jax
from repro_torch.dist.sched_bridge import plan_expert_placement
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import serve as tlaunch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as T
from repro_torch.serve import decode as tdecode
from test_torch_models import F32_REL, REL, TDT, _close, _np

MOE_ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
AUX_TOL = 1e-6


def _moe_case(E, K, cf, dtype="float32", d=32, ff=24, shape=(4, 16), seed=0, zero_router=False):
    """The reference's MoE weights and a seeded input in both packages; the
    weights are cast to the compute dtype, as the reference's ``_cast_floats``
    casts them at every call (the router too)."""
    cfg = MoEConfig(n_experts=E, top_k=K, d_ff=ff, capacity_factor=cf)
    tcfg = TMoEConfig(n_experts=E, top_k=K, d_ff=ff, capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), d, cfg, jnp.float32)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    jp = {k: v.astype(JDT[dtype]) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(TDT[dtype]) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(shape + (d,)).astype(np.float32)
    xj = jnp.asarray(x, JDT[dtype])
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TDT[dtype])
    return cfg, tcfg, jp, tp, xj, xt


def _check(got, want, dtype):
    (y, aux), (yj, auxj) = got, want
    assert y.dtype == TDT[dtype] and aux.dtype == torch.float32 and aux.shape == ()
    _close(y, yj, REL[dtype])
    assert abs(float(aux) - float(auxj)) <= AUX_TOL


# ---------------------------------------------------------------------------
# moe_apply against the reference
@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 4])
@pytest.mark.parametrize("cf", [0.1, 1.25, 8.0])
@pytest.mark.parametrize("E,K", [(8, 2), (16, 4), (384, 8)])
def test_moe_apply_matches_reference_f32(E, K, cf, n_chunks, perm):
    cfg, tcfg, jp, tp, xj, xt = _moe_case(E, K, cf, seed=E + K)
    p = np.random.default_rng(E).permutation(E) if perm else None
    want = jmoe.moe_apply(jp, xj, moe_cfg=cfg, n_chunks=n_chunks,
                          expert_perm=None if p is None else jnp.asarray(p))
    got = tmoe.moe_apply(tp, xt, moe_cfg=tcfg, n_chunks=n_chunks,
                         expert_perm=None if p is None else torch.as_tensor(p))
    _check(got, want, "float32")


@pytest.mark.parametrize("cf", [0.1, 1.25, 8.0])
@pytest.mark.parametrize("E,K", [(8, 2), (16, 4), (384, 8)])
def test_moe_apply_matches_reference_bf16(E, K, cf):
    cfg, tcfg, jp, tp, xj, xt = _moe_case(E, K, cf, "bfloat16", seed=E + K)
    want = jmoe.moe_apply(jp, xj, moe_cfg=cfg)
    got = tmoe.moe_apply(tp, xt, moe_cfg=tcfg)
    _check(got, want, "bfloat16")


@pytest.mark.parametrize("n_chunks", [4, 3])
def test_moe_apply_chunks_fall_back_when_they_do_not_divide(n_chunks):
    """T = 3 x 7 = 21 tokens: 4 chunks fall back to one (the reference's
    rule), 3 chunks of 7 tokens run as chunks; both at a capacity that
    drops."""
    cfg, tcfg, jp, tp, xj, xt = _moe_case(8, 2, 1.25, shape=(3, 7), seed=5)
    want = jmoe.moe_apply(jp, xj, moe_cfg=cfg, n_chunks=n_chunks)
    got = tmoe.moe_apply(tp, xt, moe_cfg=tcfg, n_chunks=n_chunks)
    _check(got, want, "float32")
    one = tmoe.moe_apply(tp, xt, moe_cfg=tcfg, n_chunks=1)
    if n_chunks == 4:
        assert torch.equal(got[0], one[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,E,K", [(1.25, 8, 2), (8.0, 8, 2), (1.25, 16, 4), (0.1, 384, 8)])
def test_moe_apply_zero_router_ties_like_lax_top_k(cf, E, K, dtype):
    """A zero router: every probability is 1/E, lax.top_k takes experts
    0..K-1 (the lower index first), every token lands on them and most
    overflow. The port's stable sort takes the same experts in the same
    order, so the same assignments drop."""
    cfg, tcfg, jp, tp, xj, xt = _moe_case(E, K, cf, dtype, seed=7, zero_router=True)
    want = jmoe.moe_apply(jp, xj, moe_cfg=cfg)
    got = tmoe.moe_apply(tp, xt, moe_cfg=tcfg)
    _check(got, want, dtype)
    assert float(got[0].abs().max()) > 0.0


def test_moe_apply_expert_perm_from_the_placement_planner():
    """The relabelling that chip_smoke.py checks: a plan from
    plan_expert_placement over a seeded routing mass, in the reference and
    the port, with and without the permuted weights."""
    cfg, tcfg, jp, tp, xj, xt = _moe_case(16, 4, 1.25, seed=11)
    pl = plan_expert_placement(np.random.default_rng(3).pareto(1.5, 16) * 100, 4)
    # expert e takes slot inv_perm[e]; slot s holds expert perm[s]'s weights
    jpp = dict(jp, **{k: jp[k][jnp.asarray(pl.perm)] for k in ("w_up", "w_gate", "w_down")})
    tpp = dict(tp, **{k: tp[k][torch.as_tensor(pl.perm)] for k in ("w_up", "w_gate", "w_down")})
    want = jmoe.moe_apply(jpp, xj, moe_cfg=cfg, expert_perm=jnp.asarray(pl.inv_perm))
    got = tmoe.moe_apply(tpp, xt, moe_cfg=tcfg, expert_perm=torch.as_tensor(pl.inv_perm))
    _check(got, want, "float32")
    base = tmoe.moe_apply(tp, xt, moe_cfg=tcfg)
    assert torch.equal(got[0], base[0])  # drops included: ranks within an expert stay


# ---------------------------------------------------------------------------
# tests/test_moe.py's checks on the port (the port's own moe_init)
def _setup(E=8, K=2, d=32, ff=64, cf=4.0):
    cfg = TMoEConfig(n_experts=E, top_k=K, d_ff=ff, capacity_factor=cf)
    params = tmoe.moe_init(torch.Generator().manual_seed(0), d, cfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 16, d)).astype(np.float32))
    return cfg, params, x


def test_moe_output_finite_and_shaped():
    cfg, params, x = _setup()
    y, aux = tmoe.moe_apply(params, x, moe_cfg=cfg)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux) > 0.0


def test_chunked_dispatch_matches_global():
    cfg, params, x = _setup(cf=8.0)
    y1, _ = tmoe.moe_apply(params, x, moe_cfg=cfg, n_chunks=1)
    y4, _ = tmoe.moe_apply(params, x, moe_cfg=cfg, n_chunks=4)
    np.testing.assert_allclose(_np(y1), _np(y4), atol=1e-5)


def test_expert_perm_is_pure_relabeling():
    cfg, params, x = _setup(cf=8.0)
    perm = torch.as_tensor(np.random.default_rng(1).permutation(cfg.n_experts))
    inv = torch.argsort(perm)
    params_p = dict(params)
    for k in ("w_up", "w_gate", "w_down"):
        params_p[k] = params[k][inv]
    y_base, _ = tmoe.moe_apply(params, x, moe_cfg=cfg)
    y_perm, _ = tmoe.moe_apply(params_p, x, moe_cfg=cfg, expert_perm=perm)
    assert torch.equal(y_base, y_perm)


def test_capacity_drops_tokens_gracefully():
    cfg, params, x = _setup(cf=0.1)
    y, aux = tmoe.moe_apply(params, x, moe_cfg=cfg)
    assert bool(torch.isfinite(y).all())
    y_full, _ = tmoe.moe_apply(params, x, moe_cfg=dataclasses.replace(cfg, capacity_factor=8.0))
    assert float(torch.linalg.norm(y)) < float(torch.linalg.norm(y_full))


def test_moe_init_draws_the_reference_distribution():
    """N(0, 1/fan_in) with fan_in = shape[0]: E for the expert tensors, d for
    the router; stored in the compute dtype."""
    E, d, ff = 16, 64, 96
    cfg = TMoEConfig(n_experts=E, top_k=2, d_ff=ff)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), d, cfg, torch.bfloat16, "cpu")
    jp = jmoe.moe_init(jax.random.PRNGKey(0), d, MoEConfig(n_experts=E, top_k=2, d_ff=ff),
                       jnp.float32)
    for k, shape in (("router", (d, E)), ("w_up", (E, d, ff)), ("w_gate", (E, d, ff)),
                     ("w_down", (E, ff, d))):
        assert tuple(p[k].shape) == shape == jp[k].shape and p[k].dtype == torch.bfloat16
        got, want = float(p[k].float().std()), float(np.asarray(jp[k]).std())
        assert abs(got - want) < 0.05 * want
        assert abs(got - shape[0] ** -0.5) < 0.05 * shape[0] ** -0.5
    # the experts are drawn one by one: no two alike
    assert not torch.equal(p["w_up"][0], p["w_up"][1])


# ---------------------------------------------------------------------------
# the whole model
def _setup_model(arch, compute_dtype="float32", cf=None):
    cfg = smoke_config(arch).scaled(compute_dtype=compute_dtype)
    tcfg = treg.smoke_config(arch).scaled(compute_dtype=compute_dtype)
    if cf is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        tcfg = tcfg.scaled(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, tcfg, params, tparams


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_are_served(arch):
    cfg = treg.smoke_config(arch)
    assert cfg.family == "moe" and cfg.moe is not None
    T.check_supported(cfg)
    T.check_supported(treg.get_config(arch))
    assert T._is_moe_position(cfg, 0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(arch, compute_dtype):
    cfg, tcfg, params, tparams = _setup_model(arch, compute_dtype)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 24))
    want, _, want_aux = jax_forward(params, cfg, jnp.asarray(tok, jnp.int32))
    before = fa.flash_attention.launches
    got, cache, aux = T.forward(tparams, tcfg, torch.as_tensor(tok))
    assert cache is None and got.dtype == torch.float32 and fa.flash_attention.launches == before
    _close(got, want, REL[compute_dtype])
    assert aux.dtype == torch.float32 and float(aux) > 0.0
    # bf16: the router's inputs follow the bf16 residual stream, an ulp apart
    # in places (measured: up to 1.5e-6 at seeds 8..11)
    assert abs(float(aux) - float(want_aux)) <= (AUX_TOL if compute_dtype == "float32" else 2e-5)


@pytest.mark.parametrize("moe_chunks", [1, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_expert_perm_and_chunks_match_reference(arch, moe_chunks):
    cfg, tcfg, params, tparams = _setup_model(arch, "float32")
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (2, 16))
    perm = np.random.default_rng(4).permutation(cfg.moe.n_experts)
    want, _, want_aux = jax_forward(params, cfg, jnp.asarray(tok, jnp.int32),
                                    expert_perm=jnp.asarray(perm), moe_chunks=moe_chunks)
    got, _, aux = T.forward(tparams, tcfg, torch.as_tensor(tok), expert_perm=perm,
                            moe_chunks=moe_chunks)
    _close(got, want, F32_REL)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_incremental_decode_matches_forward(arch):
    """At capacity factor 16 nothing drops, in the prefill or at decode:
    decoding token by token through the cache gives the full forward's
    logits (tests/test_decode_equivalence.py raises cf for the same
    reason)."""
    _, tcfg, _, tparams = _setup_model(arch, "float32", cf=16.0)
    S, B = 24, 2
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, tcfg.vocab, (B, S)))
    full = T.forward(tparams, tcfg, tok)[0]
    cache = T.cache_init(tcfg, B, S, "cpu")
    before = fd.flash_decode.launches
    errs = []
    for i in range(S):
        logits, cache, _ = T.forward(tparams, tcfg, tok[:, i : i + 1], cache=cache, cache_pos=i)
        errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert fd.flash_decode.launches == before
    assert max(errs) < 2e-3 * max(float(full.abs().max()), 1.0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_layout_matches_reference(arch):
    """params_from_jax unstacks the "moe" subtree per layer in the compute
    dtype (the f32 router too); init_params makes the same tree."""
    cfg, tcfg, params, tparams = _setup_model(arch, "bfloat16")
    assert len(tparams["blocks"]) == cfg.n_layers
    for i, bp in enumerate(tparams["blocks"]):
        assert "mlp" not in bp and set(bp["moe"]) == {"router", "w_up", "w_gate", "w_down"}
        for k, t in bp["moe"].items():
            ref = np.asarray(params["blocks"]["p0"]["moe"][k][i])
            assert tuple(t.shape) == ref.shape and t.dtype == torch.bfloat16
            assert torch.equal(t, torch.from_numpy(ref.astype(np.float32)).to(torch.bfloat16))
    mine = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16

    walk(mine, tparams)


@pytest.mark.parametrize("moe_chunks", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_step_matches_reference(arch, moe_chunks):
    cfg, tcfg, params, tparams = _setup_model(arch, "float32")
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (3, 20))
    want = jax_make_prefill_step(cfg, moe_chunks)(params, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tdecode.make_prefill_step(tcfg, moe_chunks)(tparams, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (3, 1, cfg.vocab)
    _close(got, want, F32_REL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serving_tokens_equal_reference_at_f32(arch):
    """prefill_into_cache then greedy decode, at the config's own capacity
    factor: the same tokens as the reference on the same params."""
    cfg, tcfg, params, tparams = _setup_model(arch, "float32")
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    assert tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "5", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "decoded 3 steps x 2 reqs" in out and "on cpu" in out
