"""The port's serving path of the dense GQA family against the JAX package.

Each module of ``repro_torch.models`` / ``serve`` / ``launch.serve`` is held
against its ``repro`` counterpart on the same inputs (numpy draws with a
seed; weights made by the reference and carried over with
``convert.params_from_jax``), on the CPU, where the attention kernels take
their plain versions. Tolerances and their reasons:

  * f32 (``compute_dtype="float32"``): ``F32_REL`` 1e-5 of the largest
    magnitude. The same f32 math, with sums taken in other orders
    (measured: about 7e-7 on the logits).
  * bf16: ``BF16_REL`` 2e-2 of the largest magnitude, about two and a half
    bf16 ulps: both frameworks round after every op, but in places that
    differ, and the port's decode keeps the softmax ``p`` in f32 where the
    reference's model rounds it to bf16 (``attention.py:166``). Measured:
    about one ulp (7.5e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS, get_config, smoke_config
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serve.decode import make_prefill_step as jax_make_prefill_step
from repro.serve.decode import make_serve_step as jax_make_serve_step
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models import transformer as T
from repro_torch.serve import decode as tdecode

DENSE = ["chatglm3-6b", "granite-8b", "gemma-7b"]
# minicpm3-4b (MLA) is served too: tests/test_torch_mla.py; the MoE configs
# (grok-1-314b, kimi-k2-1t-a32b): tests/test_torch_moe.py; the hybrid
# (jamba-v0.1-52b): tests/test_torch_mamba.py
SERVED_ELSEWHERE = ["minicpm3-4b", "grok-1-314b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]
OTHER = [a for a in ARCH_IDS if a not in DENSE + SERVED_ELSEWHERE]
F32_REL = 1e-5
BF16_REL = 2e-2
REL = {"float32": F32_REL, "bfloat16": BF16_REL}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype="float32", scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} x {scale}"


def _setup(arch, compute_dtype="float32"):
    cfg = smoke_config(arch).scaled(compute_dtype=compute_dtype)
    tcfg = treg.smoke_config(arch).scaled(compute_dtype=compute_dtype)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, tcfg, params, tparams


# ---------------------------------------------------------------------------
# configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    for ours, theirs in ((treg.get_config(arch), get_config(arch)),
                         (treg.smoke_config(arch), smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.params_count() == theirs.params_count()
        assert ours.hd == theirs.hd


def test_registry_refuses_unknown_arch():
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("llama-1b")


@pytest.mark.parametrize("arch", OTHER)
def test_non_dense_configs_raise(arch):
    cfg = treg.smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdecode.make_serve_step(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdecode.make_prefill_step(cfg)


# ---------------------------------------------------------------------------
# layers and rope
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind, dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (2, 5, 64), dtype)
    sj, st = _pair(rng, (64,), "float32")
    bj, bt = _pair(rng, (64,), "float32")
    jp = {"scale": sj} if kind == "rmsnorm" else {"scale": sj, "bias": bj}
    tp = {"scale": st} if kind == "rmsnorm" else {"scale": st, "bias": bt}
    want = jlayers.norm_apply(kind, jp, xj)
    got = tlayers.norm_apply(kind, tp, xt)
    assert got.dtype == TDT[dtype]
    _close(got, want, REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_matches_reference(act, dtype):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (2, 5, 64), dtype)
    names = ["w_up", "w_down"] + (["w_gate"] if act != "gelu" else [])
    shapes = {"w_up": (64, 96), "w_gate": (64, 96), "w_down": (96, 64)}
    pairs = {n: _pair(rng, shapes[n], dtype) for n in names}
    want = jlayers.mlp_apply({n: p[0] for n, p in pairs.items()}, xj, act)
    got = tlayers.mlp_apply({n: p[1] for n, p in pairs.items()}, xt, act)
    _close(got, want, REL[dtype])


def test_embed_and_init_shapes():
    rng = np.random.default_rng(3)
    tj, tt = _pair(rng, (50, 16))
    tok = rng.integers(0, 50, (2, 7))
    np.testing.assert_array_equal(
        _np(tlayers.embed_apply({"table": tt}, torch.as_tensor(tok))),
        _np(jlayers.embed_apply({"table": tj}, jnp.asarray(tok))),
    )
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, (256, 512), torch.float32, "cpu")
    # the reference's distribution: N(0, 1/fan_in)
    # 131 072 draws: the sample std is within 1 % of 1/16 and the mean near 0
    assert abs(float(w.std()) - 256**-0.5) < 0.01 * 256**-0.5
    assert abs(float(w.mean())) < 3e-3


@pytest.mark.parametrize("style", ["full", "half", "none"])
@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_reference(style, batched):
    rng = np.random.default_rng(4)
    hd = 32
    rot = hd if style != "half" else hd // 2
    pos = rng.integers(0, 5000, (2, 9) if batched else (9,))
    cj, sj = jrope.rope_table(jnp.asarray(pos), rot, 10000.0)
    ct, s_t = trope.rope_table(torch.as_tensor(pos), rot, 10000.0)
    _close(ct, cj, 1e-5)
    _close(s_t, sj, 1e-5)
    for dtype in ("float32", "bfloat16"):
        xj, xt = _pair(rng, (2, 9, 3, hd), dtype)
        want = jrope.apply_rope(xj, cj, sj, style)
        got = trope.apply_rope(xt, ct, s_t, style)
        assert got.dtype == TDT[dtype]
        _close(got, want, REL[dtype])


# ---------------------------------------------------------------------------
# attention
def _attn_params(rng, d, H, Hkv, hd, dtype):
    shapes = {"wq": (d, H * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd), "wo": (H * hd, d)}
    pairs = {n: _pair(rng, s, dtype, scale=d**-0.5) for n, s in shapes.items()}
    return {n: p[0] for n, p in pairs.items()}, {n: p[1] for n, p in pairs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["half", "full"])
def test_attn_apply_prefill_matches_reference(style, dtype):
    rng = np.random.default_rng(5)
    B, S, d, H, Hkv, hd = 2, 37, 64, 8, 2, 16
    jp, tp = _attn_params(rng, d, H, Hkv, hd, dtype)
    xj, xt = _pair(rng, (B, S, d), dtype)
    rot = hd // 2 if style == "half" else hd
    cj, sj = jrope.rope_table(jnp.arange(S), rot)
    ct, s_t = trope.rope_table(torch.arange(S), rot)
    kw = dict(n_heads=H, n_kv=Hkv, hd=hd, rope_style=style)
    want, _ = jattn.attn_apply(jp, xj, rope_cos=cj, rope_sin=sj, **kw)
    before = fa.flash_attention.launches
    got, cache = tattn.attn_apply(tp, xt, rope_cos=ct, rope_sin=s_t, **kw)
    assert cache is None and fa.flash_attention.launches == before  # CPU: no launch
    _close(got, want, REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_apply_decode_matches_reference(dtype):
    """One decode step at position 5 of a 9-slot cache: the output and the
    written cache equal the reference's."""
    rng = np.random.default_rng(6)
    B, Sc, pos, d, H, Hkv, hd = 2, 9, 5, 64, 8, 2, 16
    jp, tp = _attn_params(rng, d, H, Hkv, hd, dtype)
    xj, xt = _pair(rng, (B, 1, d), dtype)
    kj, kt = _pair(rng, (B, Sc, Hkv, hd), dtype)
    vj, vt = _pair(rng, (B, Sc, Hkv, hd), dtype)
    cj, sj = jrope.rope_table(jnp.asarray([pos]), hd // 2)
    ct, s_t = trope.rope_table(torch.as_tensor([pos]), hd // 2)
    kw = dict(n_heads=H, n_kv=Hkv, hd=hd, rope_style="half")
    want, jcache = jattn.attn_apply(jp, xj, rope_cos=cj, rope_sin=sj, cache={"k": kj, "v": vj},
                                    cache_pos=jnp.int32(pos), **kw)
    tcache = {"k": kt.clone(), "v": vt.clone()}
    got, out_cache = tattn.attn_apply(tp, xt, rope_cos=ct, rope_sin=s_t, cache=tcache,
                                      cache_pos=pos, **kw)
    assert out_cache is tcache  # updated in place
    _close(got, want, REL[dtype])
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], REL[dtype])
        # only position `pos` changed
        keep = [i for i in range(Sc) if i != pos]
        assert torch.equal(tcache[name][:, keep], (kt if name == "k" else vt)[:, keep])


def test_attn_apply_refuses_what_the_reference_refuses():
    rng = np.random.default_rng(7)
    _, tp = _attn_params(rng, 32, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="multiple of 1024"):
        tattn.attn_apply(tp, torch.zeros(1, 1500, 32), n_heads=2, n_kv=1, hd=16)
    cache = {"k": torch.zeros(1, 4, 1, 16), "v": torch.zeros(1, 4, 1, 16)}
    with pytest.raises(ValueError, match="single-token"):
        tattn.attn_apply(tp, torch.zeros(1, 2, 32), n_heads=2, n_kv=1, hd=16,
                         cache=cache, cache_pos=0)


# ---------------------------------------------------------------------------
# the whole model
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, compute_dtype):
    cfg, tcfg, params, tparams = _setup(arch, compute_dtype)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 24))
    want = jax_forward(params, cfg, jnp.asarray(tok, jnp.int32))[0]
    got, cache, aux = T.forward(tparams, tcfg, torch.as_tensor(tok))
    assert cache is None and got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, REL[compute_dtype])
    last = T.forward(tparams, tcfg, torch.as_tensor(tok), last_logit_only=True)[0]
    assert last.shape == (2, 1, cfg.vocab)
    # the unembedding of one row sums in another order than of 24 rows
    _close(last[:, 0], got[:, -1], REL[compute_dtype])


@pytest.mark.parametrize("arch", DENSE)
def test_incremental_decode_matches_forward(arch):
    """test_decode_equivalence.py's check on the port: decoding the tokens
    one by one through the cache gives the full forward's logits."""
    _, tcfg, _, tparams = _setup(arch, "float32")
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
    scale = float(full.abs().max())
    assert max(errs) < 2e-3 * max(scale, 1.0)


def test_cache_layout_matches_reference():
    from repro.models.transformer import cache_init as jax_cache_init

    cfg, tcfg, _, _ = _setup("chatglm3-6b", "bfloat16")
    jc = jax_cache_init(cfg, 3, 11)
    tc = T.cache_init(tcfg, 3, 11, "cpu")
    assert set(tc) == set(jc) == {"p0"}
    for name in ("k", "v"):
        assert tuple(tc["p0"][name].shape) == jc["p0"][name].shape
        assert tc["p0"][name].dtype == torch.bfloat16 and not tc["p0"][name].any()


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_layout_matches_reference(arch):
    """init_params: the reference's tree, unstacked, in the compute dtype."""
    cfg, tcfg, params, tparams = _setup(arch, "bfloat16")
    mine = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(mine) == set(tparams)
    assert len(mine["blocks"]) == len(tparams["blocks"]) == cfg.n_layers

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16

    walk(mine, tparams)
    # the same distribution: the wq draws' spread is the reference's 1/sqrt(d)
    got = float(mine["blocks"][0]["attn"]["wq"].float().std())
    want = float(np.asarray(params["blocks"]["p0"]["attn"]["wq"]).std())
    assert abs(got - want) < 0.05 * want


# ---------------------------------------------------------------------------
# serving entry points
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_step_matches_reference(arch):
    cfg, tcfg, params, tparams = _setup(arch, "float32")
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (3, 20))
    want = jax_make_prefill_step(cfg)(params, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tdecode.make_prefill_step(tcfg)(tparams, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (3, 1, cfg.vocab)
    _close(got, want, F32_REL)


@pytest.mark.parametrize("arch", DENSE)
def test_serving_tokens_equal_reference_at_f32(arch):
    """prefill_into_cache then greedy decode, as launch/serve.py runs it:
    the same tokens as the reference on the same params."""
    cfg, tcfg, params, tparams = _setup(arch, "float32")
    B, P, N = 2, 7, 6
    prompt = np.random.default_rng(10).integers(0, cfg.vocab, (B, P))
    cache_len = P + N
    jlast, jcache = jax_prefill_into_cache(params, cfg, jnp.asarray(prompt, jnp.int32), cache_len)
    tlast, tcache = tlaunch.prefill_into_cache(tparams, tcfg, torch.as_tensor(prompt), cache_len)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    _close(tcache["p0"]["k"], jcache["p0"]["k"], F32_REL)
    jserve = jax.jit(jax_make_serve_step(cfg))
    tserve = tdecode.make_serve_step(tcfg)
    jtoks, ttoks = [jlast], [tlast]
    for i in range(N - 1):
        jn, jl, jcache = jserve(params, jcache, jtoks[-1][:, None], jnp.int32(P + i))
        tn, tl, tcache = tserve(tparams, tcache, ttoks[-1][:, None], P + i)
        _close(tl, jl, F32_REL)
        jtoks.append(jn)
        ttoks.append(tn)
    assert ttoks[-1].dtype == torch.int32
    np.testing.assert_array_equal(torch.stack(ttoks, 1).numpy(), np.asarray(jnp.stack(jtoks, 1)))


def test_serve_main_runs_on_the_cpu(capsys):
    assert tlaunch.main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "5", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "decoded 3 steps x 2 reqs" in out and "on cpu" in out


def test_serve_main_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "chatglm3-6b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.cache_init(treg.smoke_config("chatglm3-6b"), 1, 4)
