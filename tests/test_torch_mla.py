"""The port's Multi-head Latent Attention (minicpm3-4b) against the JAX package.

Each piece of the MLA serving path is held against its ``repro``
counterpart on the same inputs (numpy draws with a seed; model weights made
by the reference and carried over with ``convert.params_from_jax``), on the
CPU, where the attention kernels take their plain versions: ``mla_apply``
(prefill, decode, the reference's chunked prefill at S 2048), the whole
``forward``, the cache, incremental decode, greedy serving, and the two
attention kernels' plain versions with a value head dim of their own
against ``repro.kernels.ref``. Tolerances are those of test_torch_models.py
and for its reasons: ``F32_REL`` 1e-5 of the largest magnitude (the same
f32 math summed in other orders), ``BF16_REL`` 2e-2 (bf16 rounding in other
places, and the port keeps the softmax ``p`` in f32 where the reference
rounds it to bf16 before P.V, ``repro/models/mla.py:99``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig
from repro.configs.registry import smoke_config
from repro.kernels.ref import flash_attention_ref, flash_decode_ref
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache
from repro.models import mla as jmla
from repro.models import rope as jrope
from repro.models.transformer import cache_init as jax_cache_init
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serve.decode import make_prefill_step as jax_make_prefill_step
from repro.serve.decode import make_serve_step as jax_make_serve_step
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import serve as tlaunch
from repro_torch.models import mla as tmla
from repro_torch.models import rope as trope
from repro_torch.models import transformer as T
from repro_torch.serve import decode as tdecode
from test_torch_models import BF16_REL, F32_REL, REL, TDT, _close, _np, _pair

ARCH = "minicpm3-4b"
# the smoke config's MLA (dk = dv = 32) and one whose value head dim differs
# from the query/key head dim (dk 48, dv 32)
MLA_CFGS = {
    "smoke": smoke_config(ARCH).mla,
    "dv-ne-dk": MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
                          v_head_dim=32),
}


def _mla_params(rng, d, H, m, dtype):
    """The same MLA weights in both packages (norm scales drawn, not ones)."""
    qk = m.qk_nope_dim + m.qk_rope_dim
    shapes = {"w_dq": (d, m.q_lora_rank), "w_uq": (m.q_lora_rank, H * qk),
              "w_dkv": (d, m.kv_lora_rank), "w_kr": (d, m.qk_rope_dim),
              "w_uk": (m.kv_lora_rank, H * m.qk_nope_dim), "w_uv": (m.kv_lora_rank, H * m.v_head_dim),
              "wo": (H * m.v_head_dim, d)}
    jp, tp = {}, {}
    for name, shape in shapes.items():
        jp[name], tp[name] = _pair(rng, shape, dtype, scale=shape[0] ** -0.5)
    for name, width in (("q_norm", m.q_lora_rank), ("kv_norm", m.kv_lora_rank)):
        j, t = _pair(rng, (width,), dtype, scale=0.2)
        jp[name], tp[name] = {"scale": j + 1.0}, {"scale": t + 1.0}
    return jp, tp


def _rope(positions, m):
    cj, sj = jrope.rope_table(jnp.asarray(positions), m.qk_rope_dim)
    ct, st = trope.rope_table(torch.as_tensor(positions), m.qk_rope_dim)
    return cj, sj, ct, st


# ---------------------------------------------------------------------------
# mla_apply
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", sorted(MLA_CFGS))
def test_mla_prefill_matches_reference(which, dtype):
    m = MLA_CFGS[which]
    rng = np.random.default_rng(11)
    B, S, d, H = 2, 37, 64, 4
    jp, tp = _mla_params(rng, d, H, m, dtype)
    xj, xt = _pair(rng, (B, S, d), dtype)
    cj, sj, ct, st = _rope(np.arange(S), m)
    want, _ = jmla.mla_apply(jp, xj, n_heads=H, mla_cfg=m, rope_cos=cj, rope_sin=sj)
    before = fa.flash_attention.launches
    got, cache = tmla.mla_apply(tp, xt, n_heads=H, mla_cfg=m, rope_cos=ct, rope_sin=st)
    assert cache is None and fa.flash_attention.launches == before  # CPU: no launch
    assert got.shape == (B, S, d) and got.dtype == TDT[dtype]
    _close(got, want, REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", sorted(MLA_CFGS))
def test_mla_decode_matches_reference(which, dtype):
    """One decode step at position 5 of a 9-slot cache: the output and the
    written latents equal the reference's; only position 5 changed."""
    m = MLA_CFGS[which]
    rng = np.random.default_rng(12)
    B, Sc, pos, d, H = 2, 9, 5, 64, 4
    jp, tp = _mla_params(rng, d, H, m, dtype)
    xj, xt = _pair(rng, (B, 1, d), dtype)
    ckj, ckt = _pair(rng, (B, Sc, m.kv_lora_rank), dtype)
    krj, krt = _pair(rng, (B, Sc, m.qk_rope_dim), dtype)
    cj, sj, ct, st = _rope([pos], m)
    want, jcache = jmla.mla_apply(jp, xj, n_heads=H, mla_cfg=m, rope_cos=cj, rope_sin=sj,
                                  cache={"c_kv": ckj, "k_rope": krj}, cache_pos=jnp.int32(pos))
    tcache = {"c_kv": ckt.clone(), "k_rope": krt.clone()}
    got, out_cache = tmla.mla_apply(tp, xt, n_heads=H, mla_cfg=m, rope_cos=ct, rope_sin=st,
                                    cache=tcache, cache_pos=pos)
    assert out_cache is tcache and got.shape == (B, 1, d)
    _close(got, want, REL[dtype])
    keep = [i for i in range(Sc) if i != pos]
    for name, old in (("c_kv", ckt), ("k_rope", krt)):
        _close(tcache[name], jcache[name], REL[dtype])
        assert torch.equal(tcache[name][:, keep], old[:, keep])


def test_mla_chunked_prefill_matches_reference():
    """S 2048 runs the reference's 1 024-query chunks (a scan); the port's
    one causal launch computes the same function."""
    m = MLA_CFGS["dv-ne-dk"]
    rng = np.random.default_rng(13)
    B, S, d, H = 1, 2048, 32, 2
    jp, tp = _mla_params(rng, d, H, m, "float32")
    xj, xt = _pair(rng, (B, S, d))
    cj, sj, ct, st = _rope(np.arange(S), m)
    want, _ = jmla.mla_apply(jp, xj, n_heads=H, mla_cfg=m, rope_cos=cj, rope_sin=sj)
    got, _ = tmla.mla_apply(tp, xt, n_heads=H, mla_cfg=m, rope_cos=ct, rope_sin=st)
    _close(got, want, F32_REL)


def test_mla_refuses_what_the_reference_refuses():
    m = MLA_CFGS["smoke"]
    _, tp = _mla_params(np.random.default_rng(14), 32, 2, m, "float32")
    ct, st = trope.rope_table(torch.arange(1500), m.qk_rope_dim)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tmla.mla_apply(tp, torch.zeros(1, 1500, 32), n_heads=2, mla_cfg=m, rope_cos=ct,
                       rope_sin=st)
    cache = tmla.mla_cache_init(1, 1, 4, m, torch.float32, "cpu")
    cache = {k: v[0] for k, v in cache.items()}
    with pytest.raises(ValueError, match="single-token"):
        tmla.mla_apply(tp, torch.zeros(1, 2, 32), n_heads=2, mla_cfg=m, rope_cos=ct[:2],
                       rope_sin=st[:2], cache=cache, cache_pos=0)


# ---------------------------------------------------------------------------
# the attention kernels' plain versions with dv != dk, and their routes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dk,dv", [(96, 64), (48, 32), (32, 16)])
def test_flash_attention_plain_dv_matches_reference(dk, dv, causal, dtype):
    rng = np.random.default_rng(dk + dv)
    qj, qt = _pair(rng, (8, 40, dk), dtype)
    kj, kt = _pair(rng, (4, 52, dk), dtype)
    vj, vt = _pair(rng, (4, 52, dv), dtype)
    want = flash_attention_ref(qj, kj, vj, causal=causal)
    got = fa.flash_attention(qt, kt, vt, causal=causal)  # CPU: the plain version
    assert got.shape == (8, 40, dv) and got.dtype == TDT[dtype]
    _close(got, want, REL[dtype])
    got4 = fa.flash_attention(qt[None], kt[None], vt[None], causal=causal, scale=0.3)
    _close(got4[0], flash_attention_ref(qj, kj, vj, causal=causal, scale=0.3), REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dk,dv,group", [(96, 64, 1), (48, 32, 4), (32, 16, 2)])
def test_flash_decode_plain_dv_matches_reference(dk, dv, group, dtype):
    rng = np.random.default_rng(dk * group)
    B, Hkv, S, length = 3, 2, 70, 41
    qj, qt = _pair(rng, (B, Hkv * group, dk), dtype)
    kj, kt = _pair(rng, (B, S, Hkv, dk), dtype)
    vj, vt = _pair(rng, (B, S, Hkv, dv), dtype)
    want = flash_decode_ref(qj, kj, vj, length)
    got = fd.flash_decode(qt, kt, vt, length)
    assert got.shape == (B, Hkv * group, dv) and got.dtype == TDT[dtype]
    _close(got, want, REL[dtype])
    # the split kernel's arithmetic with the narrower values
    _close(fd.flash_decode_split_plain(qt, kt, vt, length), want, REL[dtype])


def _bf(shape, offset=0, width=None):
    width = width or shape[-1]
    return torch.zeros((*shape[:-1], width + offset), dtype=torch.bfloat16)[..., offset:offset + shape[-1]]


@pytest.mark.parametrize(
    "dk,dv,dtype,route",
    [(96, 64, torch.bfloat16, "tc"), (48, 32, torch.bfloat16, "tc"), (128, 64, torch.bfloat16, "tc"),
     (64, 16, torch.bfloat16, "tc"), (32, 32, torch.bfloat16, "simt"),
     (96, 40, torch.bfloat16, "simt"), (256, 64, torch.bfloat16, "simt"),
     (96, 64, torch.float32, "simt")],
)
def test_attention_route_rule_with_dv(dk, dv, dtype, route):
    """The model's (B, S, H, d) projections as (B, H, S, d) views."""
    q = torch.zeros((2, 33, 8, dk), dtype=dtype).transpose(1, 2)
    k = torch.zeros((2, 33, 8, dk), dtype=dtype).transpose(1, 2)
    v = torch.zeros((2, 33, 8, dv), dtype=dtype).transpose(1, 2)
    assert fa.attention_route(q, k, v) == route


@pytest.mark.parametrize(
    "dk,dv,dtype,route",
    [(96, 64, torch.bfloat16, "split"), (48, 32, torch.bfloat16, "split"),
     (256, 16, torch.bfloat16, "split"), (96, 40, torch.bfloat16, "simt"),
     (96, 64, torch.float32, "simt")],
)
def test_decode_route_rule_with_dv(dk, dv, dtype, route):
    q = torch.zeros((2, 40, dk), dtype=dtype)
    k = torch.zeros((2, 50, 40, dk), dtype=dtype)
    v = torch.zeros((2, 50, 40, dv), dtype=dtype)
    assert fd.decode_route(q, k, v) == route


def test_split_smem_with_dv_fits():
    assert fd.split_smem_bytes(96, 64) == 2 * (104 * (16 + 192) + 72 * 192)
    assert fd.split_smem_bytes(96, 64) < fd.split_smem_bytes(96)
    assert fd.smem_bytes(1, 96, 64) == 4 * (160 + 32 * 97 + 32 * 64 + 32 + 3)


def test_kernels_refuse_wider_values():
    q, k = torch.zeros(4, 16, 32), torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="no wider"):
        fa.flash_attention(q, k, torch.zeros(2, 16, 48))
    with pytest.raises(ValueError, match="differ in shape"):
        fa.flash_attention(q, k, torch.zeros(2, 17, 16))
    with pytest.raises(ValueError, match="no wider"):
        fd.flash_decode(torch.zeros(2, 4, 32), torch.zeros(2, 8, 2, 32), torch.zeros(2, 8, 2, 48), 3)
    with pytest.raises(ValueError, match="need q"):
        fd.flash_decode(torch.zeros(2, 4, 32), torch.zeros(2, 8, 2, 32), torch.zeros(2, 9, 2, 16), 3)


# ---------------------------------------------------------------------------
# the whole model
def _setup(compute_dtype="float32", **over):
    cfg = smoke_config(ARCH).scaled(compute_dtype=compute_dtype, **over)
    tcfg = treg.smoke_config(ARCH).scaled(compute_dtype=compute_dtype, **over)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, tcfg, params, tparams


def test_config_is_served_now():
    cfg = treg.get_config(ARCH)
    assert cfg.mla is not None
    T.check_supported(cfg)
    T.check_supported(treg.smoke_config(ARCH))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(compute_dtype):
    cfg, tcfg, params, tparams = _setup(compute_dtype)
    tok = np.random.default_rng(15).integers(0, cfg.vocab, (2, 24))
    want = jax_forward(params, cfg, jnp.asarray(tok, jnp.int32))[0]
    got, cache, aux = T.forward(tparams, tcfg, torch.as_tensor(tok))
    assert cache is None and got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, REL[compute_dtype])


def test_forward_with_dv_ne_dk_matches_reference():
    """The whole model at a width whose value head dim is not the query/key
    head dim (dk 48, dv 32)."""
    cfg, tcfg, params, tparams = _setup("float32", mla=MLA_CFGS["dv-ne-dk"])
    tok = np.random.default_rng(16).integers(0, cfg.vocab, (2, 19))
    want = jax_forward(params, cfg, jnp.asarray(tok, jnp.int32))[0]
    _close(T.forward(tparams, tcfg, torch.as_tensor(tok))[0], want, F32_REL)


def test_params_and_cache_layout_match_reference():
    cfg, tcfg, params, tparams = _setup("bfloat16")
    blocks = tparams["blocks"]
    assert len(blocks) == cfg.n_layers
    assert set(blocks[0]) == {"norm1", "mla", "norm2", "mlp"}
    assert set(blocks[0]["mla"]) == set(params["blocks"]["p0"]["mla"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk", "w_uv", "wo"}
    for name, leaf in blocks[1]["mla"].items():
        ref = params["blocks"]["p0"]["mla"][name]
        if isinstance(leaf, dict):
            leaf, ref = leaf["scale"], ref["scale"]
        assert tuple(leaf.shape) == ref.shape[1:] and leaf.dtype == torch.bfloat16
        want = torch.from_numpy(np.array(ref[1], np.float32)).to(torch.bfloat16)
        assert torch.equal(leaf, want)  # layer 1, cast once to the compute dtype
    mine = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(mine["blocks"][0]["mla"]) == set(blocks[0]["mla"])
    for name in blocks[0]["mla"]:
        a, b = mine["blocks"][0]["mla"][name], blocks[0]["mla"][name]
        a, b = (a["scale"], b["scale"]) if isinstance(a, dict) else (a, b)
        assert a.shape == b.shape and a.dtype == b.dtype
    # the parameter count chip_smoke.py checks: the config's analytic count
    # plus every norm scale (2 L + 1 of d, and MLA's two latent norms a layer)
    n = sum(t.numel() for t in _leaves(mine))
    m = tcfg.mla
    assert n == int(tcfg.params_count()) + (2 * tcfg.n_layers + 1) * tcfg.d_model + \
        tcfg.n_layers * (m.q_lora_rank + m.kv_lora_rank)
    jc = jax_cache_init(cfg, 3, 11)
    tc = T.cache_init(tcfg, 3, 11, "cpu")
    assert set(tc) == set(jc) == {"p0"} and set(tc["p0"]) == set(jc["p0"]) == {"c_kv", "k_rope"}
    for name in ("c_kv", "k_rope"):
        assert tuple(tc["p0"][name].shape) == jc["p0"][name].shape
        assert tc["p0"][name].dtype == torch.bfloat16 and not tc["p0"][name].any()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("which", sorted(MLA_CFGS))
def test_incremental_decode_matches_forward(which):
    """Decoding the tokens one by one through the latent cache gives the
    full forward's logits."""
    _, tcfg, _, tparams = _setup("float32", mla=MLA_CFGS[which])
    S, B = 20, 2
    tok = torch.as_tensor(np.random.default_rng(17).integers(0, tcfg.vocab, (B, S)))
    full = T.forward(tparams, tcfg, tok)[0]
    cache = T.cache_init(tcfg, B, S, "cpu")
    before = fd.flash_decode.launches
    errs = []
    for i in range(S):
        logits, cache, _ = T.forward(tparams, tcfg, tok[:, i:i + 1], cache=cache, cache_pos=i)
        errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert fd.flash_decode.launches == before
    assert max(errs) < 2e-3 * max(float(full.abs().max()), 1.0)


def test_prefill_step_matches_reference():
    cfg, tcfg, params, tparams = _setup("float32")
    tok = np.random.default_rng(18).integers(0, cfg.vocab, (3, 20))
    want = jax_make_prefill_step(cfg)(params, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tdecode.make_prefill_step(tcfg)(tparams, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (3, 1, cfg.vocab)
    _close(got, want, F32_REL)


def test_serving_tokens_equal_reference_at_f32():
    """prefill_into_cache then greedy decode, as launch/serve.py runs it:
    the same tokens, logits and latent cache as the reference."""
    cfg, tcfg, params, tparams = _setup("float32")
    B, P, N = 2, 7, 6
    prompt = np.random.default_rng(19).integers(0, cfg.vocab, (B, P))
    cache_len = P + N
    jlast, jcache = jax_prefill_into_cache(params, cfg, jnp.asarray(prompt, jnp.int32), cache_len)
    tlast, tcache = tlaunch.prefill_into_cache(tparams, tcfg, torch.as_tensor(prompt), cache_len)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    for name in ("c_kv", "k_rope"):
        _close(tcache["p0"][name], jcache["p0"][name], F32_REL)
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


def test_bf16_serving_logits_close_to_reference():
    """bf16 through the cache: each step's logits within ``BF16_REL``."""
    cfg, tcfg, params, tparams = _setup("bfloat16")
    B, P = 2, 6
    prompt = np.random.default_rng(20).integers(0, cfg.vocab, (B, P))
    jlast, jcache = jax_prefill_into_cache(params, cfg, jnp.asarray(prompt, jnp.int32), P + 2)
    tlast, tcache = tlaunch.prefill_into_cache(tparams, tcfg, torch.as_tensor(prompt), P + 2)
    _, jl, _ = jax_make_serve_step(cfg)(params, jcache, jlast[:, None], jnp.int32(P))
    _, tl, _ = tdecode.make_serve_step(tcfg)(tparams, tcache, tlast[:, None], P)
    _close(tl, jl, BF16_REL)


def test_serve_main_runs_on_the_cpu(capsys):
    assert tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "5", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "decoded 3 steps x 2 reqs" in out and "on cpu" in out


def test_config_equals_reference():
    ours, theirs = treg.get_config(ARCH), smoke_config(ARCH)
    assert dataclasses.asdict(treg.smoke_config(ARCH)) == dataclasses.asdict(theirs)
    m = ours.mla
    assert (m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim, ours.n_layers) == (96, 64, 62)
