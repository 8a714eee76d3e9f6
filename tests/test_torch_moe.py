"""PyTorch port: the moe family (granite-moe-1b-a400m, deepseek-v2-236b)
against the JAX reference, on the CPU at their reduced configurations
(2 layers, d_model 64; deepseek's first layer dense, its second MoE with
a shared expert, both with MLA), with the reference's own weights
carried across by ``params_from_jax``.

What each one brings: granite the MoE layer (top-2 of 4 experts here,
top-8 of 32 at full width) behind GQA attention and tied embeddings;
deepseek MLA (a low-rank query, a shared latent and rope key in the
cache, decode in the absorbed form, a v head dim of its own through the
flash-attention wrapper), a leading dense layer (``head_blocks``) and
shared experts.

JAX runs in-process through ``repro.configs`` and ``repro.models`` only:
neither needs 64-bit mode or sets anything at import. Inputs come from
``numpy.random.default_rng`` with fixed seeds.

Tolerances are those of ``tests/test_torch_models.py``: 1e-4 on float32
logits with greedy tokens equal, 2e-2 in bfloat16 (the reference suite's
own bound; bfloat16 decode is teacher-forced on the reference's
tokens). The aux loss is a float32 mean over the same routing: 1e-5 in
float32, 2e-3 in bfloat16 (where bfloat16 activations move the router's
float32 probabilities). Routing itself must be the reference's
exactly: expert ids, including the order among tied probabilities
(``jax.lax.top_k``: the lower id first).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import NOT_PORTED, get_config, get_reduced
from repro_torch.models import attention as attn_mod
from repro_torch.models import decode as dec
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import params_from_jax

ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-236b")
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
AUX_ATOL = {"float32": 1e-5, "bfloat16": 2e-3}
B, S, GEN = 2, 24, 8
# the reference's n_params() and n_active_params() at full size
# (repro.configs, on the CPU)
N_PARAMS = {"granite-moe-1b-a400m": 1_334_756_352,
            "deepseek-v2-236b": 235_741_434_880}
N_ACTIVE = {"granite-moe-1b-a400m": 428_196_864,
            "deepseek-v2-236b": 21_329_280_000}
# reference fields the serving path does not read: training knobs
TRAINING_ONLY = {"adam_dtype", "remat_policy", "scan_group", "train_accum"}


def _cfgs(arch, compute_dtype, **changes):
    from repro.configs import get_reduced as jax_reduced
    return (dataclasses.replace(get_reduced(arch),
                                compute_dtype=compute_dtype, **changes),
            dataclasses.replace(jax_reduced(arch),
                                compute_dtype=compute_dtype, **changes))


def _jax_params(jcfg, seed=0):
    import jax
    from repro.models import lm as jlm
    return jlm.init_params(jcfg, jax.random.PRNGKey(seed))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.float()
    return np.asarray(x, np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _cache_leaves(cache):
    """{(stack, leaf): array} of a moe cache (``head``/``units``)."""
    return {(stack, name): _np(val) for stack in ("head", "units")
            if stack in cache for name, val in cache[stack].items()}


def _jax_run(jp, jcfg, toks, gen):
    """Reference: forward logits and aux, prefill (logits and cache),
    then greedy decode (one jitted step: traced once, not per step)."""
    import jax
    import jax.numpy as jnp
    from repro.models import decode as jdec
    from repro.models import lm as jlm
    step_fn = jax.jit(jdec.decode_step, static_argnums=3)
    logits, aux = jlm.forward(jp, jnp.asarray(toks), jcfg)
    out = {"forward": _np(logits), "aux": float(aux)}
    logits, cache = jdec.prefill(jp, jnp.asarray(toks), jcfg,
                                 max_seq=toks.shape[1] + gen)
    out["prefill"] = _np(logits)
    out["cache"] = _cache_leaves(cache)
    tokens, steps = [], []
    tok = jnp.argmax(logits, -1)[:, None]
    for _ in range(gen):
        tokens.append(np.asarray(tok))
        logits, cache = step_fn(jp, cache, tok, jcfg)
        steps.append(_np(logits))
        tok = jnp.argmax(logits, -1)[:, None]
    out["tokens"] = np.concatenate(tokens, axis=1)
    out["decode"] = steps
    return out


@pytest.fixture(scope="module", params=[
    (a, d) for a in ARCHS for d in ("float32", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def parity(request):
    """Both packages on the same weights and prompts: one architecture,
    one compute dtype."""
    import jax
    arch, dtype = request.param
    cfg, jcfg = _cfgs(arch, dtype)
    jp = _jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(0, B, S, cfg.vocab_size)
    return {"arch": arch, "dtype": dtype, "cfg": cfg, "params": params,
            "toks": toks, "ref": _jax_run(jp, jcfg, toks, GEN)}


def test_forward_and_aux_match_reference(parity):
    logits, aux = lm.forward(parity["params"],
                             torch.from_numpy(parity["toks"]), parity["cfg"])
    assert logits.shape == (B, S, parity["cfg"].padded_vocab)
    np.testing.assert_allclose(_np(logits.float()), parity["ref"]["forward"],
                               atol=ATOL[parity["dtype"]])
    # one MoE layer (of 2) at coefficient 0.01: the loss is E * sum(me*ce),
    # at least 1 times the coefficient; not the zeros of a dense model
    assert aux.dtype == torch.float32 and float(aux) > 0.005
    assert abs(float(aux) - parity["ref"]["aux"]) <= AUX_ATOL[parity["dtype"]]


def test_prefill_logits_and_cache_match_reference(parity):
    cfg = parity["cfg"]
    logits, cache = dec.prefill(parity["params"],
                                torch.from_numpy(parity["toks"]), cfg,
                                max_seq=S + GEN)
    tol = ATOL[parity["dtype"]]
    assert cache["pos"] == S
    np.testing.assert_allclose(_np(logits.float()), parity["ref"]["prefill"],
                               atol=tol)
    mine = _cache_leaves(cache)
    want = parity["ref"]["cache"]
    if cfg.mla is not None:
        m = cfg.mla
        assert sorted(mine) == [("head", "ckv"), ("head", "kr"),
                                ("units", "ckv"), ("units", "kr")]
        assert mine[("head", "ckv")].shape == (1, B, S + GEN, m.kv_lora_rank)
        assert mine[("units", "kr")].shape == (1, B, S + GEN,
                                               m.qk_rope_head_dim)
    else:
        assert sorted(mine) == [("units", "k"), ("units", "v")]
        assert mine[("units", "k")].shape == (cfg.n_layers, B, S + GEN,
                                              cfg.n_kv_heads, cfg.head_dim_)
    assert sorted(mine) == sorted(want)
    for key, got in mine.items():
        assert got.shape == want[key].shape, key
        np.testing.assert_allclose(got, want[key], atol=tol, err_msg=str(key))
    for stack in ("head", "units"):
        for leaf in cache.get(stack, {}).values():
            assert leaf.dtype == getattr(torch, parity["dtype"])
            assert not leaf[:, :, S:].any()


def test_greedy_decode_matches_reference(parity):
    """GEN decode steps, teacher-forced on the reference's greedy tokens:
    logits within tolerance at every step; in float32 the port's own
    argmax gives the same tokens."""
    cfg, ref = parity["cfg"], parity["ref"]
    logits, cache = dec.prefill(parity["params"],
                                torch.from_numpy(parity["toks"]), cfg,
                                max_seq=S + GEN)
    mine = [logits.argmax(-1)]
    for step in range(GEN):
        tok = torch.from_numpy(ref["tokens"][:, step:step + 1]).long()
        logits, cache = dec.decode_step(parity["params"], cache, tok, cfg)
        assert cache["pos"] == S + step + 1
        np.testing.assert_allclose(_np(logits.float()), ref["decode"][step],
                                   atol=ATOL[parity["dtype"]])
        mine.append(logits.argmax(-1))
    if parity["dtype"] == "float32":
        np.testing.assert_array_equal(
            torch.stack(mine[:GEN], dim=1).numpy(), ref["tokens"])


# -- the MoE layer alone

def _moe_layer(arch, dtype, seed, **moe_changes):
    """(cfg, jcfg, the port's and the reference's MoE weights) of the
    reduced ``arch``'s last layer, optionally with other MoEConfig
    fields."""
    import jax
    cfg, jcfg = _cfgs(arch, dtype)
    if moe_changes:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed))
    jp = jax.tree.map(lambda a: a[-1], tree["units"]["blk"]["mlp"])
    params = params_from_jax(tree, cfg, "cpu")
    p = lm.unit(params["units"], cfg.n_layers - 1 -
                cfg.moe.first_dense_layers)["blk"]["mlp"]
    return cfg, jcfg, p, jp


def _x(seed, b, s, d, dtype):
    x = np.random.default_rng(seed).standard_normal((b, s, d),
                                                    dtype=np.float32)
    return x, torch.from_numpy(x).to(getattr(torch, dtype))


def _ref_moe(jp, x, jcfg, dtype):
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    y, aux = jmoe.moe(jax.tree.map(jnp.asarray, jp),
                      jnp.asarray(x).astype(getattr(jnp, dtype)), jcfg)
    return _np(y), float(aux)


def _ref_route(jp, x, jcfg, dtype):
    """The reference's expert ids (T, k): ``jax.lax.top_k`` of its
    float32 softmax over router logits in ``dtype``."""
    import jax
    import jax.numpy as jnp
    xt = jnp.asarray(x.reshape(-1, x.shape[-1])).astype(getattr(jnp, dtype))
    logits = xt @ jnp.asarray(jp["router"]).astype(xt.dtype)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.moe.top_k)[1])


def _check_moe(cfg, jcfg, p, jp, x, xt, dtype):
    y, aux = moe_mod.moe(p, xt, cfg)
    want_y, want_aux = _ref_moe(jp, x, jcfg, dtype)
    assert y.shape == xt.shape and y.dtype == xt.dtype
    np.testing.assert_allclose(_np(y.float()), want_y, atol=ATOL[dtype])
    assert abs(float(aux) - want_aux) <= AUX_ATOL[dtype]
    _, _, experts = moe_mod.route(p, xt.reshape(-1, xt.shape[-1]), cfg.moe)
    np.testing.assert_array_equal(experts.numpy(),
                                  _ref_route(jp, x, jcfg, dtype))
    return y


def _dropped(p, xt, m):
    """Assignments past their (group, expert) capacity."""
    t = xt.shape[0] * xt.shape[1]
    g_sz, n_g, cap = moe_mod.groups(t, m)
    _, _, experts = moe_mod.route(p, xt.reshape(t, -1), m)
    counts = torch.nn.functional.one_hot(
        experts.reshape(n_g, -1), m.n_experts).sum(1)
    return int((counts - cap).clamp_min(0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_drops_tokens_past_capacity_as_the_reference(arch, dtype):
    """A capacity factor of 0.05 leaves each expert the floor of 4 slots
    a group: most assignments are dropped (gate 0), and what is kept
    equals the reference's."""
    cfg, jcfg, p, jp = _moe_layer(arch, dtype, seed=2, capacity_factor=0.05)
    x, xt = _x(3, 2, 32, cfg.d_model, dtype)
    assert moe_mod.groups(64, cfg.moe)[2] == 4
    assert _dropped(p, xt, cfg.moe) > 16
    y = _check_moe(cfg, jcfg, p, jp, x, xt, dtype)
    full, _ = moe_mod.moe(p, xt, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0)))
    assert float((full.float() - y.float()).abs().max()) > 1e-3


@pytest.mark.parametrize("b,s,want", [(2, 2048, (2048, 2)),
                                      (1, 2200, (8, 275))],
                         ids=["t4096-two-groups", "t2200-ragged"])
def test_moe_groups_match_reference(b, s, want):
    """t = 4096 routes in two groups of 2048; t = 2200 in groups of 8
    (2048 halved while it does not divide 2200), capacity
    max(int(1.25 * 8 * 2 / 4), 4) = 5 at granite's reduced config, so
    tokens are dropped; both equal the reference's output."""
    cfg, jcfg, p, jp = _moe_layer("granite-moe-1b-a400m", "float32", seed=4)
    g_sz, n_g, cap = moe_mod.groups(b * s, cfg.moe)
    assert (g_sz, n_g) == want
    x, xt = _x(5, b, s, cfg.d_model, "float32")
    if s == 2200:
        assert cap == 5 and _dropped(p, xt, cfg.moe) > 0
    _check_moe(cfg, jcfg, p, jp, x, xt, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_tied_router_logits_take_the_lower_expert(dtype):
    """Experts 1, 2 and 3 share one router column, so their logits tie
    exactly for every token, across the top-k boundary: the port picks
    the lower ids (1, then 2; never 3), as ``jax.lax.top_k`` does, and
    its output equals the reference's. The bfloat16 case also rounds the
    inputs to halves."""
    cfg, jcfg, p, jp = _moe_layer("granite-moe-1b-a400m", dtype, seed=6)
    col = np.array(jp["router"][:, 1])
    jp = dict(jp, router=np.stack([jp["router"][:, 0], col, col, col], 1))
    p = dict(p, router=torch.from_numpy(jp["router"]).to(p["router"].dtype))
    x, xt = _x(7, 4, 64, cfg.d_model, dtype)
    if dtype == "bfloat16":
        x = np.round(x * 2) / 2
        xt = torch.from_numpy(x).to(torch.bfloat16)
    _check_moe(cfg, jcfg, p, jp, x, xt, dtype)
    _, _, experts = moe_mod.route(p, xt.reshape(-1, cfg.d_model), cfg.moe)
    picked = set(experts.reshape(-1).tolist())
    assert picked <= {0, 1, 2} and {1, 2} <= picked


# -- MLA alone

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_and_decode_match_reference(dtype):
    """``mla_attention`` (with its cache) and ``mla_decode`` over a cache
    filled to position S - 1 equal the reference's, at deepseek's reduced
    config with nonzero q_norm/kv_norm weights; the prefill goes through
    ``mha`` with v narrower than q and k."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    cfg, jcfg = _cfgs("deepseek-v2-236b", dtype)
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed=8))
    rng = np.random.default_rng(9)
    jp = {k: np.array(v[0]) for k, v in tree["head_blocks"]["attn"].items()}
    for name in ("q_norm", "kv_norm"):
        jp[name] = rng.standard_normal(jp[name].shape).astype(np.float32) * .5
    p = {k: torch.from_numpy(v) for k, v in jp.items()}
    jpj = jax.tree.map(jnp.asarray, jp)
    dt = getattr(jnp, dtype)
    x = rng.standard_normal((2, 20, cfg.d_model), dtype=np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y, (ckv, kr) = attn_mod.mla_attention(p, xt, cfg, return_cache=True)
    wy, (wckv, wkr) = jattn.mla_attention(jpj, jnp.asarray(x).astype(dt),
                                          jcfg, return_cache=True)
    for got, want in ((y, wy), (ckv, wckv), (kr, wkr)):
        assert got.dtype == xt.dtype and got.shape == want.shape
        np.testing.assert_allclose(_np(got.float()), _np(want),
                                   atol=ATOL[dtype])
    s_max, pos = 24, 19
    cache = {n: torch.zeros((2, s_max, c.shape[-1]), dtype=xt.dtype)
             for n, c in (("ckv", ckv), ("kr", kr))}
    cache["ckv"][:, :pos] = ckv[:, :pos]
    cache["kr"][:, :pos] = kr[:, :pos]
    jcache = {n: jnp.asarray(_np(c.float())).astype(dt)
              for n, c in cache.items()}
    xd = x[:, pos:pos + 1]
    yd, c1, c2 = attn_mod.mla_decode(p, xt[:, pos:pos + 1], cache["ckv"],
                                     cache["kr"], pos, cfg)
    wyd, w1, w2 = jattn.mla_decode(jpj, jnp.asarray(xd).astype(dt),
                                   jcache["ckv"], jcache["kr"], pos, jcfg)
    assert c1 is cache["ckv"] and c2 is cache["kr"]
    for got, want in ((yd, wyd), (c1, w1), (c2, w2)):
        np.testing.assert_allclose(_np(got.float()), _np(want),
                                   atol=ATOL[dtype])
    # the decode of the last prompt token is the prefill's last row
    np.testing.assert_allclose(_np(yd[:, 0].float()), _np(y[:, pos].float()),
                               atol=ATOL[dtype])


# -- configs, counts, trees

def _moe_fields(cfg):
    return {n: (dataclasses.asdict(getattr(cfg, n))
                if getattr(cfg, n) is not None else None)
            for n in ("moe", "mla")}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_counts_match_reference(arch):
    """Every field of the port's config (and its reduced form) equals the
    reference's, ``moe`` and ``mla`` field for field; every reference
    field the port lacks is at the reference's default, training knobs
    aside; total and active parameter counts equal the reference's, at
    full size its 1,334,756,352 / 428,196,864 (granite) and
    235,741,434,880 / 21,329,280,000 (deepseek)."""
    from repro.common.config import MLAConfig as RefMLA
    from repro.common.config import ModelConfig as RefConfig
    from repro.common.config import MoEConfig as RefMoE
    from repro.configs import get_config as jax_config
    from repro.configs import get_reduced as jax_reduced
    from repro.models import lm as jlm
    from repro_torch.common.config import MLAConfig, MoEConfig
    for mine, ref in ((MoEConfig, RefMoE), (MLAConfig, RefMLA)):
        assert dataclasses.asdict(mine()) == dataclasses.asdict(ref())
    ported = {f.name for f in dataclasses.fields(type(get_config(arch)))}
    defaults = {f.name: f.default for f in dataclasses.fields(RefConfig)
                if f.default is not dataclasses.MISSING}
    assert {"moe", "mla"} <= ported
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_reduced(arch), jax_reduced(arch))):
        assert {n: getattr(mine, n) for n in ported - {"moe", "mla"}} == {
            n: getattr(ref, n) for n in ported - {"moe", "mla"}}
        assert _moe_fields(mine) == _moe_fields(ref)
        assert {n: getattr(ref, n) for n in defaults
                if n not in ported | TRAINING_ONLY} == {
            n: v for n, v in defaults.items()
            if n not in ported | TRAINING_ONLY}
        assert mine.n_params() == jlm.count_params(ref)
        assert mine.n_active_params() == jlm.count_params(ref,
                                                          active_only=True)
    full = get_config(arch)
    assert (full.n_params(), full.n_active_params()) == (N_PARAMS[arch],
                                                         N_ACTIVE[arch])
    assert arch not in NOT_PORTED


def test_not_ported_is_whisper_xlstm_and_zamba2():
    """Of the three architectures this test once named, all are ported
    now (xLSTM and zamba2's hybrid, then whisper's encoder-decoder):
    ``NOT_PORTED`` is empty, all three build, and an architecture the
    reference lacks raises."""
    assert NOT_PORTED == ()
    for arch in ("whisper-small", "xlstm-1.3b", "zamba2-1.2b"):
        assert get_config(arch).arch_id == arch
        assert lm.model_spec(get_reduced(arch))
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-2")
    cfg = get_reduced("granite-moe-1b-a400m")
    with pytest.raises(ValueError, match="needs cfg.moe"):
        lm.model_spec(dataclasses.replace(cfg, moe=None))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_takes_the_moe_trees(arch):
    """The reference's tree goes across leaf for leaf: deepseek's
    ``head_blocks`` (a dense MLP ``d_ff_dense`` wide, MLA) and its MoE
    layer's nested ``shared`` expert, granite's GQA and routed experts;
    a tree missing the shared expert's gate is refused."""
    import jax
    cfg, jcfg = _cfgs(arch, "float32")
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed=1))
    params = params_from_jax(tree, cfg, "cpu")
    blk = params["units"]["blk"]
    want_mlp = {"router", "w_in", "w_gate", "w_out"}
    if cfg.moe.n_shared:
        want_mlp.add("shared")
        assert sorted(blk["mlp"]["shared"]) == ["w_gate", "w_in", "w_out"]
        head = params["head_blocks"]
        assert tuple(head["mlp"]["w_in"].shape) == (1, cfg.d_model,
                                                    cfg.moe.d_ff_dense)
        assert sorted(head["attn"]) == sorted(attn_mod.spec_mla(cfg))
        np.testing.assert_array_equal(head["attn"]["w_uk"].numpy(),
                                      tree["head_blocks"]["attn"]["w_uk"])
    else:
        assert "head_blocks" not in params and "lm_head" not in params
        assert sorted(blk["attn"]) == ["wk", "wo", "wq", "wv"]
    assert set(blk["mlp"]) == want_mlp
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert tuple(blk["mlp"]["w_in"].shape) == (
        n_moe, cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert)
    np.testing.assert_array_equal(blk["mlp"]["router"].numpy(),
                                  tree["units"]["blk"]["mlp"]["router"])
    if cfg.moe.n_shared:
        mlp = dict(tree["units"]["blk"]["mlp"])
        mlp["shared"] = {k: v for k, v in mlp["shared"].items()
                         if k != "w_gate"}
        cut = dict(tree, units={"blk": dict(tree["units"]["blk"], mlp=mlp)})
        with pytest.raises(ValueError, match="missing leaves \\['w_gate'\\]"):
            params_from_jax(cut, cfg, "cpu")
