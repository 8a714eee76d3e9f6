"""PyTorch port: the hybrid family (zamba2-1.2b) and its Mamba-2 (SSD)
block against the JAX reference, on the CPU, with the reference's own
weights carried across by ``params_from_jax``.

Two model variants: the reduced configuration (4 Mamba-2 layers, the
shared attention block every 2, d_model 64) has no tail; a 5-layer
variant of it runs the shared block a third time before a tail of one
layer, as the full model's 38 = 6 x 6 + 2 does.

JAX runs in-process through ``repro.configs`` and ``repro.models`` only.
Inputs come from ``numpy.random.default_rng`` with fixed seeds.

Tolerances are those of ``tests/test_torch_models.py``: 1e-4 on float32
logits and cache leaves with greedy tokens equal, 2e-2 in bfloat16
(decode teacher-forced on the reference's tokens). The 5-layer variant
is held to the reference in float32, which holds its structure (the
tail, its k/v slot, its states) to 1e-4. In bfloat16 its logits are
held to the float32 reference's instead: at its depth the reference's
own bfloat16 logits lie about 2e-2 from them (0.0194 at seed 0), so two
bfloat16 runs that round in different places can differ by more than
2e-2 with neither at fault; the port's bfloat16 error may be at most
twice the reference's own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import NOT_PORTED, get_config, get_reduced
from repro_torch.models import decode as dec
from repro_torch.models import lm
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import chunk_len
from repro_torch.models.convert import params_from_jax

ARCH = "zamba2-1.2b"
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, GEN = 2, 24, 8
# the reference's n_params() at full size (repro.configs, on the CPU)
N_PARAMS = 1_170_473_856
VARIANTS = {"reduced": {}, "tail": {"n_layers": 5}}
# reference fields the serving path does not read: training knobs
TRAINING_ONLY = {"adam_dtype", "remat_policy", "scan_group", "train_accum"}


def _cfgs(compute_dtype, **changes):
    from repro.configs import get_reduced as jax_reduced
    return (dataclasses.replace(get_reduced(ARCH),
                                compute_dtype=compute_dtype, **changes),
            dataclasses.replace(jax_reduced(ARCH),
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


def _leaves(cache):
    """{(group, leaf): array} of a hybrid cache, ``pos`` aside."""
    return {(k, name): _np(val) for k, sub in cache.items() if k != "pos"
            for name, val in sub.items()}


def _jax_run(jp, jcfg, toks, gen):
    """Reference: forward logits, prefill (logits and cache), then greedy
    decode (one jitted step: traced once, not per step)."""
    import jax
    import jax.numpy as jnp
    from repro.models import decode as jdec
    from repro.models import lm as jlm
    step_fn = jax.jit(jdec.decode_step, static_argnums=3)
    out = {"forward": _np(jlm.forward(jp, jnp.asarray(toks), jcfg)[0])}
    logits, cache = jdec.prefill(jp, jnp.asarray(toks), jcfg,
                                 max_seq=toks.shape[1] + gen)
    out["prefill"] = _np(logits)
    out["cache"] = _leaves(cache)
    tokens, steps = [], []
    tok = jnp.argmax(logits, -1)[:, None]
    for _ in range(gen):
        tokens.append(np.asarray(tok))
        logits, cache = step_fn(jp, cache, tok, jcfg)
        steps.append(_np(logits))
        tok = jnp.argmax(logits, -1)[:, None]
    out["tokens"] = np.concatenate(tokens, axis=1)
    out["decode"] = steps
    out["decode_cache"] = _leaves(cache)
    return out


@pytest.fixture(scope="module", params=[
    ("reduced", "float32"), ("reduced", "bfloat16"), ("tail", "float32")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def parity(request):
    """Both packages on the same weights and prompts: one variant, one
    compute dtype."""
    import jax
    variant, dtype = request.param
    cfg, jcfg = _cfgs(dtype, **VARIANTS[variant])
    jp = _jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(0, B, S, cfg.vocab_size)
    return {"variant": variant, "dtype": dtype, "cfg": cfg,
            "params": params, "toks": toks,
            "ref": _jax_run(jp, jcfg, toks, GEN)}


def test_forward_matches_reference(parity):
    logits, aux = lm.forward(parity["params"],
                             torch.from_numpy(parity["toks"]), parity["cfg"])
    assert logits.shape == (B, S, parity["cfg"].padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), parity["ref"]["forward"],
                               atol=ATOL[parity["dtype"]])


def test_prefill_logits_and_cache_match_reference(parity):
    """Every cache leaf: one k/v slot per application of the shared block
    (3 with the tail), each Mamba-2 layer's conv tail (compute dtype) and
    SSD state (float32)."""
    cfg = parity["cfg"]
    logits, cache = dec.prefill(parity["params"],
                                torch.from_numpy(parity["toks"]), cfg,
                                max_seq=S + GEN)
    tol = ATOL[parity["dtype"]]
    assert cache["pos"] == S
    np.testing.assert_allclose(_np(logits), parity["ref"]["prefill"],
                               atol=tol)
    mine, want = _leaves(cache), parity["ref"]["cache"]
    tail = parity["variant"] == "tail"
    assert sorted(mine) == sorted(want) == sorted(
        [("attn", "k"), ("attn", "v"), ("mamba", "conv"), ("mamba", "ssm")]
        + ([("tail", "conv"), ("tail", "ssm")] if tail else []))
    n_heads = 2 * cfg.d_model // cfg.ssm.head_dim
    assert mine[("attn", "k")].shape == (3 if tail else 2, B, S + GEN,
                                         cfg.n_kv_heads, cfg.head_dim_)
    assert mine[("mamba", "ssm")].shape == (2, 2, B, n_heads,
                                            cfg.ssm.head_dim,
                                            cfg.ssm.d_state)
    for key, got in mine.items():
        assert got.shape == want[key].shape, key
        np.testing.assert_allclose(got, want[key], atol=tol, err_msg=str(key))
    cdt = getattr(torch, parity["dtype"])
    assert cache["attn"]["k"].dtype == cache["mamba"]["conv"].dtype == cdt
    assert cache["mamba"]["ssm"].dtype == torch.float32
    assert not cache["attn"]["v"][:, :, S:].any()


def test_greedy_decode_matches_reference(parity):
    """GEN decode steps, teacher-forced on the reference's greedy tokens:
    logits within tolerance at every step, and the states after the last
    within it scaled to the leaf's largest value where that is above 1
    (as ``tests/test_torch_xlstm.py`` holds its states); in float32 the
    port's own argmax gives the same tokens."""
    cfg, ref = parity["cfg"], parity["ref"]
    tol = ATOL[parity["dtype"]]
    logits, cache = dec.prefill(parity["params"],
                                torch.from_numpy(parity["toks"]), cfg,
                                max_seq=S + GEN)
    mine = [logits.argmax(-1)]
    for step in range(GEN):
        tok = torch.from_numpy(ref["tokens"][:, step:step + 1]).long()
        logits, cache = dec.decode_step(parity["params"], cache, tok, cfg)
        assert cache["pos"] == S + step + 1
        np.testing.assert_allclose(_np(logits), ref["decode"][step],
                                   atol=tol)
        mine.append(logits.argmax(-1))
    for key, got in _leaves(cache).items():
        want = ref["decode_cache"][key]
        np.testing.assert_allclose(
            got, want, atol=tol * max(1.0, float(np.abs(want).max())),
            err_msg=str(key))
    if parity["dtype"] == "float32":
        np.testing.assert_array_equal(
            torch.stack(mine[:GEN], dim=1).numpy(), ref["tokens"])


def test_tail_variant_bfloat16_error_within_the_references():
    """The 5-layer variant in bfloat16: the port's forward logits lie no
    farther from the float32 reference's than twice the reference's own
    bfloat16 logits do (both errors in the message)."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    cfg, jcfg = _cfgs("bfloat16", **VARIANTS["tail"])
    jp = _jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(0, B, S, cfg.vocab_size)
    exact = _np(jlm.forward(jp, jnp.asarray(toks), dataclasses.replace(
        jcfg, compute_dtype="float32"))[0])
    ref_err = np.abs(_np(jlm.forward(jp, jnp.asarray(toks), jcfg)[0])
                     - exact).max()
    port_err = np.abs(_np(lm.forward(params, torch.from_numpy(toks),
                                     cfg)[0]) - exact).max()
    assert ref_err > 0
    assert port_err <= 2 * ref_err, (port_err, ref_err)


# -- the Mamba-2 block alone

def _block(dtype, seed):
    """(cfg, jcfg, the port's and the reference's weights of one Mamba-2
    layer of the reduced config), with the reference's zero and one
    initialisations (norms, conv bias, dt bias, A, D) replaced by random
    values, so that each one's place in the arithmetic shows."""
    import jax
    cfg, jcfg = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed))
    rng = np.random.default_rng(seed + 100)
    jp = {k: np.array(v[0, 0]) for k, v in tree["units"]["mamba"].items()}
    for name in ("pre_norm", "norm", "conv_b", "dt_bias", "d_skip"):
        jp[name] = (rng.standard_normal(jp[name].shape) * 0.5).astype(
            np.float32)
    jp["a_log"] = rng.uniform(-1.0, 1.5, jp["a_log"].shape).astype(
        np.float32)
    p = {k: torch.from_numpy(v) for k, v in jp.items()}
    return cfg, jcfg, p, jp


def _states(cfg, rng, b):
    d_inner, n_heads, conv_dim = ssm_mod._dims(cfg)
    s = cfg.ssm
    conv = rng.standard_normal((b, s.d_conv - 1, conv_dim)).astype(
        np.float32)
    state = (rng.standard_normal((b, n_heads, s.head_dim, s.d_state))
             * 0.3).astype(np.float32)
    return conv, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length,chunk", [(16, 16), (40, 8), (24, 8)],
                         ids=["L16", "L40", "L24"])
def test_mamba2_matches_reference(length, chunk, dtype):
    """``mamba2`` from given conv and SSD states (a continued prefill) at
    L = 16, 40 and 24: chunks of 16, 8 (16 halved until it divides 40)
    and 8; output and both final states equal the reference's."""
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    cfg, jcfg, p, jp = _block(dtype, seed=3)
    assert chunk_len(cfg.ssm.chunk, length) == chunk
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, cfg.d_model)).astype(np.float32)
    conv, state = _states(cfg, rng, 2)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, c, h = ssm_mod.mamba2(p, torch.from_numpy(x).to(tdt), cfg,
                             torch.from_numpy(conv).to(tdt),
                             torch.from_numpy(state))
    wy, wc, wh = jssm.mamba2({k: jnp.asarray(v) for k, v in jp.items()},
                             jnp.asarray(x).astype(jdt), jcfg,
                             jnp.asarray(conv).astype(jdt),
                             jnp.asarray(state))
    assert y.dtype == c.dtype == tdt and h.dtype == torch.float32
    for got, want in ((y, wy), (c, wc), (h, wh)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype])
    assert not torch.equal(h, torch.from_numpy(state))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_reference(dtype):
    """Three ``mamba2_decode`` steps from random states equal the
    reference's, states included."""
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    cfg, jcfg, p, jp = _block(dtype, seed=4)
    jpj = {k: jnp.asarray(v) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    conv, state = _states(cfg, rng, 3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    c, h = torch.from_numpy(conv).to(tdt), torch.from_numpy(state)
    wc, wh = jnp.asarray(conv).astype(jdt), jnp.asarray(state)
    for step in range(3):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y, c, h = ssm_mod.mamba2_decode(p, torch.from_numpy(x).to(tdt), c, h,
                                        cfg)
        wy, wc, wh = jssm.mamba2_decode(jpj, jnp.asarray(x).astype(jdt), wc,
                                        wh, jcfg)
        for got, want in ((y, wy), (c, wc), (h, wh)):
            np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_after_prefill_matches_longer_prefill(variant):
    """The recurrent form against the chunked one: ``decode_step`` after
    ``prefill(L)`` gives the last logits of ``prefill(L + 1)``, for L = 23
    (chunk 1) then 24 (chunk 8), and L = 31 (chunk 1) then 32 (chunk 16),
    in float32."""
    cfg = dataclasses.replace(get_reduced(ARCH), compute_dtype="float32",
                              **VARIANTS[variant])
    params = lm.init_params(cfg, seed=6, device="cpu")
    toks = torch.from_numpy(_tokens(7, 2, 32, cfg.vocab_size)).long()
    for length in (23, 31):
        _, cache = dec.prefill(params, toks[:, :length], cfg,
                               max_seq=length + 1)
        got, cache = dec.decode_step(params, cache,
                                     toks[:, length:length + 1], cfg)
        want, ref_cache = dec.prefill(params, toks[:, :length + 1], cfg)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"])
        for key, leaf in _leaves(ref_cache).items():
            np.testing.assert_allclose(_leaves(cache)[key], leaf,
                                       atol=ATOL["float32"], err_msg=str(key))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(variant, dtype):
    """``init_cache`` leaf for leaf as the reference's: keys, shapes,
    dtypes (states float32 whatever the compute dtype) and start values
    (all zeros), with the tail's leaves only where there is a tail."""
    from repro.models import lm as jlm
    cfg, jcfg = _cfgs(dtype, **VARIANTS[variant])
    mine = lm.init_cache(cfg, 3, 10, device="cpu")
    want = jlm.init_cache(jcfg, 3, 10)
    assert mine["pos"] == 0
    assert sorted(_leaves(mine)) == sorted(_leaves(want))
    for k in mine:
        if k == "pos":
            continue
        for name, leaf in mine[k].items():
            ref = np.asarray(want[k][name])
            assert tuple(leaf.shape) == ref.shape, (k, name)
            assert str(leaf.dtype).split(".")[-1] == str(ref.dtype), (k, name)
            np.testing.assert_array_equal(_np(leaf), ref.astype(np.float32))


# -- config, counts, trees

def test_config_and_param_count_match_reference():
    """Every field of the port's zamba2 config (and its reduced form)
    equals the reference's, ``ssm`` field for field; every reference
    field the port lacks is at the reference's default, training knobs
    aside; the parameter counts are equal, at full size the reference's
    1,170,473,856; the derived properties agree."""
    from repro.common.config import ModelConfig as RefConfig
    from repro.common.config import SSMConfig as RefSSM
    from repro.configs import get_config as jax_config
    from repro.configs import get_reduced as jax_reduced
    from repro.models import lm as jlm
    from repro_torch.common.config import SSMConfig
    assert dataclasses.asdict(SSMConfig()) == dataclasses.asdict(RefSSM())
    ported = {f.name for f in dataclasses.fields(type(get_config(ARCH)))}
    assert {"ssm", "xlstm", "shared_attn_every"} <= ported
    assert len(ported) == 38            # the training knobs too
    defaults = {f.name: f.default for f in dataclasses.fields(RefConfig)
                if f.default is not dataclasses.MISSING}
    for mine, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_reduced(ARCH), jax_reduced(ARCH))):
        plain = ported - {"ssm", "xlstm", "moe", "mla"}
        assert {n: getattr(mine, n) for n in plain} == {
            n: getattr(ref, n) for n in plain}
        assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(ref.ssm)
        assert mine.xlstm is None and ref.xlstm is None
        assert {n: getattr(ref, n) for n in defaults
                if n not in ported | TRAINING_ONLY} == {
            n: v for n, v in defaults.items()
            if n not in ported | TRAINING_ONLY}
        assert mine.n_params() == jlm.count_params(ref)
        assert (mine.is_attention_free, mine.supports_long_context) == (
            ref.is_attention_free, ref.supports_long_context) == (False, True)
    assert get_config(ARCH).n_params() == N_PARAMS
    assert ARCH not in NOT_PORTED


def test_params_from_jax_takes_the_hybrid_tree():
    """The 5-layer variant's tree goes across leaf for leaf: the
    ``shared_block``, the nested ``units/mamba`` stack (units, layers)
    and the ``tail``; a tree missing one nested leaf is refused."""
    import jax
    cfg, jcfg = _cfgs("float32", n_layers=5)
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed=1))
    params = params_from_jax(tree, cfg, "cpu")
    assert sorted(params) == ["embed", "final_norm", "lm_head",
                              "shared_block", "tail", "units"]
    assert tuple(params["units"]["mamba"]["w_in"].shape) == (
        2, 2) + tuple(tree["units"]["mamba"]["w_in"].shape[2:])
    assert tuple(params["tail"]["a_log"].shape) == (1, 8)
    np.testing.assert_array_equal(params["tail"]["conv_w"].numpy(),
                                  tree["tail"]["conv_w"])
    np.testing.assert_array_equal(
        params["shared_block"]["attn"]["wq"].numpy(),
        tree["shared_block"]["attn"]["wq"])
    cut = dict(tree, units={"mamba": {k: v for k, v in
                                      tree["units"]["mamba"].items()
                                      if k != "dt_bias"}})
    with pytest.raises(ValueError, match="missing leaves \\['dt_bias'\\]"):
        params_from_jax(cut, cfg, "cpu")
    cut = {k: v for k, v in tree.items() if k != "tail"}
    with pytest.raises(ValueError, match="missing leaves \\['tail'\\]"):
        params_from_jax(cut, cfg, "cpu")


def test_hybrid_family_needs_its_fields():
    cfg = get_reduced(ARCH)
    for other in (dataclasses.replace(cfg, ssm=None),
                  dataclasses.replace(cfg, shared_attn_every=0)):
        with pytest.raises(ValueError, match="hybrid family needs"):
            lm.model_spec(other)
