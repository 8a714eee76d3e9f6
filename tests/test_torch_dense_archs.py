"""PyTorch port: the rest of the reference's dense and vlm architectures
(glm4-9b, chameleon-34b, nemotron-4-340b) against the JAX reference, on
the CPU at their reduced configurations (2 layers, d_model 64), with the
reference's own weights carried across by ``params_from_jax``.

What each one brings: glm4 its config alone (QKV bias, a GQA group of 2
here and 16 at full width); chameleon qk-norm (a per-head RMSNorm of q
and k before rope), the vlm family run as dense and the ``fused``
frontend (token ids over the fused vocabulary); nemotron the ungated MLP
with squared ReLU and, at full width, head dim 192.

JAX runs in-process through ``repro.configs`` and ``repro.models`` only:
neither needs 64-bit mode or sets anything at import. Inputs come from
``numpy.random.default_rng`` with fixed seeds.

Tolerances are those of ``tests/test_torch_models.py``: 1e-4 on float32
logits (two summation orders; measured differences are near 2e-7) with
greedy tokens equal, 2e-2 in bfloat16 (the reference suite's own bound;
the packages round activations at different places, so bfloat16 decode
is teacher-forced on the reference's tokens). With nonzero qk-norm
weights the bfloat16 keys reach |k| near 4, where one bfloat16 step is
2^-6, so there the cache is held row by row instead: each head vector's
largest error within two bfloat16 steps (2^-6) of its largest value.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import NOT_PORTED, get_config, get_reduced
from repro_torch.models import attention as attn_mod
from repro_torch.models import decode as dec
from repro_torch.models import lm
from repro_torch.models.common import (act_fn, apply_norm, apply_rope,
                                       relu2, rmsnorm, rope_angles)
from repro_torch.models.convert import params_from_jax

ARCHS = ("glm4-9b", "chameleon-34b", "nemotron-4-340b")
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
# bfloat16 cache with nonzero qk-norm weights: error per head vector
# relative to its largest value (two bfloat16 steps)
ROW_RTOL = 2.0 ** -6
B, S, GEN = 2, 24, 8
# the reference's n_params() at full size (repro.configs, on the CPU)
N_PARAMS = {"glm4-9b": 9_399_951_360, "chameleon-34b": 34_293_436_416,
            "nemotron-4-340b": 341_025_638_400}
# reference fields the serving path does not read: training knobs
TRAINING_ONLY = {"adam_dtype", "remat_policy", "scan_group", "train_accum"}


def _cfgs(arch, compute_dtype):
    from repro.configs import get_reduced as jax_reduced
    return (dataclasses.replace(get_reduced(arch),
                                compute_dtype=compute_dtype),
            dataclasses.replace(jax_reduced(arch),
                                compute_dtype=compute_dtype))


def _jax_params(jcfg, seed=0):
    import jax
    from repro.models import lm as jlm
    return jlm.init_params(jcfg, jax.random.PRNGKey(seed))


def _np(x):
    return np.asarray(x, np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _jax_run(jp, jcfg, toks, gen):
    """Reference: forward logits, prefill (logits and cache), then greedy
    decode."""
    import jax.numpy as jnp
    from repro.models import decode as jdec
    from repro.models import lm as jlm
    out = {"forward": _np(jlm.forward(jp, jnp.asarray(toks), jcfg)[0])}
    logits, cache = jdec.prefill(jp, jnp.asarray(toks), jcfg,
                                 max_seq=toks.shape[1] + gen)
    out["prefill"] = _np(logits)
    out["cache"] = {n: _np(cache["units"]["blk"][n]) for n in "kv"}
    tokens, steps = [], []
    tok = jnp.argmax(logits, -1)[:, None]
    for _ in range(gen):
        tokens.append(np.asarray(tok))
        logits, cache = jdec.decode_step(jp, cache, tok, jcfg)
        steps.append(_np(logits))
        tok = jnp.argmax(logits, -1)[:, None]
    out["tokens"] = np.concatenate(tokens, axis=1)
    out["decode"] = steps
    return out


def _with_qk_norm_weights(tree, seed):
    """The reference tree with nonzero q_norm/k_norm (zeros at init, where
    ``1 + w`` is 1 and the norm's weights cannot show)."""
    rng = np.random.default_rng(seed)
    attn = dict(tree["units"]["blk"]["attn"])
    for name in ("q_norm", "k_norm"):
        attn[name] = rng.standard_normal(attn[name].shape).astype(
            np.float32) * 0.5
    blk = dict(tree["units"]["blk"], attn=attn)
    return dict(tree, units={"blk": blk})


def _run_parity(arch, dtype, tree_fn=None):
    import jax
    cfg, jcfg = _cfgs(arch, dtype)
    tree = jax.tree.map(np.asarray, _jax_params(jcfg))
    if tree_fn is not None:
        tree = tree_fn(tree)
    jp = jax.tree.map(jax.numpy.asarray, tree)
    params = params_from_jax(tree, cfg, "cpu")
    toks = _tokens(0, B, S, cfg.vocab_size)
    return {"arch": arch, "dtype": dtype, "cfg": cfg, "params": params,
            "toks": toks, "ref": _jax_run(jp, jcfg, toks, GEN)}


@pytest.fixture(scope="module", params=[
    (a, d) for a in ARCHS for d in ("float32", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def parity(request):
    """Both packages on the same weights and prompts: one architecture,
    one compute dtype."""
    return _run_parity(*request.param)


def _check_forward(run):
    logits, aux = lm.forward(run["params"], torch.from_numpy(run["toks"]),
                             run["cfg"])
    assert logits.shape == (B, S, run["cfg"].padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits.float()), run["ref"]["forward"],
                               atol=ATOL[run["dtype"]])


def _check_prefill(run, row_rtol=None):
    """Prefill logits and cache against the reference's; ``row_rtol``
    holds the cache per head vector relative to its largest value
    instead of ``ATOL``."""
    cfg = run["cfg"]
    logits, cache = dec.prefill(run["params"], torch.from_numpy(run["toks"]),
                                cfg, max_seq=S + GEN)
    tol = ATOL[run["dtype"]]
    assert cache["pos"] == S
    assert sorted(cache["units"]) == ["blk"]
    np.testing.assert_allclose(_np(logits.float()), run["ref"]["prefill"],
                               atol=tol)
    for name in "kv":
        got = cache["units"]["blk"][name]
        assert got.dtype == getattr(torch, run["dtype"])
        assert tuple(got.shape) == run["ref"]["cache"][name].shape == (
            cfg.n_layers, B, S + GEN, cfg.n_kv_heads, cfg.head_dim_)
        want = run["ref"]["cache"][name]
        if row_rtol is None:
            np.testing.assert_allclose(_np(got.float()), want, atol=tol)
        else:
            err = np.abs(_np(got.float()) - want).max(-1)
            assert (err <= row_rtol * np.abs(want).max(-1)).all(), name


def _check_decode(run):
    """GEN decode steps, teacher-forced on the reference's greedy tokens:
    logits within tolerance at every step; in float32 the port's own
    argmax gives the same tokens."""
    cfg, ref = run["cfg"], run["ref"]
    logits, cache = dec.prefill(run["params"], torch.from_numpy(run["toks"]),
                                cfg, max_seq=S + GEN)
    mine = [logits.argmax(-1)]
    for step in range(GEN):
        tok = torch.from_numpy(ref["tokens"][:, step:step + 1]).long()
        logits, cache = dec.decode_step(run["params"], cache, tok, cfg)
        assert cache["pos"] == S + step + 1
        np.testing.assert_allclose(_np(logits.float()), ref["decode"][step],
                                   atol=ATOL[run["dtype"]])
        mine.append(logits.argmax(-1))
    if run["dtype"] == "float32":
        np.testing.assert_array_equal(
            torch.stack(mine[:GEN], dim=1).numpy(), ref["tokens"])


def test_forward_matches_reference(parity):
    _check_forward(parity)


def test_prefill_logits_and_cache_match_reference(parity):
    _check_prefill(parity)


def test_greedy_decode_matches_reference(parity):
    _check_decode(parity)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_norm_with_nonzero_weights_matches_reference(dtype):
    """chameleon with nonzero qk-norm weights (``1 + w`` not 1): forward,
    prefill logits and cache, and greedy decode still equal the
    reference's (the bfloat16 cache row by row, ``ROW_RTOL``), and the
    weights move the logits."""
    run = _run_parity("chameleon-34b", dtype,
                      lambda t: _with_qk_norm_weights(t, seed=11))
    _check_forward(run)
    _check_prefill(run, ROW_RTOL if dtype == "bfloat16" else None)
    _check_decode(run)
    zero = _run_parity("chameleon-34b", dtype)
    assert np.abs(run["ref"]["forward"] - zero["ref"]["forward"]).max() > 1e-2


def test_qk_norm_comes_before_rope():
    """The per-head norm is applied to q and k before rope, with the
    reference's fixed eps 1e-6: the port's first-layer keys equal the
    reference's cache, and normalizing after rope instead (the per-dim
    weights do not commute with rope's rotation of dim i with i + dh/2)
    gives other keys."""
    import jax
    cfg, jcfg = _cfgs("chameleon-34b", "float32")
    tree = _with_qk_norm_weights(jax.tree.map(np.asarray, _jax_params(jcfg)),
                                 seed=12)
    params = params_from_jax(tree, cfg, "cpu")
    toks = _tokens(1, 1, 16, cfg.vocab_size)
    _, cache = dec.prefill(params, torch.from_numpy(toks), cfg)
    from repro.models import decode as jdec
    _, jcache = jdec.prefill(jax.tree.map(jax.numpy.asarray, tree),
                             jax.numpy.asarray(toks), jcfg)
    want = _np(jcache["units"]["blk"]["k"][0])
    np.testing.assert_allclose(cache["units"]["blk"]["k"][0].numpy(), want,
                               atol=ATOL["float32"])
    blk = lm.unit(params["units"], 0)["blk"]
    x = apply_norm(blk["pre_attn"], lm.embed(params, torch.from_numpy(toks),
                                             cfg), cfg)
    bare = {n: w for n, w in blk["attn"].items()
            if n not in ("q_norm", "k_norm")}
    _, k, _ = attn_mod._project_qkv(bare, x, cfg)
    cos, sin = rope_angles(torch.arange(16), cfg.head_dim_, cfg.rope_theta)
    after = rmsnorm(apply_rope(k, cos, sin), blk["attn"]["k_norm"],
                    attn_mod.QK_NORM_EPS)
    assert np.abs(after.numpy() - want).max() > 1e-2
    before = apply_rope(rmsnorm(k, blk["attn"]["k_norm"],
                                attn_mod.QK_NORM_EPS), cos, sin)
    np.testing.assert_allclose(before.numpy(), want, atol=ATOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_reference(arch):
    """Every field of the port's config (and its reduced form) equals the
    reference's; every reference field the port lacks is at the
    reference's default, training knobs aside; the parameter counts are
    equal, and equal the reference's full-size counts."""
    from repro.common.config import ModelConfig as RefConfig
    from repro.configs import get_config as jax_config
    from repro.configs import get_reduced as jax_reduced
    from repro.models import lm as jlm
    ported = {f.name for f in dataclasses.fields(type(get_config(arch)))}
    defaults = {f.name: f.default for f in dataclasses.fields(RefConfig)
                if f.default is not dataclasses.MISSING}
    assert {"gated_mlp", "qk_norm", "frontend"} <= ported
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_reduced(arch), jax_reduced(arch))):
        assert {n: getattr(mine, n) for n in ported} == {
            n: getattr(ref, n) for n in ported}
        assert {n: getattr(ref, n) for n in defaults
                if n not in ported | TRAINING_ONLY} == {
            n: v for n, v in defaults.items()
            if n not in ported | TRAINING_ONLY}
        assert mine.n_params() == jlm.count_params(ref)
        assert mine.padded_vocab == ref.padded_vocab
    assert get_config(arch).n_params() == N_PARAMS[arch]
    assert arch not in NOT_PORTED


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_takes_the_reference_tree(arch):
    """The reference's tree goes across leaf for leaf: nemotron's MLP
    without ``w_gate``, chameleon's attention with ``q_norm``/``k_norm``
    of shape (dh,), glm4's biases; a tree missing one of those leaves is
    refused."""
    import jax
    cfg, jcfg = _cfgs(arch, "float32")
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed=1))
    params = params_from_jax(tree, cfg, "cpu")
    blk = params["units"]["blk"]
    assert sorted(blk["mlp"]) == (["w_gate", "w_in", "w_out"] if cfg.gated_mlp
                                  else ["w_in", "w_out"])
    want_attn = {"wq", "wk", "wv", "wo"}
    if cfg.qkv_bias:
        want_attn |= {"bq", "bk", "bv"}
    if cfg.qk_norm:
        want_attn |= {"q_norm", "k_norm"}
        assert tuple(blk["attn"]["q_norm"].shape) == (cfg.n_layers,
                                                      cfg.head_dim_)
    assert set(blk["attn"]) == want_attn
    for path in (("mlp", "w_in"), ("attn", "wq")):
        np.testing.assert_array_equal(
            blk[path[0]][path[1]].numpy(),
            tree["units"]["blk"][path[0]][path[1]])
    leaf = {"glm4-9b": ("attn", "bk"), "chameleon-34b": ("attn", "k_norm"),
            "nemotron-4-340b": ("mlp", "w_in")}[arch]
    sub = dict(tree["units"]["blk"][leaf[0]])
    del sub[leaf[1]]
    cut = dict(tree, units={"blk": dict(tree["units"]["blk"],
                                        **{leaf[0]: sub})})
    with pytest.raises(ValueError,
                       match=f"missing leaves \\['{leaf[1]}'\\]"):
        params_from_jax(cut, cfg, "cpu")
    if not cfg.gated_mlp:
        mlp = dict(tree["units"]["blk"]["mlp"],
                   w_gate=np.zeros_like(tree["units"]["blk"]["mlp"]["w_in"]))
        extra = dict(tree, units={"blk": dict(tree["units"]["blk"],
                                              mlp=mlp)})
        with pytest.raises(ValueError, match="extra leaves \\['w_gate'\\]"):
            params_from_jax(extra, cfg, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu2_is_the_reference_squared_relu(dtype):
    """``relu2`` equals ``jnp.square(jax.nn.relu(x))`` in the input's
    dtype, and is the activation ``act_fn("relu2")`` returns."""
    import jax
    import jax.numpy as jnp
    x = np.random.default_rng(5).standard_normal(2000, dtype=np.float32) * 4
    got = relu2(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    want = jnp.square(jax.nn.relu(jnp.asarray(x).astype(getattr(jnp,
                                                                dtype))))
    np.testing.assert_array_equal(_np(got.float()), _np(want))
    assert act_fn("relu2") is relu2
    # whisper's plain GELU is the exact one (erf), not the tanh form
    x32 = torch.from_numpy(x)
    np.testing.assert_allclose(
        _np(act_fn("gelu_plain")(x32)),
        _np(jax.nn.gelu(jnp.asarray(x), approximate=False)), atol=1e-6)
    assert not torch.allclose(act_fn("gelu_plain")(x32), act_fn("gelu")(x32))


def test_vlm_family_and_fused_frontend_run_as_dense():
    """chameleon's ``vlm`` family with the ``fused`` frontend builds the
    dense unit structure and takes token ids; ``frames`` and the
    ``audio`` family go together (whisper's encoder-decoder spec) and
    are refused with anything else."""
    cfg = get_reduced("chameleon-34b")
    assert (cfg.family, cfg.frontend) == ("vlm", "fused")
    dense = dataclasses.replace(cfg, family="dense", frontend="tokens")
    assert lm.model_spec(cfg) == lm.model_spec(dense)
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(3, 1, 8, cfg.vocab_size))
    assert torch.equal(lm.forward(params, toks, cfg)[0],
                       lm.forward(params, toks, dense)[0])
    for other in (dataclasses.replace(cfg, frontend="frames"),
                  dataclasses.replace(cfg, family="audio")):
        with pytest.raises(ValueError, match="audio family"):
            lm.model_spec(other)
    whisper = get_reduced("whisper-small")
    assert (whisper.family, whisper.frontend) == ("audio", "frames")
    spec = lm.model_spec(whisper)
    assert {"encoder", "units", "enc_final_norm", "pos_embed"} <= set(spec)
    assert sorted(spec["units"]["pre_cross"]) == ["bias", "scale"]
