"""PyTorch port: the dense LM serving path (qwen2-1.5b) against the JAX
reference, on the CPU at the reduced configuration (2 layers, d_model
64), with the reference's own weights carried across by
``params_from_jax``.

JAX runs in-process through ``repro.configs``, ``repro.models`` and
``repro.kernels.flash_attention`` only: none of them needs 64-bit mode
or sets anything at import. Tokens come from
``numpy.random.default_rng`` with fixed seeds.

Tolerances:
- float32 compute: 1e-4 absolute on logits of magnitude ~1. The two
  packages sum in different orders (XLA's dots and scan against torch's
  matmuls and the flash kernel's plain version); measured differences are
  below 1e-6, and 1e-4 leaves room for other BLAS builds. Greedy tokens
  must be equal.
- bfloat16 compute: 2e-2, the reference suite's own bound for bfloat16
  logits (``tests/test_models.py``); the packages round activations to
  bfloat16 at different places (the reference's dense attention rounds
  its softmax weights, the port's attention keeps them in float32).
  Decode is teacher-forced on the reference's greedy tokens, since a
  bfloat16 tie may pick another token.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import attention as attn_mod
from repro_torch.models import decode as dec
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax

ARCH = "qwen2-1.5b"
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, GEN = 2, 24, 8


def _cfgs(compute_dtype):
    from repro.configs import get_reduced as jax_reduced
    return (dataclasses.replace(get_reduced(ARCH), compute_dtype=compute_dtype),
            dataclasses.replace(jax_reduced(ARCH), compute_dtype=compute_dtype))


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
    """Reference: forward logits, prefill, then greedy decode; returns
    every logits array, the greedy tokens and the prefill cache."""
    import jax.numpy as jnp
    from repro.models import decode as jdec
    from repro.models import lm as jlm
    out = {"forward": _np(jlm.forward(jp, jnp.asarray(toks), jcfg)[0])}
    logits, cache = jdec.prefill(jp, jnp.asarray(toks), jcfg,
                                 max_seq=toks.shape[1] + gen)
    out["prefill"] = _np(logits)
    out["cache_k"] = _np(cache["units"]["blk"]["k"])
    out["cache_v"] = _np(cache["units"]["blk"]["v"])
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


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def parity(request):
    """Both packages on the same weights and prompts, one compute dtype."""
    import jax
    dtype = request.param
    cfg, jcfg = _cfgs(dtype)
    jp = _jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(0, B, S, cfg.vocab_size)
    return {"dtype": dtype, "cfg": cfg, "params": params, "toks": toks,
            "ref": _jax_run(jp, jcfg, toks, GEN)}


def test_forward_matches_reference(parity):
    logits, aux = lm.forward(parity["params"],
                             torch.from_numpy(parity["toks"]), parity["cfg"])
    assert logits.shape == (B, S, parity["cfg"].padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits.float()), parity["ref"]["forward"],
                               atol=ATOL[parity["dtype"]])


def test_prefill_logits_and_cache_match_reference(parity):
    cfg = parity["cfg"]
    logits, cache = dec.prefill(parity["params"],
                                torch.from_numpy(parity["toks"]), cfg,
                                max_seq=S + GEN)
    tol = ATOL[parity["dtype"]]
    assert cache["pos"] == S
    assert cache["units"]["blk"]["k"].dtype == getattr(torch, parity["dtype"])
    np.testing.assert_allclose(_np(logits.float()), parity["ref"]["prefill"],
                               atol=tol)
    for name in ("k", "v"):
        got = _np(cache["units"]["blk"][name].float())
        assert got.shape == parity["ref"][f"cache_{name}"].shape
        np.testing.assert_allclose(got, parity["ref"][f"cache_{name}"],
                                   atol=tol)


def test_greedy_decode_matches_reference(parity):
    """Eight decode steps, teacher-forced on the reference's greedy
    tokens: logits within tolerance at every step; in float32 the port's
    own argmax gives the same tokens."""
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


def test_long_prefill_matches_reference_blocked_path():
    """S = 1152: the reference takes its blocked online-softmax path
    (S * T above ``BLOCK_THRESHOLD``), the Pallas kernel's XLA twin; the
    port's padded flash-attention path agrees."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro.models import decode as jdec
    s = 1152
    assert s * s > jattn.BLOCK_THRESHOLD
    cfg, jcfg = _cfgs("float32")
    jp = _jax_params(jcfg, seed=3)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(5, 1, s, cfg.vocab_size)
    want, jcache = jdec.prefill(jp, jnp.asarray(toks), jcfg)
    got, cache = dec.prefill(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"])
    np.testing.assert_allclose(_np(cache["units"]["blk"]["v"]),
                               _np(jcache["units"]["blk"]["v"]),
                               atol=ATOL["float32"])


def test_decode_matches_forward():
    """Teacher-forced decode reproduces the full forward's logits (cache
    correctness), as the reference suite checks for itself."""
    cfg = get_reduced(ARCH)
    params = lm.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(_tokens(2, 1, 16, cfg.vocab_size))
    full, _ = lm.forward(params, toks, cfg)
    _, cache = dec.prefill(params, toks[:, :8], cfg, max_seq=16)
    errs = []
    for t in range(8, 15):
        lg, cache = dec.decode_step(params, cache, toks[:, t:t + 1], cfg)
        errs.append(float((lg.float() - full[:, t].float()).abs().max()))
    assert max(errs) < 2e-2, errs


# reference fields the serving path does not read: training knobs
TRAINING_ONLY = {"adam_dtype", "remat_policy", "scan_group", "train_accum"}


def test_config_and_param_count_match_reference():
    """Every field of the port's qwen2-1.5b config equals the
    reference's; every reference field the port lacks is at the
    reference's default (so nothing the reference sets is dropped),
    training knobs aside; the parameter counts (the port's from its own
    spec, shapes only) are equal."""
    from repro.common.config import ModelConfig as RefConfig
    from repro.configs import get_config as jax_config
    from repro.configs import get_reduced as jax_reduced
    from repro.models import lm as jlm
    ported = {f.name for f in dataclasses.fields(type(get_config(ARCH)))}
    defaults = {f.name: f.default for f in dataclasses.fields(RefConfig)
                if f.default is not dataclasses.MISSING}
    for mine, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_reduced(ARCH), jax_reduced(ARCH))):
        assert {n: getattr(mine, n) for n in ported} == {
            n: getattr(ref, n) for n in ported}
        assert {n: getattr(ref, n) for n in defaults
                if n not in ported | TRAINING_ONLY} == {
            n: v for n, v in defaults.items()
            if n not in ported | TRAINING_ONLY}
        assert mine.n_params() == jlm.count_params(ref)
        assert mine.padded_vocab == ref.padded_vocab
    assert get_config(ARCH).n_params() == 1_543_714_304


def test_unported_architectures_and_paths_raise():
    """whisper-small, the reference's last architecture, is ported: its
    config builds, and so do qwen2's blocks with its plain GELU, and the
    bidirectional and cross attention of its encoder-decoder run. What
    raises is what the reference lacks or no configuration passes: an
    unknown architecture, the audio family or the ``frames`` frontend
    without the other, and attention with custom positions."""
    from repro_torch.configs import NOT_PORTED
    assert NOT_PORTED == ()
    assert get_config("whisper-small").family == "audio"
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-2")
    cfg = get_reduced(ARCH)
    for other in (dataclasses.replace(cfg, family="audio"),
                  dataclasses.replace(cfg, frontend="frames")):
        with pytest.raises(ValueError, match="audio family"):
            lm.model_spec(other)
    assert lm.model_spec(dataclasses.replace(cfg, act="gelu_plain")) == \
        lm.model_spec(cfg)
    params = lm.init_params(cfg, seed=0, device="cpu")
    p = lm.unit(params["units"], 0)["blk"]["attn"]
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    enc = torch.randn((1, 6, cfg.d_model), generator=torch.Generator()
                      .manual_seed(1))
    causal = attn_mod.attention(p, x, cfg)
    bidir = attn_mod.attention(p, x, cfg, mode="bidir")
    assert bidir.shape == causal.shape == x.shape
    assert not torch.allclose(bidir, causal)
    torch.testing.assert_close(bidir[:, -1], causal[:, -1])
    assert attn_mod.attention(p, x, cfg, kv_x=enc,
                              mode="bidir").shape == x.shape
    for kw in ({"positions": torch.arange(4)},
               {"kv_positions": torch.arange(4)}):
        with pytest.raises(NotImplementedError, match="positions"):
            attn_mod.attention(p, x, cfg, **kw)


def test_init_params_keeps_the_reference_scheme():
    """Keys and shapes of the reference tree; norms and biases zero;
    weights normal with std 0.02; float32; reproducible from the seed."""
    import jax
    from repro.models import lm as jlm
    cfg, jcfg = _cfgs("bfloat16")
    params = lm.init_params(cfg, seed=0, device="cpu")
    ref = jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    mine = {path: t for path, t in _flat(params)}
    assert {p: tuple(t.shape) for p, t in mine.items()} == {
        p: tuple(t.shape) for p, t in _flat(ref)}
    assert all(t.dtype == torch.float32 for t in mine.values())
    assert not mine["units/blk/pre_attn/scale"].any()
    assert not mine["units/blk/attn/bq"].any()
    std = float(mine["units/blk/mlp/w_in"].std())
    assert abs(std - 0.02) < 2e-3
    again = lm.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], params["embed"])
    assert not torch.equal(lm.init_params(cfg, seed=1, device="cpu")["embed"],
                           params["embed"])


def _flat(tree, prefix=""):
    for k in sorted(tree):
        path = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], path + "/")
        else:
            yield path, tree[k]


def test_entry_points_default_to_cuda():
    """Without a card, ``init_params`` and ``init_cache`` not told to use
    the CPU raise; ``device="cpu"`` works."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(cfg, 1, 8)
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    assert cache["units"]["blk"]["k"].shape == (cfg.n_layers, 1, 8,
                                                cfg.n_kv_heads, cfg.head_dim_)


def test_params_from_jax_refuses_a_tree_that_does_not_fit():
    import jax
    cfg, jcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray, _jax_params(jcfg))
    missing = dict(tree, units={"blk": dict(tree["units"]["blk"])})
    del missing["units"]["blk"]["pre_mlp"]
    with pytest.raises(ValueError, match="missing leaves \\['pre_mlp'\\]"):
        params_from_jax(missing, cfg, "cpu")
    extra = dict(tree, lm_head=np.zeros((cfg.d_model, cfg.padded_vocab)))
    with pytest.raises(ValueError, match="extra leaves \\['lm_head'\\]"):
        params_from_jax(extra, cfg, "cpu")
    wrong = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="/embed: shape"):
        params_from_jax(wrong, cfg, "cpu")


# -- on the card (skipped without one)

@pytest.mark.cuda
def test_full_width_greedy_on_card():
    """qwen2-1.5b at full width on the card: one prefill goes through
    the kernel once per layer, and greedy decoding gives finite logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel runs "
                    "only on the card")
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    cfg = get_config(ARCH)
    params = lm.init_params(cfg, seed=0)
    toks = torch.from_numpy(_tokens(0, 2, 300, cfg.vocab_size)).cuda()
    before = flash_attention.launches
    logits, cache = dec.prefill(params, toks, cfg, max_seq=304)
    assert flash_attention.launches == before + cfg.n_layers
    for _ in range(4):
        logits, cache = dec.decode_step(params, cache,
                                        logits.argmax(-1, keepdim=True), cfg)
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert cache["pos"] == 304
