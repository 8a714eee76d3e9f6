"""PyTorch port: whisper-small (the audio encoder-decoder family) against
the JAX reference, on the CPU at its reduced configuration (2 encoder and
2 decoder layers, d_model 64, 32 frames), and at a variant with 300
frames and a 130-token prompt (the encoder's keys pad to 384, and the
decoder's prompt crosses a 128-row tile), with the reference's own
weights carried across by ``params_from_jax``. Frames and prompts come
from ``numpy.random.default_rng`` with fixed seeds and go to both
packages as the same numbers.

What whisper brings: LayerNorm (``scale`` and ``bias``), the exact GELU
in an ungated MLP, sinusoidal encoder positions and learned decoder
ones, no rope, the encoder's non-causal self-attention and the decoder's
cross attention (the flash-attention kernel's non-causal form, which
masks a ragged key count), and the cross-attention cache.

JAX runs in-process through ``repro.configs`` and ``repro.models`` only:
neither needs 64-bit mode or sets anything at import.

Tolerances are those of ``tests/test_torch_models.py``: 1e-4 on float32
logits and caches (two summation orders; measured differences are near
3e-7) with greedy tokens equal, 2e-2 in bfloat16 (the reference suite's
own bound; the packages round activations at different places, so
bfloat16 decode is teacher-forced on the reference's tokens).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import NOT_PORTED, get_config, get_reduced
from repro_torch.models import attention as attn_mod
from repro_torch.models import decode as dec
from repro_torch.models import lm
from repro_torch.models.common import (act_fn, apply_norm, gelu_plain,
                                       layernorm, norm_spec, sinusoid_pos)
from repro_torch.models.convert import params_from_jax

ARCH = "whisper-small"
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
GEN = 8
# (encoder frames, prompt length): the stock reduced config, and 300
# frames (not a multiple of 128) with a prompt past one 128-row tile
VARIANTS = {"stock": (32, 12), "t300": (300, 130)}
B = 2
# the reference's n_params() at full size (repro.configs, on the CPU)
N_PARAMS = 303_264_768
# reference fields the serving path does not read: training knobs
TRAINING_ONLY = {"adam_dtype", "remat_policy", "scan_group", "train_accum"}


def _cfgs(compute_dtype, encoder_seq=None):
    from repro.configs import get_reduced as jax_reduced
    over = {"compute_dtype": compute_dtype}
    if encoder_seq is not None:
        over["encoder_seq"] = encoder_seq
    return (dataclasses.replace(get_reduced(ARCH), **over),
            dataclasses.replace(jax_reduced(ARCH), **over))


def _np(x):
    return np.asarray(x, np.float32)


def _inputs(seed, b, s, t, cfg):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32),
            rng.standard_normal((b, t, cfg.d_model), dtype=np.float32))


def _tree(jcfg, seed=0):
    import jax
    from repro.models import lm as jlm
    return jax.tree.map(np.asarray, jlm.init_params(jcfg,
                                                    jax.random.PRNGKey(seed)))


def _jax_run(tree, jcfg, toks, frames, gen):
    """Reference: forward logits, prefill (logits and every cache leaf),
    then greedy decode."""
    import jax.numpy as jnp
    from repro.models import decode as jdec
    from repro.models import lm as jlm
    fr = jnp.asarray(frames)
    out = {"forward": _np(jlm.forward(tree, jnp.asarray(toks), jcfg,
                                      frames=fr)[0])}
    logits, cache = jdec.prefill(tree, jnp.asarray(toks), jcfg,
                                 max_seq=toks.shape[1] + gen, frames=fr)
    out["prefill"] = _np(logits)
    out["cache"] = {(key, n): _np(cache[key][n])
                    for key in ("units", "cross") for n in "kv"}
    out["pos"] = int(cache["pos"])
    tokens, steps = [], []
    tok = jnp.argmax(logits, -1)[:, None]
    for _ in range(gen):
        tokens.append(np.asarray(tok))
        logits, cache = jdec.decode_step(tree, cache, tok, jcfg)
        steps.append(_np(logits))
        tok = jnp.argmax(logits, -1)[:, None]
    out["tokens"] = np.concatenate(tokens, axis=1)
    out["decode"] = steps
    return out


@pytest.fixture(scope="module", params=[
    (v, d) for v in VARIANTS for d in ("float32", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def parity(request):
    """Both packages on the same weights, frames and prompts: one
    variant, one compute dtype."""
    variant, dtype = request.param
    t, s = VARIANTS[variant]
    cfg, jcfg = _cfgs(dtype, t)
    tree = _tree(jcfg)
    toks, frames = _inputs(1, B, s, t, cfg)
    return {"dtype": dtype, "cfg": cfg, "s": s,
            "params": params_from_jax(tree, cfg, "cpu"), "toks": toks,
            "frames": frames, "ref": _jax_run(tree, jcfg, toks, frames, GEN)}


def _prefill(run):
    return dec.prefill(run["params"], torch.from_numpy(run["toks"]),
                       run["cfg"], max_seq=run["s"] + GEN,
                       frames=torch.from_numpy(run["frames"]))


def test_forward_matches_reference(parity):
    cfg = parity["cfg"]
    logits, aux = lm.forward(parity["params"],
                             torch.from_numpy(parity["toks"]), cfg,
                             frames=torch.from_numpy(parity["frames"]))
    assert logits.shape == (B, parity["s"], cfg.padded_vocab)
    assert logits.dtype == getattr(torch, parity["dtype"])
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits.float()), parity["ref"]["forward"],
                               atol=ATOL[parity["dtype"]])


def test_prefill_logits_and_every_cache_leaf_match_reference(parity):
    """Prefill's last logits, the decoder's k/v (padded to max_seq) and
    the cross attention's k/v over the encoder output, leaf for leaf."""
    cfg, ref = parity["cfg"], parity["ref"]
    logits, cache = _prefill(parity)
    tol = ATOL[parity["dtype"]]
    assert cache["pos"] == ref["pos"] == parity["s"]
    assert sorted(cache) == ["cross", "pos", "units"]
    np.testing.assert_allclose(_np(logits.float()), ref["prefill"], atol=tol)
    rows = {"units": parity["s"] + GEN, "cross": cfg.encoder_seq}
    for (key, n), want in ref["cache"].items():
        got = cache[key][n]
        assert got.dtype == getattr(torch, parity["dtype"])
        assert tuple(got.shape) == want.shape == (
            cfg.n_layers, B, rows[key], cfg.n_kv_heads, cfg.head_dim_)
        np.testing.assert_allclose(_np(got.float()), want, atol=tol,
                                   err_msg=f"{key}/{n}")


def test_greedy_decode_matches_reference(parity):
    """GEN decode steps, teacher-forced on the reference's greedy tokens:
    logits within tolerance at every step and the cross cache unchanged;
    in float32 the port's own argmax gives the same tokens."""
    cfg, ref = parity["cfg"], parity["ref"]
    logits, cache = _prefill(parity)
    cross = {n: cache["cross"][n].clone() for n in "kv"}
    mine = [logits.argmax(-1)]
    for step in range(GEN):
        tok = torch.from_numpy(ref["tokens"][:, step:step + 1]).long()
        logits, cache = dec.decode_step(parity["params"], cache, tok, cfg)
        assert cache["pos"] == parity["s"] + step + 1
        np.testing.assert_allclose(_np(logits.float()), ref["decode"][step],
                                   atol=ATOL[parity["dtype"]])
        mine.append(logits.argmax(-1))
    for n in "kv":
        assert torch.equal(cache["cross"][n], cross[n])
    if parity["dtype"] == "float32":
        np.testing.assert_array_equal(
            torch.stack(mine[:GEN], dim=1).numpy(), ref["tokens"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_after_prefill_matches_longer_prefill(variant):
    """float32: ``decode_step`` after ``prefill(L)`` gives
    ``prefill(L + 1)``'s last logits: the decoder's cached k/v and the
    cross cache serve one token as the full-sequence path does."""
    t, s = VARIANTS[variant]
    cfg, jcfg = _cfgs("float32", t)
    params = params_from_jax(_tree(jcfg, seed=3), cfg, "cpu")
    toks, frames = (torch.from_numpy(x) for x in _inputs(4, B, s, t, cfg))
    _, cache = dec.prefill(params, toks[:, :-1], cfg, max_seq=s,
                           frames=frames)
    got, _ = dec.decode_step(params, cache, toks[:, -1:].long(), cfg)
    want, _ = dec.prefill(params, toks, cfg, frames=frames)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=ATOL["float32"])


# -- primitives alone

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """``layernorm`` equals the reference's (population variance, float32
    inside, ``weight * x + bias``) with nonzero weights and bias, and
    ``apply_norm`` takes it for a norm that holds a ``bias``."""
    import jax.numpy as jnp
    from repro.models.common import layernorm as jax_layernorm
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 64), dtype=np.float32) * 3 + 1
    w = rng.standard_normal(64, dtype=np.float32)
    b = rng.standard_normal(64, dtype=np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                    torch.from_numpy(b), 1e-5)
    assert got.dtype == tdt
    want = jax_layernorm(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                         jnp.asarray(b), 1e-5)
    np.testing.assert_allclose(_np(got.float()), _np(want),
                               atol={"float32": 1e-5, "bfloat16": 2e-2}[dtype])
    cfg = get_reduced(ARCH)
    p = {"scale": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    assert torch.equal(apply_norm(p, torch.from_numpy(x), cfg),
                       layernorm(torch.from_numpy(x), p["scale"], p["bias"],
                                 cfg.norm_eps))
    assert sorted(norm_spec(64, "ln")) == ["bias", "scale"]
    assert (norm_spec(64, "ln")["scale"].init,
            norm_spec(64, "ln")["bias"].init) == ("ones", "zeros")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_plain_is_the_exact_gelu(dtype):
    """``gelu_plain`` equals ``jax.nn.gelu(approximate=False)`` in the
    input's dtype (float32 to 1e-6; bfloat16 within the bfloat16
    tolerance, since the reference rounds each step in bfloat16 and the
    port once, so the port is also within one bfloat16 step of the
    float32 GELU of the same inputs), differs from the tanh form, and is
    the activation ``act_fn("gelu_plain")`` returns."""
    import jax
    import jax.numpy as jnp
    x = np.random.default_rng(6).standard_normal(4000, dtype=np.float32) * 4
    got = gelu_plain(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jax.nn.gelu(jx, approximate=False)
    np.testing.assert_allclose(_np(got.float()), _np(want),
                               atol={"float32": 1e-6, "bfloat16": 2e-2}[dtype])
    exact = jax.nn.gelu(jx.astype(jnp.float32), approximate=False)
    np.testing.assert_allclose(_np(got.float()), _np(exact), rtol=2 ** -7,
                               atol=1e-6)
    assert act_fn("gelu_plain") is gelu_plain
    tanh_form = act_fn("gelu")(torch.from_numpy(x))
    assert float((tanh_form - gelu_plain(torch.from_numpy(x))).abs().max()) \
        > 1e-5


@pytest.mark.parametrize("seq,d", [(32, 64), (1500, 768)])
def test_sinusoid_pos_matches_reference(seq, d):
    """``sinusoid_pos`` equals the reference's (float32 angles; at 1,500
    positions an angle's last bit is 1.2e-4, so the sines agree to
    that), and its cast to bfloat16 equals the reference's cast."""
    import jax.numpy as jnp
    from repro.models.common import sinusoid_pos as jax_pos
    got = sinusoid_pos(seq, d)
    assert got.shape == (seq, d) and got.dtype == torch.float32
    want = jax_pos(seq, d)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=3e-4)
    half = np.abs(got.numpy() - _np(want))[:, :d // 2]
    assert half[:2].max() < 1e-6              # small angles: exact to rounding
    np.testing.assert_allclose(
        _np(sinusoid_pos(seq, d, torch.bfloat16).float()),
        _np(jax_pos(seq, d, jnp.bfloat16)), atol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t", [(12, 32), (130, 300), (1, 300)])
def test_bidir_and_cross_attention_match_reference(dtype, s, t):
    """``attention(mode="bidir")`` (self, every key) and with ``kv_x`` (k
    and v from the encoder output, returned by ``return_kv``) equal the
    reference's, at key counts that are and are not multiples of 128
    (the port pads them to 128 and masks the padding by the count)."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    cfg, jcfg = _cfgs(dtype)
    tree = _tree(jcfg)
    p = lm.unit(params_from_jax(tree, cfg, "cpu")["units"], 0)
    jp = {k: jnp.asarray(v[0]) for k, v in tree["units"]["cross"].items()}
    rng = np.random.default_rng(s + t)
    x = rng.standard_normal((B, s, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((B, t, cfg.d_model), dtype=np.float32)
    tx, tenc = (torch.from_numpy(a).to(getattr(torch, dtype))
                for a in (x, enc))
    jx, jenc = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, enc))
    tol = ATOL[dtype]
    got = attn_mod.attention(p["cross"], tenc, cfg, mode="bidir")
    want = jattn.attention(jp, jenc, jcfg, mode="bidir")
    np.testing.assert_allclose(_np(got.float()), _np(want), atol=tol)
    got, (k, v) = attn_mod.attention(p["cross"], tx, cfg, mode="bidir",
                                     kv_x=tenc, return_kv=True)
    want, (jk, jv) = jattn.attention(jp, jx, jcfg, mode="bidir", kv_x=jenc,
                                     return_kv=True)
    assert got.shape == (B, s, cfg.d_model)
    assert k.shape == v.shape == (B, t, cfg.n_kv_heads, cfg.head_dim_)
    for mine, ref in ((got, want), (k, jk), (v, jv)):
        np.testing.assert_allclose(_np(mine.float()), _np(ref), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_decode_matches_reference(dtype):
    """``cross_attention_decode`` over a fixed cross cache equals the
    reference's, with a ``query_scale`` set that both ignore."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    cfg, jcfg = _cfgs(dtype)
    cfg = dataclasses.replace(cfg, query_scale=0.7)
    jcfg = dataclasses.replace(jcfg, query_scale=0.7)
    tree = _tree(jcfg)
    p = lm.unit(params_from_jax(tree, cfg, "cpu")["units"], 1)["cross"]
    jp = {k: jnp.asarray(v[1]) for k, v in tree["units"]["cross"].items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    kv = rng.standard_normal((2, B, 300, cfg.n_kv_heads, cfg.head_dim_),
                             dtype=np.float32)
    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    j = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))
    got = attn_mod.cross_attention_decode(p, t(x), t(kv[0]), t(kv[1]), cfg)
    want = jattn.cross_attention_decode(jp, j(x), j(kv[0]), j(kv[1]), jcfg)
    assert got.shape == (B, 1, cfg.d_model)
    np.testing.assert_allclose(_np(got.float()), _np(want), atol=ATOL[dtype])


# -- configuration, parameters, cache, refusals

def test_config_and_param_count_match_reference():
    """Every field of the port's whisper-small config equals the
    reference's (the three encoder-decoder fields included); the port
    lacks no reference field (the four training knobs are ported too);
    the parameter counts are equal, 303,264,768 at full size."""
    from repro.common.config import ModelConfig as RefConfig
    from repro.configs import get_config as jax_config
    from repro.configs import get_reduced as jax_reduced
    from repro.models import lm as jlm
    ported = {f.name for f in dataclasses.fields(type(get_config(ARCH)))}
    assert {"is_encoder_decoder", "n_encoder_layers", "encoder_seq"} <= ported
    refs = {f.name for f in dataclasses.fields(RefConfig)}
    assert refs - ported == set() and TRAINING_ONLY <= ported
    for mine, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_reduced(ARCH), jax_reduced(ARCH))):
        assert {n: getattr(mine, n) for n in ported} == {
            n: getattr(ref, n) for n in ported}
        assert mine.n_params() == jlm.count_params(ref)
    assert get_config(ARCH).n_params() == N_PARAMS
    assert NOT_PORTED == ()


def test_spec_and_init_cache_match_reference():
    """The audio spec's keys and shapes are the reference's (encoder and
    decoder stacks, LayerNorms, ``pos_embed``), and ``init_cache`` has the
    reference's leaves and shapes, ``cross`` of ``encoder_seq`` rows."""
    import jax
    from repro.models import lm as jlm
    from repro_torch.models.params import P
    cfg, jcfg = _cfgs("bfloat16", 300)
    shapes = lambda spec, is_leaf: jax.tree.map(
        lambda p: tuple(p.shape), spec, is_leaf=is_leaf)
    assert shapes(lm.model_spec(cfg), lambda x: isinstance(x, P)) == shapes(
        jlm.model_spec(jcfg), lambda x: hasattr(x, "axes"))
    mine = lm.init_cache(cfg, 3, 40, device="cpu")
    ref = jlm.init_cache(jcfg, 3, 40)
    assert mine["pos"] == int(ref["pos"]) == 0
    for key in ("units", "cross"):
        assert sorted(mine[key]) == sorted(ref[key]) == ["k", "v"]
        for n in "kv":
            assert tuple(mine[key][n].shape) == ref[key][n].shape
            assert mine[key][n].dtype == torch.bfloat16
            assert not mine[key][n].any()
    assert mine["cross"]["k"].shape[2] == 300


def test_params_from_jax_takes_the_audio_tree_and_refuses_a_cut_one():
    """The reference's audio tree goes across leaf for leaf (encoder and
    decoder stacks, each LayerNorm's ``scale`` and ``bias``); a tree
    missing a LayerNorm ``bias`` and one with an extra leaf are
    refused."""
    cfg, jcfg = _cfgs("float32")
    tree = _tree(jcfg)
    params = params_from_jax(tree, cfg, "cpu")
    np.testing.assert_array_equal(
        params["encoder"]["pre_attn"]["bias"].numpy(),
        tree["encoder"]["pre_attn"]["bias"])
    np.testing.assert_array_equal(params["pos_embed"].numpy(),
                                  tree["pos_embed"])
    norm = {"scale": tree["enc_final_norm"]["scale"]}
    with pytest.raises(ValueError, match="missing leaves \\['bias'\\]"):
        params_from_jax(dict(tree, enc_final_norm=norm), cfg, "cpu")
    cross = dict(tree["units"]["pre_cross"])
    del cross["bias"]
    cut = dict(tree, units=dict(tree["units"], pre_cross=cross))
    with pytest.raises(ValueError, match="missing leaves \\['bias'\\]"):
        params_from_jax(cut, cfg, "cpu")
    mlp = dict(tree["encoder"]["mlp"],
               w_gate=np.zeros_like(tree["encoder"]["mlp"]["w_in"]))
    extra = dict(tree, encoder=dict(tree["encoder"], mlp=mlp))
    with pytest.raises(ValueError, match="extra leaves \\['w_gate'\\]"):
        params_from_jax(extra, cfg, "cpu")


def test_frames_are_checked():
    """The audio family needs frames (B, T, d_model) beside its tokens,
    prefill needs ``encoder_seq`` of them (the cross cache's rows), and
    a tokens model takes none; the family and the frontend go
    together."""
    cfg = get_reduced(ARCH)
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((2, 5), dtype=torch.long)
    frames = torch.zeros((2, cfg.encoder_seq, cfg.d_model))
    assert lm.forward(params, toks, cfg, frames)[0].shape == (
        2, 5, cfg.padded_vocab)
    for bad in (None, frames[:1], frames[..., :32]):
        with pytest.raises(ValueError, match="needs frames"):
            lm.forward(params, toks, cfg, bad)
    with pytest.raises(ValueError, match="encoder_seq"):
        dec.prefill(params, toks, cfg, frames=frames[:, :7])
    qwen = get_reduced("qwen2-1.5b")
    with pytest.raises(ValueError, match="audio family's input"):
        lm.forward(lm.init_params(qwen, seed=0, device="cpu"), toks, qwen,
                   frames)
    for other in (dataclasses.replace(cfg, frontend="tokens"),
                  dataclasses.replace(qwen, frontend="frames"),
                  dataclasses.replace(cfg, n_encoder_layers=0)):
        with pytest.raises(ValueError, match="audio family"):
            lm.model_spec(other)
