"""PyTorch port: gemma2 (local/global attention, sliding window, softcaps,
query scale, post-block norms, GeGLU, the embedding scale) against the
JAX reference, on the CPU at the reduced configuration (4 layers in 2
units, d_model 64, window 16), with the reference's own weights carried
across by ``params_from_jax``; and the flash-attention kernel's sliding
window (its plain version against the reference's ``sdpa``, the two CUDA
routes' loops emulated, and on the card the kernel itself).

JAX runs in-process through ``repro.configs``, ``repro.models`` and
``repro.kernels.flash_attention`` only: none of them needs 64-bit mode
or sets anything at import. Inputs come from ``numpy.random.default_rng``
with fixed seeds.

Tolerances are those of ``tests/test_torch_models.py`` and
``tests/test_torch_flash.py``: 1e-4 on float32 logits (two summation
orders; measured differences are far below), 2e-2 in bfloat16 (the
reference suite's own bound; the packages round activations at different
places, so bfloat16 decode is teacher-forced on the reference's tokens),
2e-5 on float32 attention outputs. A prompt of 24 tokens with 8 greedy
tokens puts the last 8 prompt queries and every decode step past the
16-token window.
"""
import collections
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.models import decode as dec
from repro_torch.models import lm
from repro_torch.models.common import act_fn
from repro_torch.models.convert import params_from_jax
from test_torch_flash import (TOL, WGMMA_ROW_RTOL, row_rel_err,
                              simt_emulation, wgmma_emulation)

ARCH = "gemma2-27b"
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, GEN = 2, 24, 8
# the stock reduced config, and one where sqrt(d_model) is not exact in
# bfloat16 (sqrt(72) = 8.485 rounds to 8.5) and query_scale is not
# head_dim^-0.5, so the embedding cast and the query scale both show
VARIANTS = {"stock": {}, "d72": {"d_model": 72, "query_scale": 0.2}}


def _cfgs(compute_dtype, **over):
    from repro.configs import get_reduced as jax_reduced
    return (dataclasses.replace(get_reduced(ARCH),
                                compute_dtype=compute_dtype, **over),
            dataclasses.replace(jax_reduced(ARCH),
                                compute_dtype=compute_dtype, **over))


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
    """Reference: forward logits, prefill (logits and the cache of each
    kind), then greedy decode."""
    import jax.numpy as jnp
    from repro.models import decode as jdec
    from repro.models import lm as jlm
    out = {"forward": _np(jlm.forward(jp, jnp.asarray(toks), jcfg)[0])}
    logits, cache = jdec.prefill(jp, jnp.asarray(toks), jcfg,
                                 max_seq=toks.shape[1] + gen)
    out["prefill"] = _np(logits)
    out["cache"] = {kind: {n: _np(cache["units"][kind][n]) for n in "kv"}
                    for kind in cache["units"]}
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


@pytest.fixture(scope="module", params=[
    (v, d) for v in VARIANTS for d in ("float32", "bfloat16")],
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
    return {"dtype": dtype, "cfg": cfg, "params": params, "toks": toks,
            "ref": _jax_run(jp, jcfg, toks, GEN)}


def test_forward_matches_reference(parity):
    logits, aux = lm.forward(parity["params"],
                             torch.from_numpy(parity["toks"]), parity["cfg"])
    assert logits.shape == (B, S, parity["cfg"].padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits.float()), parity["ref"]["forward"],
                               atol=ATOL[parity["dtype"]])


def test_prefill_logits_and_cache_per_kind_match_reference(parity):
    cfg = parity["cfg"]
    logits, cache = dec.prefill(parity["params"],
                                torch.from_numpy(parity["toks"]), cfg,
                                max_seq=S + GEN)
    tol = ATOL[parity["dtype"]]
    assert cache["pos"] == S
    assert sorted(cache["units"]) == sorted(parity["ref"]["cache"]) == [
        "global", "local"]
    np.testing.assert_allclose(_np(logits.float()), parity["ref"]["prefill"],
                               atol=tol)
    for kind, kv in parity["ref"]["cache"].items():
        for name in "kv":
            got = cache["units"][kind][name]
            assert got.dtype == getattr(torch, parity["dtype"])
            assert tuple(got.shape) == kv[name].shape == (
                cfg.n_layers // 2, B, S + GEN, cfg.n_kv_heads, cfg.head_dim_)
            np.testing.assert_allclose(_np(got.float()), kv[name], atol=tol)


def test_greedy_decode_past_the_window_matches_reference(parity):
    """Eight decode steps past the 16-token window, teacher-forced on the
    reference's greedy tokens: logits within tolerance at every step; in
    float32 the port's own argmax gives the same tokens."""
    cfg, ref = parity["cfg"], parity["ref"]
    assert S > cfg.local_window
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


def test_long_local_prefill_matches_reference_blocked_path():
    """S = 1152: the reference takes its blocked online-softmax path for
    the local layers too (S * T above ``BLOCK_THRESHOLD``); the port's
    padded, windowed flash-attention path agrees, caches included."""
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
    for kind in ("local", "global"):
        np.testing.assert_allclose(_np(cache["units"][kind]["v"]),
                                   _np(jcache["units"][kind]["v"]),
                                   atol=ATOL["float32"])


def test_decode_matches_forward_past_the_window():
    """Teacher-forced decode reproduces the full forward's logits past
    the window (the local layers' decode reads only the window's slice
    of the cache)."""
    cfg = dataclasses.replace(get_reduced(ARCH), compute_dtype="float32")
    params = lm.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(_tokens(2, 1, 40, cfg.vocab_size))
    full, _ = lm.forward(params, toks, cfg)
    _, cache = dec.prefill(params, toks[:, :20], cfg, max_seq=40)
    for t in range(20, 39):
        lg, cache = dec.decode_step(params, cache, toks[:, t:t + 1], cfg)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=ATOL["float32"])


# -- the kernel's window: plain version against the reference's sdpa

def _qkv(seed, b, s, h, kh, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh), dtype=np.float32),
            rng.standard_normal((b, s, kh, dh), dtype=np.float32),
            rng.standard_normal((b, s, kh, dh), dtype=np.float32))


@pytest.mark.parametrize("s,window", [(256, 37), (256, 128), (2048, 300),
                                      (2048, 1024), (2048, 1)],
                         ids=["dense-37", "dense-128", "blocked-300",
                              "blocked-1024", "blocked-1"])
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_mha_ref_window_matches_reference_sdpa(s, window, cap):
    """The windowed plain version equals the reference's local attention
    (``sdpa(kind="local")``): its dense path at S = 256, its blocked path
    at S = 2048 (above ``BLOCK_THRESHOLD``, q chunks of 512 whose kv range
    starts past 0 under the window), softcap on and off, float32."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    b, h, kh, dh = 1, 4, 2, 16
    q, k, v = _qkv(s + window, b, s, h, kh, dh)
    pos = jnp.arange(s)
    assert (s * s > jattn.BLOCK_THRESHOLD) == (s == 2048)
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                      pos, "local", window, 0.3, cap)
    got = mha_ref(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.3,
                  softcap=cap, window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["float32"])
    # and through the public wrapper on the CPU (padding included)
    got = mha(*(torch.from_numpy(x[:, :s - 5]) for x in (q, k, v)),
              scale=0.3, softcap=cap, window=window)
    want = jattn.sdpa(*(jnp.asarray(x[:, :s - 5]) for x in (q, k, v)),
                      pos[:s - 5], pos[:s - 5], "local", window, 0.3, cap)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["float32"])


def test_window_of_at_least_s_is_causal_and_bad_windows_are_refused():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 200, 4, 2, 16))
    causal = mha(q, k, v, scale=0.25, softcap=30.0)
    for w in (200, 201, 4096):
        assert torch.equal(mha(q, k, v, scale=0.25, softcap=30.0, window=w),
                           causal)
    assert not torch.equal(mha(q, k, v, scale=0.25, window=199),
                           mha(q, k, v, scale=0.25))
    with pytest.raises(ValueError, match="negative"):
        mha(q, k, v, scale=0.25, window=-1)
    with pytest.raises(ValueError, match="S <= T"):
        mha(q, k[:, :128], v[:, :128], scale=0.25, window=64)


# -- the two CUDA routes' windowed loops, emulated on the CPU

@pytest.mark.parametrize("window", [1, 63, 64, 100, 300, 4096])
def test_simt_window_loop_matches_plain(window):
    """The CUDA-core route's windowed loop (first tile from the window,
    rows erased by their first kept key) equals the plain version within
    the float32 tolerance, at head dim 32 and at 192 (nemotron's, the
    route's largest); a window of at least S walks and masks as the
    causal loop does, bit for bit."""
    for dh, seed in ((32, window), (192, window + 192)):
        q, k, v = (torch.from_numpy(x) for x in _qkv(seed, 1, 384, 4, 2, dh))
        scale = 0.2 * (32 / dh) ** 0.5
        got = simt_emulation(q, k, v, scale=scale, softcap=50.0,
                             window=window)
        want = mha_ref(q, k, v, scale=scale, softcap=50.0, window=window)
        assert float((got - want).abs().max()) <= TOL["float32"], dh
        if window >= 384:
            assert torch.equal(got, simt_emulation(q, k, v, scale=scale,
                                                   softcap=50.0))


@pytest.mark.parametrize("window", [1, 128, 300, 4096])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_wgmma_window_arithmetic_within_tolerance(window, softcap):
    """The tensor-core route's windowed arithmetic (kv tiles from the
    window's first tile, the diagonal and the window's edge tiles masked,
    P in bfloat16), emulated at S = 640 (five q tiles), stays within the
    bfloat16 tolerance of the plain version; a window of at least S is
    the causal emulation bit for bit."""
    b, s, h, kh, dh = 1, 640, 4, 2, 128
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(16 + window, b, s, h, kh, dh))
    got = wgmma_emulation(q, k, v, scale=dh ** -0.5, softcap=softcap,
                          window=window)
    want = mha_ref(q, k, v, scale=dh ** -0.5, softcap=softcap, window=window)
    assert float((got.float() - want.float()).abs().max()) <= TOL["bfloat16"]
    if window >= s:
        assert torch.equal(got, wgmma_emulation(q, k, v, scale=dh ** -0.5,
                                                softcap=softcap))


def test_launcher_passes_the_window_and_counts_it(monkeypatch):
    """The window goes to both C entry points after the two floats and
    before the stream (``args[10]`` stays dh); launches given a window
    are counted in ``flash_attention.windowed`` beside ``launches`` and
    ``calls`` (whose key keeps its 8 fields, route last); a negative
    window, and a window with S > T, are refused before any launch. No
    kernel is built: ``_entry`` is stubbed, and the CPU tensors pass for
    CUDA ones."""
    asked = []

    def entry(kind):
        def fn(*args):
            asked.append((kind, args[10], args[-4:-1]))
            return 0
        return fn
    monkeypatch.setattr(fk, "_entry", entry)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fk.flash_attention, "launches", 0)
    monkeypatch.setattr(fk.flash_attention, "windowed", 0)
    monkeypatch.setattr(fk.flash_attention, "calls", collections.Counter())
    x = torch.zeros((1, 256, 2, 128), dtype=torch.bfloat16)
    for w in (0, 4096, 1):
        fk.flash_attention(x, x, x, scale=0.5, softcap=50.0, window=w)
        assert asked[-1] == ("wgmma", 128, (0.5, 50.0, w))
    y = torch.zeros((1, 256, 2, 96))
    fk.flash_attention(y, y, y, scale=0.5, window=7)
    assert asked[-1] == ("simt", 96, (0.5, 0.0, 7))
    assert fk.flash_attention.launches == 4
    assert fk.flash_attention.windowed == 3
    assert fk.flash_attention.calls[
        (1, 256, 256, 2, 2, 128, str(torch.bfloat16), "wgmma")] == 3
    rc, o = fk._call("simt", x, x, x, 0.5, 50.0, 300)
    assert rc == 0 and asked[-1] == ("simt", 128, (0.5, 50.0, 300))
    with pytest.raises(ValueError, match="window"):
        fk.flash_attention(x, x, x, scale=0.5, window=-1)
    with pytest.raises(ValueError, match="S <= T"):
        fk.flash_attention(x, x[:, :128], x[:, :128], scale=0.5, window=64)
    assert fk.flash_attention.launches == 4
    assert fk.flash_attention.windowed == 3


# -- configuration, parameters, primitives

# reference fields the serving path does not read: training knobs
TRAINING_ONLY = {"adam_dtype", "remat_policy", "scan_group", "train_accum"}


def test_config_and_param_count_match_reference():
    """Every field of the port's gemma2-27b config (and its reduced form)
    equals the reference's; every reference field the port lacks is at
    the reference's default, training knobs aside; the parameter counts
    are equal, 27,227,128,320 at full size."""
    from repro.common.config import ModelConfig as RefConfig
    from repro.configs import get_config as jax_config
    from repro.configs import get_reduced as jax_reduced
    from repro.models import lm as jlm
    ported = {f.name for f in dataclasses.fields(type(get_config(ARCH)))}
    defaults = {f.name: f.default for f in dataclasses.fields(RefConfig)
                if f.default is not dataclasses.MISSING}
    assert {"attn_pattern", "local_window", "attn_softcap", "final_softcap",
            "query_scale", "post_block_norm"} <= ported
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
    assert get_config(ARCH).n_params() == 27_227_128_320


def test_params_from_jax_takes_the_reference_gemma2_tree():
    """The reference's tree (units keyed ``local`` and ``global``, each
    with post-norms) goes across unchanged, leaf for leaf; a tree
    without a post-norm is refused."""
    import jax
    cfg, jcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed=1))
    params = params_from_jax(tree, cfg, "cpu")
    assert sorted(params["units"]) == ["global", "local"]
    for kind in ("local", "global"):
        blk = params["units"][kind]
        assert sorted(blk) == ["attn", "mlp", "post_attn", "post_mlp",
                               "pre_attn", "pre_mlp"]
        assert tuple(blk["mlp"]["w_in"].shape) == (2, 64, 128)
        np.testing.assert_array_equal(blk["attn"]["wq"].numpy(),
                                      tree["units"][kind]["attn"]["wq"])
    local = dict(tree["units"]["local"])
    del local["post_mlp"]
    with pytest.raises(ValueError, match="missing leaves \\['post_mlp'\\]"):
        params_from_jax(dict(tree, units=dict(tree["units"], local=local)),
                        cfg, "cpu")


def test_embedding_scale_is_cast_to_the_compute_dtype_first():
    """gemma2 scales the embedding by sqrt(d_model) cast to the compute
    dtype before the multiply: 68.0, not 67.882, in bfloat16 at full
    width (the reference's ``jnp.asarray(d ** 0.5, cdt)``)."""
    import jax.numpy as jnp
    cfg = get_config(ARCH)
    table = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, cfg.d_model), dtype=np.float32))
    toks = torch.tensor([[1, 5, 7]])
    got = lm.embed({"embed": table}, toks, cfg)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, table[toks].bfloat16() * torch.tensor(
        68.0, dtype=torch.bfloat16))
    want = jnp.asarray(table.numpy())[np.asarray(toks)].astype(
        jnp.bfloat16) * jnp.asarray(cfg.d_model ** 0.5, jnp.bfloat16)
    np.testing.assert_array_equal(_np(got.float()), _np(want))
    qwen = lm.embed({"embed": table[:, :64]}, toks, get_reduced("qwen2-1.5b"))
    assert torch.equal(qwen, table[toks, :64].bfloat16())


def test_gelu_is_the_reference_tanh_form():
    import jax
    import jax.numpy as jnp
    x = np.random.default_rng(4).standard_normal(1000, dtype=np.float32) * 4
    got = act_fn("gelu")(torch.from_numpy(x))
    want = jax.nn.gelu(jnp.asarray(x), approximate=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


# -- on the card (skipped without one)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is built with nvcc for "
                    "sm_90a and runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 128, 300, 4096])
@pytest.mark.parametrize("b,s,h,kh,dh,cap,dtype", [
    (1, 5120, 4, 2, 128, 50.0, "bfloat16"),     # wgmma
    (2, 1024, 4, 2, 64, 0.0, "bfloat16"),       # wgmma, dh 64
    (1, 5120, 4, 2, 128, 50.0, "float32"),      # simt
    (2, 1024, 4, 2, 64, 0.0, "float32")])       # simt
def test_windowed_kernel_matches_plain_on_card(cuda, b, s, h, kh, dh, cap,
                                               dtype, window):
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype)).to(cuda)
               for x in _qkv(s + window, b, s, h, kh, dh))
    before = (fk.flash_attention.launches, fk.flash_attention.windowed)
    got = mha(q, k, v, scale=dh ** -0.5, softcap=cap, window=window)
    torch.cuda.synchronize()
    assert (fk.flash_attention.launches,
            fk.flash_attention.windowed) == (before[0] + 1, before[1] + 1)
    want = mha_ref(q, k, v, scale=dh ** -0.5, softcap=cap, window=window)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
    if fk.route(q.dtype, dh) == "wgmma":
        same = wgmma_emulation(q, k, v, scale=dh ** -0.5, softcap=cap,
                               window=window)
        assert row_rel_err(got, same) <= WGMMA_ROW_RTOL
    if window >= s:
        assert torch.equal(got, mha(q, k, v, scale=dh ** -0.5, softcap=cap))
