"""PyTorch port: the ssm family (xlstm-1.3b) and its mLSTM and sLSTM
blocks against the JAX reference, on the CPU at the reduced
configuration (4 layers: 2 superblocks of one mLSTM and one sLSTM block,
d_model 64, 2 heads), with the reference's own weights carried across by
``params_from_jax``.

JAX runs in-process through ``repro.configs`` and ``repro.models`` only.
Inputs come from ``numpy.random.default_rng`` with fixed seeds.

Tolerances are those of ``tests/test_torch_models.py``: 1e-4 on float32
logits and states with greedy tokens equal, 2e-2 in bfloat16 (decode
teacher-forced on the reference's tokens). The blocks alone run with
their gate biases, norms and conv biases drawn at random (the reference
initialises them to zeros) and sLSTM's recurrent weights at their own
nonzero scale, so that a layout error shows.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import NOT_PORTED, get_config, get_reduced
from repro_torch.models import decode as dec
from repro_torch.models import lm
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.models.common import chunk_len

ARCH = "xlstm-1.3b"
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, GEN = 2, 24, 8
# the reference's n_params() at full size (repro.configs, on the CPU)
N_PARAMS = 2_020_591_952
# reference fields the serving path does not read: training knobs
TRAINING_ONLY = {"adam_dtype", "remat_policy", "scan_group", "train_accum"}


def _cfgs(compute_dtype):
    from repro.configs import get_reduced as jax_reduced
    return (dataclasses.replace(get_reduced(ARCH),
                                compute_dtype=compute_dtype),
            dataclasses.replace(jax_reduced(ARCH),
                                compute_dtype=compute_dtype))


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
    """{(block, leaf): array} of an xlstm cache, ``pos`` aside."""
    return {(k, name): _np(val) for k, sub in cache.items() if k != "pos"
            for name, val in sub.items()}


def _jax_run(jp, jcfg, toks, gen):
    """Reference: forward logits, prefill (logits and states), then
    greedy decode (one jitted step: traced once, not per step)."""
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
    np.testing.assert_allclose(_np(logits), parity["ref"]["forward"],
                               atol=ATOL[parity["dtype"]])


def test_prefill_logits_and_cache_match_reference(parity):
    """Every state leaf: mLSTM's c/n/m (float32) and conv tail, sLSTM's
    c/n/h/m (float32) and conv tail (compute dtype)."""
    cfg = parity["cfg"]
    logits, cache = dec.prefill(parity["params"],
                                torch.from_numpy(parity["toks"]), cfg,
                                max_seq=S + GEN)
    tol = ATOL[parity["dtype"]]
    assert cache["pos"] == S
    np.testing.assert_allclose(_np(logits), parity["ref"]["prefill"],
                               atol=tol)
    mine, want = _leaves(cache), parity["ref"]["cache"]
    assert sorted(mine) == sorted(want) == sorted(
        [("mlstm", k) for k in ("c", "n", "m", "conv")]
        + [("slstm", k) for k in ("c", "n", "h", "m", "conv")])
    inner, heads, dh = xlstm_mod._mdims(cfg)
    assert mine[("mlstm", "c")].shape == (2, 1, B, heads, dh, dh)
    assert mine[("slstm", "conv")].shape == (2, B, 3, cfg.d_model)
    for key, got in mine.items():
        assert got.shape == want[key].shape, key
        np.testing.assert_allclose(got, want[key], atol=tol, err_msg=str(key))
    cdt = getattr(torch, parity["dtype"])
    assert cache["mlstm"]["conv"].dtype == cache["slstm"]["conv"].dtype == cdt
    for block in ("mlstm", "slstm"):
        assert cache[block]["m"].dtype == torch.float32


def test_greedy_decode_matches_reference(parity):
    """GEN decode steps, teacher-forced on the reference's greedy tokens:
    logits within tolerance at every step, and the states after the last
    within it scaled to the leaf's largest value where that is above 1
    (sLSTM's normalizer n sums the input gates: about 30 after 32 steps,
    where bfloat16 inputs move it by 2e-2); in float32 the port's own
    argmax gives the same tokens."""
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


# -- the blocks alone

def _blocks(dtype, seed):
    """(cfg, jcfg, {"mlstm", "slstm"}: (the port's weights, the
    reference's)) of the reduced config's first superblock, with the
    zero-initialised biases and norms drawn at random."""
    import jax
    cfg, jcfg = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed))
    rng = np.random.default_rng(seed + 100)

    def randomise(jp, names):
        for name in names:
            jp[name] = (rng.standard_normal(jp[name].shape) * 0.5).astype(
                np.float32)
        return jp

    unit = tree["units"]
    jm = randomise({k: np.array(v[0, 0]) for k, v in unit["mlstm"].items()},
                   ("norm", "conv_b", "b_if", "out_norm"))
    js = randomise({k: np.array(v[0]) for k, v in unit["slstm"].items()
                    if k != "ffn"}, ("norm", "conv_b", "b_gates",
                                     "out_norm"))
    js["ffn"] = {k: np.array(v[0]) for k, v in unit["slstm"]["ffn"].items()}
    assert np.abs(js["r_gates"]).max() > 0

    def torch_tree(t):
        return {k: torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(v) for k, v in t.items()}

    def jax_tree(t):
        return jax.tree.map(jax.numpy.asarray, t)

    return cfg, jcfg, {"mlstm": (torch_tree(jm), jax_tree(jm)),
                       "slstm": (torch_tree(js), jax_tree(js))}


def _check(got, want, dtype, what=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _check(got[k], want[k], dtype, f"{what}/{k}")
        return
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length,chunk", [(16, 16), (40, 8)],
                         ids=["L16", "L40"])
def test_mlstm_matches_reference(length, chunk, dtype):
    """``mlstm`` at L = 16 (one chunk of 16) and 40 (five of 8): output
    and the final c/n/m/conv state equal the reference's."""
    import jax.numpy as jnp
    from repro.models import xlstm as jx
    cfg, jcfg, blocks = _blocks(dtype, seed=3)
    p, jp = blocks["mlstm"]
    assert chunk_len(cfg.xlstm.chunk, length) == chunk
    x = np.random.default_rng(length).standard_normal(
        (2, length, cfg.d_model)).astype(np.float32)
    y, st = xlstm_mod.mlstm(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                            cfg, return_state=True)
    wy, wst = jx.mlstm(jp, jnp.asarray(x).astype(getattr(jnp, dtype)), jcfg,
                       return_state=True)
    _check(y, wy, dtype, "y")
    _check(st, wst, dtype, "state")
    assert st["m"].dtype == torch.float32 and float(st["m"].min()) > -1e29


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_matches_reference(dtype):
    """Four ``mlstm_decode`` steps from the initial state (m at -1e30)
    equal the reference's, states included."""
    import jax.numpy as jnp
    from repro.models import xlstm as jx
    cfg, jcfg, blocks = _blocks(dtype, seed=4)
    p, jp = blocks["mlstm"]
    st = xlstm_mod.mlstm_init_state(cfg, 3)
    st["conv"] = st["conv"].to(getattr(torch, dtype))
    wst = jx.mlstm_init_state(jcfg, 3)
    wst["conv"] = wst["conv"].astype(getattr(jnp, dtype))
    rng = np.random.default_rng(5)
    for step in range(4):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y, st = xlstm_mod.mlstm_decode(
            p, torch.from_numpy(x).to(getattr(torch, dtype)), st, cfg)
        wy, wst = jx.mlstm_decode(
            jp, jnp.asarray(x).astype(getattr(jnp, dtype)), wst, jcfg)
        _check(y, wy, dtype, f"step {step} y")
        _check(st, wst, dtype, f"step {step} state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_matches_reference(dtype):
    """``slstm`` over 20 steps from a random state (the per-head
    recurrent product's layout, the i/f gates from the conv branch and
    z/o from the raw one), output and final c/n/h/m/conv equal the
    reference's."""
    import jax.numpy as jnp
    from repro.models import xlstm as jx
    cfg, jcfg, blocks = _blocks(dtype, seed=6)
    p, jp = blocks["slstm"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    state = {k: rng.standard_normal((2, cfg.d_model)).astype(np.float32)
             for k in ("c", "h", "m")}
    state["n"] = rng.uniform(0.5, 2.0, (2, cfg.d_model)).astype(np.float32)
    y, st = xlstm_mod.slstm(
        p, torch.from_numpy(x).to(getattr(torch, dtype)), cfg,
        state={k: torch.from_numpy(v) for k, v in state.items()},
        return_state=True)
    wy, wst = jx.slstm(jp, jnp.asarray(x).astype(getattr(jnp, dtype)), jcfg,
                       state={k: jnp.asarray(v) for k, v in state.items()},
                       return_state=True)
    _check(y, wy, dtype, "y")
    _check(st, wst, dtype, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_decode_matches_reference(dtype):
    """Four ``slstm_decode`` steps from the initial state (n at 1e-6, m
    at -1e30) equal the reference's, states included."""
    import jax.numpy as jnp
    from repro.models import xlstm as jx
    cfg, jcfg, blocks = _blocks(dtype, seed=8)
    p, jp = blocks["slstm"]
    st = xlstm_mod.slstm_init_state(cfg, 3)
    st["conv"] = st["conv"].to(getattr(torch, dtype))
    wst = jx.slstm_init_state(jcfg, 3)
    wst["conv"] = wst["conv"].astype(getattr(jnp, dtype))
    rng = np.random.default_rng(9)
    for step in range(4):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y, st = xlstm_mod.slstm_decode(
            p, torch.from_numpy(x).to(getattr(torch, dtype)), st, cfg)
        wy, wst = jx.slstm_decode(
            jp, jnp.asarray(x).astype(getattr(jnp, dtype)), wst, jcfg)
        _check(y, wy, dtype, f"step {step} y")
        _check(st, wst, dtype, f"step {step} state")


def test_decode_after_prefill_matches_longer_prefill():
    """The recurrent form against the chunked one: ``decode_step`` after
    ``prefill(L)`` gives the last logits and states of ``prefill(L + 1)``,
    for L = 23 (chunk 1) then 24 (chunk 8), and L = 31 (chunk 1) then 32
    (chunk 16), in float32."""
    cfg = dataclasses.replace(get_reduced(ARCH), compute_dtype="float32")
    params = lm.init_params(cfg, seed=6, device="cpu")
    toks = torch.from_numpy(_tokens(7, 2, 32, cfg.vocab_size)).long()
    for length in (23, 31):
        _, cache = dec.prefill(params, toks[:, :length], cfg)
        got, cache = dec.decode_step(params, cache,
                                     toks[:, length:length + 1], cfg)
        want, ref_cache = dec.prefill(params, toks[:, :length + 1], cfg)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"])
        for key, leaf in _leaves(ref_cache).items():
            np.testing.assert_allclose(_leaves(cache)[key], leaf,
                                       atol=ATOL["float32"], err_msg=str(key))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(dtype):
    """``init_cache`` leaf for leaf as the reference's: keys, shapes,
    dtypes (states float32 whatever the compute dtype, conv tails in it)
    and start values (mLSTM's and sLSTM's m at -1e30, sLSTM's n at
    1e-6, the rest zeros)."""
    from repro.models import lm as jlm
    cfg, jcfg = _cfgs(dtype)
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
    assert float(mine["slstm"]["n"].min()) == np.float32(1e-6)
    assert float(mine["mlstm"]["m"].max()) == np.float32(-1e30)


# -- config, counts, trees

def test_config_and_param_count_match_reference():
    """Every field of the port's xlstm config (and its reduced form)
    equals the reference's, ``xlstm`` field for field; every reference
    field the port lacks is at the reference's default, training knobs
    aside; the parameter counts are equal, at full size the reference's
    2,020,591,952; the derived properties agree."""
    from repro.common.config import ModelConfig as RefConfig
    from repro.common.config import XLSTMConfig as RefXLSTM
    from repro.configs import get_config as jax_config
    from repro.configs import get_reduced as jax_reduced
    from repro.models import lm as jlm
    from repro_torch.common.config import XLSTMConfig
    assert dataclasses.asdict(XLSTMConfig()) == dataclasses.asdict(RefXLSTM())
    ported = {f.name for f in dataclasses.fields(type(get_config(ARCH)))}
    defaults = {f.name: f.default for f in dataclasses.fields(RefConfig)
                if f.default is not dataclasses.MISSING}
    for mine, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_reduced(ARCH), jax_reduced(ARCH))):
        plain = ported - {"ssm", "xlstm", "moe", "mla"}
        assert {n: getattr(mine, n) for n in plain} == {
            n: getattr(ref, n) for n in plain}
        assert dataclasses.asdict(mine.xlstm) == dataclasses.asdict(ref.xlstm)
        assert mine.ssm is None and ref.ssm is None
        assert {n: getattr(ref, n) for n in defaults
                if n not in ported | TRAINING_ONLY} == {
            n: v for n, v in defaults.items()
            if n not in ported | TRAINING_ONLY}
        assert mine.n_params() == jlm.count_params(ref)
        assert (mine.is_attention_free, mine.supports_long_context) == (
            ref.is_attention_free, ref.supports_long_context) == (True, True)
    assert get_config(ARCH).n_params() == N_PARAMS
    assert ARCH not in NOT_PORTED


def test_params_from_jax_takes_the_xlstm_tree():
    """The reference's tree goes across leaf for leaf: the superblock's
    nested ``mlstm`` stack (superblocks, inner layers) and its
    ``slstm`` block with the nested ``ffn``; a tree missing one nested
    leaf is refused."""
    import jax
    cfg, jcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray, _jax_params(jcfg, seed=1))
    params = params_from_jax(tree, cfg, "cpu")
    unit = params["units"]
    inner, heads, dh = xlstm_mod._mdims(cfg)
    assert tuple(unit["mlstm"]["wq"].shape) == (2, 1, heads, dh, dh)
    assert sorted(unit["slstm"]["ffn"]) == ["w_gate", "w_in", "w_out"]
    np.testing.assert_array_equal(unit["slstm"]["r_gates"].numpy(),
                                  tree["units"]["slstm"]["r_gates"])
    ffn = {k: v for k, v in tree["units"]["slstm"]["ffn"].items()
           if k != "w_gate"}
    cut = dict(tree, units=dict(tree["units"],
                                slstm=dict(tree["units"]["slstm"], ffn=ffn)))
    with pytest.raises(ValueError, match="missing leaves \\['w_gate'\\]"):
        params_from_jax(cut, cfg, "cpu")


def test_ssm_family_needs_its_fields():
    with pytest.raises(ValueError, match="ssm family needs cfg.xlstm"):
        lm.model_spec(dataclasses.replace(get_reduced(ARCH), xlstm=None))


def test_stabilizers_keep_extreme_gates_finite():
    """Input gates far past exp's range (|i| ~ 200) through the chunked
    and the recurrent mLSTM: the carried running max keeps every value
    finite, and the two forms agree."""
    cfg = dataclasses.replace(get_reduced(ARCH), compute_dtype="float32")
    params = lm.init_params(cfg, seed=10, device="cpu")
    p = lm.unit(lm.unit(params["units"], 0)["mlstm"], 0)
    p = dict(p, b_if=torch.cat([torch.tensor([200.0, -200.0]),
                                torch.tensor([4.0, -4.0])]))
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    y, st = xlstm_mod.mlstm(p, x, cfg, return_state=True)
    assert bool(torch.isfinite(y).all())
    dst = xlstm_mod.mlstm_init_state(cfg, 1)
    for t in range(16):
        yt, dst = xlstm_mod.mlstm_decode(p, x[:, t:t + 1], dst, cfg)
        np.testing.assert_allclose(_np(yt[:, 0]), _np(y[:, t]), atol=1e-4)
    for k in ("c", "n", "m"):
        np.testing.assert_allclose(_np(dst[k]), _np(st[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
