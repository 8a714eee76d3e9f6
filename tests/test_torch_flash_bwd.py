"""PyTorch port: the flash-attention backward and the forward's row
log-sum-exp.

``attention_bwd_ref`` (the plain version of the CUDA backward,
``fa_bwd.cuh``) is held to ``torch.autograd`` through ``mha_ref`` and to
``jax.grad`` of the reference's attention (``repro.models.attention.sdpa``:
its dense path, and its blocked path above ``BLOCK_THRESHOLD``, the one
that jax.checkpoints each q chunk), at the masks the kernel serves:
causal, sliding windows, a softcap, the non-causal form with a key count,
GQA groups, dqk 192 beside dv 128, and a length that is not a multiple
of 128. ``mha``'s autograd path (``_Attention``) is held to autograd
through ``mha_ref`` on the CPU, padding included; the launchers' argument
order is checked with the C entry points stubbed. The kernels themselves
are held to the plain versions on the card by the ``cuda``-marked tests
(skipped without one) and by ``chip_smoke.py`` phase 18. Inputs come from
``numpy.random.default_rng``.

Tolerances: float32 gradients within 1e-5 of the largest magnitude of the
gradient compared (float32 sums in two orders over up to 1,152 keys); on
the card 1e-4 in float32 and 2e-2 in bfloat16 (``FA_BWD_TOL``).
"""
import collections
import contextlib
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import (NEG, attention_bwd_ref,
                                                     attention_ref, mha_ref)

GRAD_TOL = 1e-5
FA_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (b, s, t, h, kh, dqk, dv, causal, window, softcap, kv_len)
CASES = [
    (2, 64, 64, 4, 2, 16, 16, True, 0, 0.0, None),        # causal, GQA 2
    (1, 64, 64, 4, 4, 16, 16, True, 1, 0.0, None),        # window 1
    (1, 200, 200, 2, 1, 16, 16, True, 128, 0.0, None),    # window 128, MQA
    (1, 320, 320, 2, 2, 16, 16, True, 300, 30.0, None),   # window 300
    (2, 96, 96, 8, 1, 16, 16, True, 0, 50.0, None),       # softcap, GQA 8
    (1, 64, 160, 4, 2, 16, 16, False, 0, 0.0, 1),         # kv_len 1
    (1, 64, 160, 4, 2, 16, 16, False, 0, 0.0, 64),
    (1, 64, 160, 4, 2, 16, 16, False, 0, 0.0, 130),
    (2, 48, 160, 4, 2, 16, 16, False, 0, 0.0, 160),       # kv_len = T
    (1, 130, 130, 4, 4, 24, 16, True, 0, 0.0, None),      # dqk 24 / dv 16
    (1, 200, 200, 8, 8, 192, 128, True, 0, 0.0, None),    # MLA's 192 / 128
]
IDS = [f"S{c[1]}T{c[2]}H{c[3]}K{c[4]}d{c[5]}-{c[6]}"
       f"{'c' if c[7] else 'n'}w{c[8]}cap{c[9]:g}kv{c[10]}" for c in CASES]


def _inputs(seed, b, s, t, h, kh, dqk, dv):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((b, s, h, dqk), (b, t, kh, dqk),
                               (b, t, kh, dv), (b, s, h, dv)))


def _mask(causal, window, softcap, kv_len, dqk):
    return {"scale": dqk ** -0.5, "softcap": softcap, "window": window,
            "causal": causal, "kv_len": kv_len}


def _close(got, want, tol=GRAD_TOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_autograd_through_mha_ref(case):
    """``attention_bwd_ref`` from the forward's o and lse equals
    ``torch.autograd`` through ``mha_ref``; keys at or past ``kv_len`` get
    exactly 0."""
    b, s, t, h, kh, dqk, dv, causal, window, cap, kv_len = case
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(sum(case[:7]), b, s, t, h, kh, dqk, dv))
    m = _mask(causal, window, cap, kv_len, dqk)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = mha_ref(*leaves, **m, return_lse=True)
    want = torch.autograd.grad(o, leaves, do)
    got = attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do, **m)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w.numpy())
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


def _jax_grads(q, k, v, do, causal, window, cap, kv_len, scale):
    """jax.grad of sum(sdpa(q, k, v) * do) through the reference's
    attention (its dense or blocked path by size), float32; padded keys
    at PAD_POS (the reference's own marker) past kv_len."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import PAD_POS, sdpa
    s, t = q.shape[1], k.shape[1]
    kind = "bidir" if not causal else ("local" if window else "causal")
    q_pos = jnp.arange(s)
    k_pos = jnp.arange(t)
    if kv_len is not None:
        k_pos = jnp.where(k_pos < kv_len, k_pos, PAD_POS)

    def f(q, k, v):
        o = sdpa(q, k, v, q_pos, k_pos, kind, window, scale, cap)
        return jnp.sum(o * do)
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                           for x in (q, k, v)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_jax_grad_of_reference_sdpa(case):
    """The plain backward equals ``jax.grad`` of the reference's dense
    attention at every form."""
    b, s, t, h, kh, dqk, dv, causal, window, cap, kv_len = case
    q, k, v, do = _inputs(sum(case[:7]) + 1, b, s, t, h, kh, dqk, dv)
    m = _mask(causal, window, cap, kv_len, dqk)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = mha_ref(tq, tk, tv, **m, return_lse=True)
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, **m)
    want = _jax_grads(q, k, v, do, causal, window, cap, kv_len, m["scale"])
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# above the reference's BLOCK_THRESHOLD (S * T > 1024^2): its blocked path
BLOCKED = [(1, 1152, 1152, 2, 1, 16, 16, True, 0, 0.0, None),
           (1, 1152, 1152, 2, 2, 16, 16, True, 300, 30.0, None),
           (1, 1024, 1100, 2, 2, 16, 16, False, 0, 0.0, 1000)]


@pytest.mark.parametrize("case", BLOCKED, ids=["causal", "window-softcap",
                                               "bidir-kv_len"])
def test_bwd_ref_matches_jax_grad_of_blocked_path(case):
    """At S * T above ``BLOCK_THRESHOLD`` the reference takes its
    gradient through ``_attend_blocked`` (an online softmax per q chunk,
    each jax.checkpointed): the path the kernel's backward ports."""
    from repro.models.attention import BLOCK_THRESHOLD
    b, s, t, h, kh, dqk, dv, causal, window, cap, kv_len = case
    assert s * t > BLOCK_THRESHOLD
    q, k, v, do = _inputs(s + t, b, s, t, h, kh, dqk, dv)
    m = _mask(causal, window, cap, kv_len, dqk)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = mha_ref(tq, tk, tv, **m, return_lse=True)
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, **m)
    want = _jax_grads(q, k, v, do, causal, window, cap, kv_len, m["scale"])
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("case", CASES[:5] + CASES[6:8], ids=IDS[:5] + IDS[6:8])
def test_lse_is_the_rows_logsumexp(case):
    """``return_lse`` gives each row's natural-log log-sum-exp over the
    softcapped, masked scores, float32 (B, H, S); ``exp(s - lse)`` then
    rebuilds the output, and the output is the one without lse."""
    b, s, t, h, kh, dqk, dv, causal, window, cap, kv_len = case
    q, k, v, _ = (torch.from_numpy(x) for x in
                  _inputs(sum(case[:7]) + 2, b, s, t, h, kh, dqk, dv))
    m = _mask(causal, window, cap, kv_len, dqk)
    o, lse = mha_ref(q, k, v, **m, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert torch.equal(o, mha_ref(q, k, v, **m))
    g = h // kh
    qf = q.transpose(1, 2).reshape(b * h, s, dqk)
    kf = k.repeat_interleave(g, 2).transpose(1, 2).reshape(b * h, t, dqk)
    vf = v.repeat_interleave(g, 2).transpose(1, 2).reshape(b * h, t, dv)
    sc = qf @ kf.transpose(1, 2) * m["scale"]
    if cap:
        sc = torch.tanh(sc / cap) * cap
    keep = torch.arange(t) < (t if kv_len is None else kv_len)
    qpos, kpos = torch.arange(s)[:, None], torch.arange(t)[None, :]
    if causal:
        keep = keep & (kpos <= qpos)
        if window:
            keep = keep & (qpos - kpos < window)
    sc = torch.where(keep, sc, torch.tensor(NEG))
    want = torch.logsumexp(sc, -1).reshape(b, h, s)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=2e-6,
                               rtol=1e-6)
    rebuilt = torch.exp(sc - lse.reshape(b * h, s, 1)) @ vf
    np.testing.assert_allclose(
        rebuilt.reshape(b, h, s, dv).transpose(1, 2).numpy(), o.numpy(),
        atol=2e-5)
    o2, lse2 = attention_ref(qf, kf, vf, **m, return_lse=True)
    assert torch.equal(lse2.reshape(b, h, s), lse)


@pytest.mark.parametrize("case", [
    (2, 200, 200, 4, 2, 16, 16, True, 0, 0.0),      # S padded to 256
    (1, 200, 200, 4, 1, 16, 16, True, 64, 20.0),    # window, softcap
    (2, 4, 1500, 4, 4, 16, 16, False, 0, 0.0),      # cross: T padded, kv_len
    (1, 130, 130, 4, 4, 24, 16, True, 0, 0.0)],     # dv != dqk
    ids=["causal-padded", "window-softcap", "cross", "split-dv"])
def test_mha_autograd_matches_autograd_through_mha_ref(case):
    """On the CPU ``mha`` under autograd goes through ``_Attention`` (the
    padded call, the plain forward with lse and ``attention_bwd_ref``):
    its output and its gradients equal autograd through ``mha_ref`` on
    the unpadded inputs; padded rows add nothing."""
    b, s, t, h, kh, dqk, dv, causal, window, cap = case
    arrays = _inputs(sum(case[:7]) + 3, b, s, t, h, kh, dqk, dv)
    mine = [torch.from_numpy(x).requires_grad_(True) for x in arrays[:3]]
    plain = [torch.from_numpy(x).requires_grad_(True) for x in arrays[:3]]
    do = torch.from_numpy(arrays[3])
    kw = {"scale": dqk ** -0.5, "softcap": cap, "window": window,
          "causal": causal}
    o = mha(*mine, **kw)
    want = mha_ref(*plain, **kw)
    assert o.shape == (b, s, h, dv) and o.grad_fn is not None
    np.testing.assert_allclose(o.detach().numpy(), want.detach().numpy(),
                               atol=2e-6)
    got = torch.autograd.grad(o, mine, do)
    ref = torch.autograd.grad(want, plain, do)
    for g, w in zip(got, ref):
        assert g.shape == w.shape
        _close(g.numpy(), w.numpy())


def test_mha_without_grad_makes_the_serving_call(monkeypatch):
    """With no input requiring grad (or under ``no_grad``) ``mha`` calls
    the plain forward without lse, as before; with grad it asks for lse."""
    asked = []
    real = mha_ref

    def spy(*args, return_lse=False, **kw):
        asked.append(return_lse)
        return real(*args, return_lse=return_lse, **kw)
    import repro_torch.kernels.flash_attention.ops as ops
    monkeypatch.setattr(ops, "mha_ref", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in
                  _inputs(5, 1, 128, 128, 2, 2, 16, 16))
    mha(q, k, v, scale=0.25)
    with torch.no_grad():
        mha(q.requires_grad_(True), k, v, scale=0.25)
    mha(q, k, v, scale=0.25).sum().backward()
    assert asked == [False, False, True]
    assert q.grad is not None and q.grad.abs().sum() > 0


def _stub_launch(monkeypatch, asked):
    def entry(kind):
        def fn(*args):
            asked.append((kind, args))
            return 0
        return fn
    monkeypatch.setattr(fk, "_entry", entry)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fk.flash_attention, "launches", 0)
    monkeypatch.setattr(fk.flash_attention, "calls", collections.Counter())
    monkeypatch.setattr(fk.flash_attention_bwd, "launches", 0)
    monkeypatch.setattr(fk.flash_attention_bwd, "calls",
                        collections.Counter())


def test_launchers_pass_lse_and_the_backward_arguments(monkeypatch):
    """The forward passes a float32 (B, H, S) lse pointer right after
    ``kv_len`` (``args[23]``; None without lse), keeping ``args[21:23]``
    and the last four arguments; the backward's entry takes dtype, the
    ten pointers, B, S, T, H, K, dh, dv, the strides, causal, kv_len,
    scale, softcap, window and the stream, always on the CUDA cores, and
    is counted in ``flash_attention_bwd`` under the forward's key. No
    kernel is built: ``_entry`` is stubbed, and the CPU tensors pass for
    CUDA ones."""
    asked = []
    _stub_launch(monkeypatch, asked)
    q = torch.zeros((2, 128, 12, 64), dtype=torch.bfloat16)
    kv = torch.zeros((2, 1536, 12, 64), dtype=torch.bfloat16)
    o = fk.flash_attention(q, kv, kv, scale=0.125, causal=False, kv_len=1500)
    kind, args = asked[-1]
    assert kind == "wgmma" and args[23] is None and args[21:23] == (0, 1500)
    o, lse = fk.flash_attention(q, kv, kv, scale=0.125, causal=False,
                                kv_len=1500, return_lse=True)
    kind, args = asked[-1]
    assert (kind, args[21:23], args[-4:-1]) == ("wgmma", (0, 1500),
                                                (0.125, 0.0, 0))
    assert args[23] == lse.data_ptr() and lse.dtype == torch.float32
    assert lse.shape == (2, 12, 128) and o.shape == q.shape
    assert fk.flash_attention.launches == 2
    dq, dk, dv = fk.flash_attention_bwd(q, kv, kv, o, lse, o, scale=0.125,
                                        causal=False, kv_len=1500)
    kind, args = asked[-1]
    assert kind == "bwd" and len(args) == 33
    assert args[0] == fk.DTYPES[torch.bfloat16]
    assert args[1:4] == (q.data_ptr(), kv.data_ptr(), kv.data_ptr())
    assert args[6] == lse.data_ptr()
    assert args[8:11] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[11:18] == (2, 128, 1536, 12, 12, 64, 64)
    assert args[27:29] == (0, 1500) and args[-4:-1] == (0.125, 0.0, 0)
    assert dq.shape == q.shape and dk.shape == kv.shape
    assert dv.shape == kv.shape and dq.dtype == torch.bfloat16
    assert fk.flash_attention_bwd.launches == 1
    assert fk.flash_attention_bwd.calls[
        (2, 128, 1536, 12, 12, 64, str(torch.bfloat16), "simt")] == 1
    x = torch.zeros((1, 256, 4, 192))
    w = torch.zeros((1, 256, 2, 128))
    xl = torch.zeros((1, 4, 256))
    fk.flash_attention_bwd(x, x[:, :, :2], w, torch.zeros((1, 256, 4, 128)),
                           xl, torch.zeros((1, 256, 4, 128)), scale=0.5,
                           softcap=30.0, window=100)
    kind, args = asked[-1]
    assert args[11:18] == (1, 256, 256, 4, 2, 192, 128)
    assert args[27:29] == (1, 256) and args[-4:-1] == (0.5, 30.0, 100)
    assert fk.flash_attention.launches == 2


def test_backward_launcher_validates_inputs():
    """The backward refuses what the forward refuses, and an o, do or lse
    of the wrong shape or dtype, before it builds or launches anything."""
    launches = fk.flash_attention_bwd.launches
    x = torch.zeros((1, 128, 2, 64))
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_bwd(x, x, x, x, lse, x, scale=1.0)
    with pytest.raises(ValueError, match="multiples of 128"):
        s = x[:, :100]
        fk.flash_attention_bwd(s, s, s, s, lse[..., :100], s, scale=1.0)
    with pytest.raises(TypeError):
        fk.flash_attention_bwd(x, x.to(torch.bfloat16), x, x, lse, x,
                               scale=1.0)
    assert fk.flash_attention_bwd.launches == launches


def test_backward_launcher_refuses_bad_o_and_lse(monkeypatch):
    """With the checks on q, k, v passed (CUDA stubbed), an o, do or lse
    that does not fit raises before the launch."""
    asked = []
    _stub_launch(monkeypatch, asked)
    x = torch.zeros((1, 128, 2, 64))
    lse = torch.zeros((1, 2, 128))
    for o, l, d in ((x[:, :, :1], lse, x), (x, lse[:, :1], x),
                    (x, lse.to(torch.bfloat16), x),
                    (x, lse, x.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="flash_attention_bwd needs"):
            fk.flash_attention_bwd(x, x, x, o, l, d, scale=1.0)
    assert not asked and fk.flash_attention_bwd.launches == 0


# -- on the card (skipped without one)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is built with nvcc for "
                    "sm_90a and runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    (2, 256, 256, 12, 2, 128, 128, True, 0, 0.0, None),
    (1, 512, 512, 4, 2, 128, 128, True, 128, 50.0, None),
    (1, 256, 256, 4, 2, 192, 192, True, 0, 0.0, None),
    (1, 256, 256, 4, 4, 192, 128, True, 0, 0.0, None),
    (2, 128, 1536, 4, 4, 64, 64, False, 0, 0.0, 1500),
    (1, 384, 384, 4, 1, 64, 64, True, 0, 0.0, 300)])
def test_backward_kernel_matches_plain_on_card(cuda, case, dtype):
    """The kernel's forward with lse gives the output bit for bit, its
    lse within 2e-5 of the plain one; its backward is within FA_BWD_TOL
    (of each gradient's largest magnitude) of ``attention_bwd_ref`` in
    float32 on the same inputs, and two calls give the same bits."""
    b, s, t, h, kh, dqk, dv, causal, window, cap, kv_len = case
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(cuda, dt) for x in
                   _inputs(s + h, b, s, t, h, kh, dqk, dv))
    m = _mask(causal, window, cap, kv_len, dqk)
    o0 = fk.flash_attention(q, k, v, **m)
    o, lse = fk.flash_attention(q, k, v, **m, return_lse=True)
    assert torch.equal(o0, o)
    _, want_lse = mha_ref(q, k, v, **m, return_lse=True)
    assert float((lse - want_lse).abs().max()) <= 2e-5
    g1 = fk.flash_attention_bwd(q, k, v, o, lse, do, **m)
    g2 = fk.flash_attention_bwd(q, k, v, o, lse, do, **m)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                             do.float(), **m)
    for x, y, w in zip(g1, g2, want):
        assert torch.equal(x, y)
        err = float((x.float() - w).abs().max() / w.abs().max())
        assert err <= FA_BWD_TOL[dtype]
