"""PyTorch port: ``loss_fn`` and its gradients against the JAX reference's
``jax.value_and_grad(loss_fn)``, every reduced architecture, on the CPU.

The reference's weights go across through ``models/convert.py``; tokens
(and whisper's frames) come from ``numpy.random.default_rng``. In float32
the loss is held to 1e-5 relative and every gradient leaf to 1e-4 of its
largest magnitude (float32 sums in other orders through a few layers,
the chunked cross-entropy, the recurrent scans). The remat policies
(``full``, ``dots``, ``none``) and ``scan_group`` change where the port
recomputes, not what: its own numbers agree within 1e-6. One bfloat16
case holds the loss to 2e-2 (bfloat16 rounds at other places in the two
frameworks).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import leaves

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
BF16_LOSS_TOL = 2e-2


def _setup(arch, dtype="float32", seed=0):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as ref_reduced
    from repro.models import lm as ref_lm
    rcfg = dataclasses.replace(ref_reduced(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(get_reduced(arch), compute_dtype=dtype)
    rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                             cfg, device="cpu")
    rng = np.random.default_rng(seed + 11)
    b, s = 2, 32
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    rbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    if cfg.family == "audio":
        frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model),
                                     dtype=np.float32)
        batch["frames"] = torch.from_numpy(frames)
        rbatch["frames"] = jnp.asarray(frames)
    return rcfg, cfg, rparams, params, rbatch, batch


def _value_and_grad(params, batch, cfg):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = lm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(flat, grads)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference_float32(arch):
    import jax
    from repro.models import lm as ref_lm
    rcfg, cfg, rparams, params, rbatch, batch = _setup(arch)
    rloss, rgrads = jax.value_and_grad(ref_lm.loss_fn)(rparams, rbatch, rcfg)
    loss, grads = _value_and_grad(params, batch, cfg)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(rloss), rtol=LOSS_RTOL)
    rleaves = jax.tree_util.tree_leaves(rgrads)
    assert len(rleaves) == len(grads)
    for g, r in zip(grads, rleaves):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), r, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(r).max()), 1e-30))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_policies_and_scan_groups_change_nothing(arch):
    """``remat_policy`` full, dots and none, and ``scan_group=1`` (every
    unit in a group of its own, both levels checkpointed) give the
    port's loss and gradients within 1e-6 of each other."""
    _, cfg, _, params, _, batch = _setup(arch, seed=1)
    base_loss, base = _value_and_grad(params, batch, cfg)
    variants = [dataclasses.replace(cfg, remat_policy=p)
                for p in ("dots", "none")]
    variants.append(dataclasses.replace(cfg, scan_group=1))
    for c in variants:
        loss, grads = _value_and_grad(params, batch, c)
        assert abs(loss - base_loss) <= REMAT_TOL * abs(base_loss)
        for g, b in zip(grads, base):
            assert float((g - b).abs().max()) <= REMAT_TOL * max(
                float(b.abs().max()), 1e-30)


def test_loss_matches_reference_bfloat16():
    """qwen2-1.5b reduced in its own compute dtype (bfloat16): the loss
    within 2e-2 of the reference's, the gradients finite and float32
    (the parameters' dtype)."""
    from repro.models import lm as ref_lm
    rcfg, cfg, rparams, params, rbatch, batch = _setup("qwen2-1.5b",
                                                       dtype="bfloat16")
    loss, grads = _value_and_grad(params, batch, cfg)
    rloss = float(ref_lm.loss_fn(rparams, rbatch, rcfg))
    assert abs(loss - rloss) <= BF16_LOSS_TOL
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads)


def test_loss_chunks_and_padded_vocabulary():
    """At S = 1024 the cross-entropy runs in two chunks of LOSS_CHUNK and
    equals the one-chunk sum; the padded vocabulary (vocab 250, padded to
    256) takes no probability: its logits' gradients are 0."""
    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"),
                              compute_dtype="float32", vocab_size=250,
                              n_layers=1)
    assert cfg.padded_vocab == 256 and lm.LOSS_CHUNK == 512
    params = lm.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, 250, (1, 1024)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    loss, grads = _value_and_grad(params, batch, cfg)
    x, aux = lm.forward_hidden(params, tokens, cfg)
    whole = lm._ce_chunk(params, x, batch["labels"], cfg) / 1024 + aux
    np.testing.assert_allclose(loss, float(whole), rtol=1e-6)
    embed = next(g for p, g in zip(leaves(params), grads)
                 if p is params["embed"])
    # tied embeddings: the padded rows get no gradient from the logits and
    # none from the (absent) tokens
    assert not embed[250:].any()


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), remat_policy="some")
    with pytest.raises(ValueError, match="remat_policy"):
        lm.model_spec(cfg)
