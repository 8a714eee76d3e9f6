"""PyTorch port: the training path against the JAX reference on the CPU.

AdamW and its schedule (``train/optim.py``) on the same arrays as the
reference's, the accumulating train step (``train/step.py``) from the
reference's own weights (``models/convert.py``), the synthetic data
(``data/synthetic.py``: tokens bitwise), the training entry point
(``launch/train.py``: the reference's ``test_loss_decreases`` and
``test_checkpoint_restart_exact``) and its checkpoints (byte for byte the
reference's ``repro.ckpt.io.save``; each package loads the other's file).
The reference's optimiser, step, data and checkpoint modules are imported
directly; never ``repro.launch.*`` (it sets XLA flags when imported).
Inputs come from ``numpy.random.default_rng``.

Tolerances: the schedule and the update are float32 arithmetic in the
same order (1e-6 relative; XLA's and torch's ``pow`` and ``sqrt`` may
round differently in the last bit); bfloat16 moments within one bfloat16
step; a train step's loss and gradient norm within 1e-5 relative
(float32 sums of the same terms in two orders).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt import io as ckpt_io
from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import batch_at
from repro_torch.launch.train import train
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import leaves, tree_map
from repro_torch.train.optim import (OptConfig, adamw_update, global_norm,
                                     init_opt_state, lr_at)
from repro_torch.train.step import make_train_step, microbatches

ARCH = "qwen2-1.5b"
RTOL = 1e-6
STEP_RTOL = 1e-5


def _np(x):
    return np.asarray(x.detach().float().cpu() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def test_lr_at_matches_reference():
    """The warmup and cosine schedule at steps across warmup, decay and
    past the end, as int32 steps (the optimizer's) and as Python ints."""
    import jax.numpy as jnp
    from repro.train.optim import OptConfig as RefOpt
    from repro.train.optim import lr_at as ref_lr_at
    for kw in ({}, {"lr": 1e-3, "warmup_steps": 20, "total_steps": 30},
               {"warmup_steps": 0, "total_steps": 5, "min_lr_frac": 0.0}):
        oc, roc = OptConfig(**kw), RefOpt(**kw)
        steps = np.array([0, 1, 5, 19, 20, 21, 100, 5000, 9999, 10000, 20000],
                         np.int32)
        got = lr_at(torch.from_numpy(steps), oc)
        want = np.asarray(ref_lr_at(jnp.asarray(steps), roc))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
        for s in (0, 7, 250):
            np.testing.assert_allclose(float(lr_at(s, oc)),
                                       float(ref_lr_at(s, roc)), rtol=RTOL)


def _trees(seed, dtype=np.float32):
    """A parameter tree (nested dicts) and a gradient tree of the same
    shapes, numpy, with large and small leaves."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (64, 16), "units": {"w": (2, 16, 8), "b": (2, 8)},
              "final_norm": {"scale": (16,)}}

    def make(scale):
        return {k: make_leaf(v, scale) for k, v in shapes.items()}

    def make_leaf(v, scale):
        if isinstance(v, dict):
            return {k: make_leaf(x, scale) for k, x in v.items()}
        return (rng.standard_normal(v) * scale).astype(dtype)
    return make(0.5), make(3.0)


def _torch_tree(t, dtype=torch.float32):
    # copies: the port updates its tensors in place, and the reference's
    # arrays may share the numpy buffers
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           dtype=dtype), t)


def test_global_norm_matches_reference():
    import jax.numpy as jnp
    from repro.train.optim import global_norm as ref_norm
    _, grads = _trees(1)
    got = global_norm(_torch_tree(grads))
    want = ref_norm(tree_map(jnp.asarray, grads))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference_float32_moments(clip):
    """Three AdamW steps (clipped or not) from the same parameters and
    gradients: parameters and moments within 1e-6 relative, the step
    advanced, the metrics equal; the port's tensors are updated in
    place."""
    import jax
    import jax.numpy as jnp
    from repro.train.optim import OptConfig as RefOpt
    from repro.train.optim import adamw_update as ref_update
    from repro.train.optim import init_opt_state as ref_init
    params, grads = _trees(2)
    kw = {"lr": 1e-2, "warmup_steps": 2, "total_steps": 4, "clip_norm": clip}
    oc, roc = OptConfig(**kw), RefOpt(**kw)
    tp, tg = _torch_tree(params), _torch_tree(grads)
    rp, rg = tree_map(jnp.asarray, params), tree_map(jnp.asarray, grads)
    ts, rs = init_opt_state(tp), ref_init(rp)
    first = leaves(tp)[0]
    for _ in range(3):
        tp, ts, tm = adamw_update(tp, tg, ts, oc)
        rp, rs, rm = ref_update(rp, rg, rs, roc)
    assert leaves(tp)[0] is first and int(ts["step"]) == int(rs["step"]) == 3
    assert ts["step"].dtype == torch.int32
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(rm[name]),
                                   rtol=RTOL)
    for mine, ref in ((tp, rp), (ts["m"], rs["m"]), (ts["v"], rs["v"])):
        for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


def test_adamw_update_bfloat16_moments_within_one_step():
    """With ``adam_dtype`` bfloat16 (the 340B preset) the moments are
    bfloat16 and within one bfloat16 step of the reference's; the
    parameters keep their dtype."""
    import jax
    import jax.numpy as jnp
    from repro.train.optim import OptConfig as RefOpt
    from repro.train.optim import adamw_update as ref_update
    from repro.train.optim import init_opt_state as ref_init
    params, grads = _trees(3)
    oc, roc = OptConfig(lr=1e-2), RefOpt(lr=1e-2)
    tp, tg = _torch_tree(params), _torch_tree(grads)
    rp, rg = tree_map(jnp.asarray, params), tree_map(jnp.asarray, grads)
    ts, rs = init_opt_state(tp, torch.bfloat16), ref_init(rp, jnp.bfloat16)
    for _ in range(2):
        tp, ts, _ = adamw_update(tp, tg, ts, oc)
        rp, rs, _ = ref_update(rp, rg, rs, roc)
    for key in ("m", "v"):
        for a, b in zip(leaves(ts[key]), jax.tree_util.tree_leaves(rs[key])):
            assert a.dtype == torch.bfloat16
            b = np.asarray(b, np.float32)
            # one bfloat16 step at each value's magnitude
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
            assert np.all(np.abs(_np(a) - b) <= ulp)
    assert all(p.dtype == torch.float32 for p in leaves(tp))


def _reference_pair(accum, dtype="float32"):
    """The reduced qwen2 config (compute ``dtype``, ``train_accum``) for
    both packages, and the reference's weights carried over."""
    import jax
    from repro.configs import get_reduced as ref_reduced
    from repro.models import lm as ref_lm
    rcfg = dataclasses.replace(ref_reduced(ARCH), compute_dtype=dtype,
                               train_accum=accum)
    cfg = dataclasses.replace(get_reduced(ARCH), compute_dtype=dtype,
                              train_accum=accum)
    rparams = ref_lm.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                             cfg, device="cpu")
    return rcfg, cfg, rparams, params


@pytest.mark.parametrize("batch,accum", [(8, 4), (6, 4), (5, 4), (4, 1)])
def test_train_step_with_accumulation_matches_reference(batch, accum):
    """One train step from the reference's weights on the same batch:
    ``eff = min(accum, batch)`` lowered until it divides the batch (8/4:
    4 microbatches; 6/4: 3; an odd 5/4: 1), float32 sums of the microbatch
    gradients over ``eff``. Loss and gradient norm within 1e-5 relative;
    the updated parameters within 1 % of the step's learning rate (Adam's
    first step moves each element by about lr g / (|g| + eps), so an
    element whose gradient is near 0 turns float32 summation differences
    into a visible change of its step)."""
    import jax
    import jax.numpy as jnp
    from repro.train.optim import OptConfig as RefOpt
    from repro.train.optim import init_opt_state as ref_init
    from repro.train.step import make_train_step as ref_make
    assert microbatches(batch, accum) == {(8, 4): 4, (6, 4): 3, (5, 4): 1,
                                          (4, 1): 1}[(batch, accum)]
    rcfg, cfg, rparams, params = _reference_pair(accum)
    rng = np.random.default_rng(batch)
    tokens = rng.integers(0, cfg.vocab_size, (batch, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    oc, roc = OptConfig(lr=1e-3, warmup_steps=2), RefOpt(lr=1e-3,
                                                         warmup_steps=2)
    state = {"params": params, "opt": init_opt_state(params)}
    state, m = make_train_step(cfg, oc)(
        state, {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)})
    rstate, rm = jax.jit(ref_make(rcfg, roc))(
        {"params": rparams, "opt": ref_init(rparams)},
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[name]), float(rm[name]),
                                   rtol=STEP_RTOL)
    for a, b in zip(leaves(state["params"]),
                    jax.tree_util.tree_leaves(rstate["params"])):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                   atol=1e-2 * float(rm["lr"]))
    assert int(state["opt"]["step"]) == 1


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("step", [0, 1, 100])
def test_batch_at_tokens_are_the_reference_bit_for_bit(seed, step):
    """Tokens and labels of the synthetic stream equal the reference's,
    int32, bit for bit; whisper's bfloat16 frames are within one bfloat16
    step (``erfinv`` is not XLA's polynomial)."""
    from repro.data.synthetic import batch_at as ref_batch_at
    cfg = get_reduced("whisper-small")
    spec = (4, cfg.encoder_seq, cfg.d_model)
    got = batch_at(seed, step, 4, 96, cfg.vocab_size, spec, device="cpu")
    want = ref_batch_at(seed, step, 4, 96, cfg.vocab_size, spec)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["frames"].dtype == torch.bfloat16
    f = np.asarray(want["frames"], np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(f), 1e-30))) - 7)
    assert np.all(np.abs(got["frames"].float().numpy() - f) <= ulp)
    big = batch_at(seed, step, 2, 64, 151936, device="cpu")
    np.testing.assert_array_equal(
        big["tokens"].numpy(),
        np.asarray(ref_batch_at(seed, step, 2, 64, 151936)["tokens"]))


def test_loss_decreases():
    """The reference's ``test_loss_decreases``: 30 steps of reduced
    qwen2-1.5b through ``launch.train.train`` take the loss down by more
    than 0.3."""
    _, losses = train(ARCH, steps=30, global_batch=4, seq_len=64,
                      log_every=0, device="cpu")
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_checkpoint_restart_exact(tmp_path):
    """The reference's ``test_checkpoint_restart_exact``: a run to step
    10 (checkpointed), resumed to 14, equals a straight run to 14 bit for
    bit: parameters, moments and step."""
    ck = str(tmp_path / "t.ck")
    train(ARCH, steps=10, global_batch=2, seq_len=32, ckpt_path=ck,
          ckpt_every=5, log_every=0, device="cpu")
    state_b, losses_b = train(ARCH, steps=14, global_batch=2, seq_len=32,
                              ckpt_path=ck, ckpt_every=100, log_every=0,
                              device="cpu")
    state_c, losses_c = train(ARCH, steps=14, global_batch=2, seq_len=32,
                              log_every=0, device="cpu")
    assert losses_b == losses_c[10:]
    for b, c in zip(leaves(state_b), leaves(state_c)):
        assert torch.equal(b, c)
    assert int(state_b["opt"]["step"]) == 14


def test_checkpoint_bytes_and_cross_loading(tmp_path):
    """The port's checkpoint of a train state is byte for byte the file
    ``repro.ckpt.io.save`` writes for the same arrays (leaves in sorted
    key order, jax's treedef string, bfloat16 as ``<V2``), and each
    package loads the other's file."""
    import jax
    import jax.numpy as jnp
    from repro.ckpt import io as ref_io
    from repro.train.optim import init_opt_state as ref_init
    rcfg, cfg, rparams, params = _reference_pair(1)
    tstate = {"params": params, "opt": init_opt_state(params)}
    tstate["opt"]["step"] += 3
    for m in leaves(tstate["opt"]["m"]):
        m.add_(0.25)
    rstate = {"params": rparams, "opt": ref_init(rparams)}
    rstate["opt"]["step"] = rstate["opt"]["step"] + 3
    rstate["opt"]["m"] = jax.tree_util.tree_map(lambda x: x + 0.25,
                                                rstate["opt"]["m"])
    mine, theirs = str(tmp_path / "mine.ck"), str(tmp_path / "ref.ck")
    ckpt_io.save_tree(mine, tstate)
    ref_io.save(theirs, rstate)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    back = ckpt_io.load_into(theirs, tstate)
    for a, b in zip(leaves(back), leaves(tstate)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    loaded = ref_io.load_into(mine, rstate)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(rstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # bfloat16 moments: the same bytes both ways
    half = {"m": tree_map(lambda x: x.to(torch.bfloat16), tstate["opt"]["m"])}
    rhalf = {"m": jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                         rstate["opt"]["m"])}
    ckpt_io.save_tree(mine, half)
    ref_io.save(theirs, rhalf)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    back = ckpt_io.load_into(theirs, half)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(half)))


def test_train_refuses_cuda_without_a_card():
    """``train`` runs on cuda by default and raises without a card (no
    silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(ARCH, steps=1, global_batch=2, seq_len=16, log_every=0)


def test_cli_runs_on_the_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` trains the
    reduced config and reports the first and last loss."""
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "32",
          "--device", "cpu", "--ckpt", str(tmp_path / "c.ck")])
    out = capsys.readouterr().out
    assert "first loss" in out and (tmp_path / "c.ck").exists()
