# repro: quarantine -- growth-seed LM training path; nothing in the battery system imports it
"""The training entry point (port of ``repro/launch/train.py``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 50 --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given. ``--full`` trains the
architecture at its published width and depth (with the config's own
``train_accum``, ``remat_policy`` and ``adam_dtype``); the default
``--reduced`` runs the same loop with the smoke config. Parameters come
from a ``torch.Generator`` seeded with the seed (the reference's scheme,
not its ``jax.random`` numbers); the data from ``data.synthetic``, whose
tokens are the reference's bit for bit. With ``--ckpt`` it checkpoints
every ``ckpt_every`` steps (25) and at the end (the reference's msgpack
layout, ``{"params", "opt": {"m", "v", "step"}}``, written atomically)
and resumes restart-exactly: the data stream is keyed by step.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import io as ckpt_io
from repro_torch.common.device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data.synthetic import batch_at
from repro_torch.models import lm
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.step import make_train_step


def train(arch: str, steps: int, reduced: bool = True, seed: int = 0,
          global_batch: int = 8, seq_len: int = 128,
          ckpt_path: str | None = None, ckpt_every: int = 25,
          log_every: int = 10, oc: OptConfig | None = None, device=None,
          on_step=None):
    """Train ``arch`` from step 0 (or from ``ckpt_path``'s step) up to
    ``steps`` -> (state, the losses of the steps run here, floats).
    ``on_step(step, metrics)``, when given, is called after each step."""
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    oc = oc or OptConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    params = lm.init_params(cfg, seed, dev)
    state = {"params": params,
             "opt": init_opt_state(params, getattr(torch, cfg.adam_dtype))}
    start_step = 0
    if ckpt_path and ckpt_io.exists(ckpt_path):
        state = ckpt_io.load_into(ckpt_path, state)
        start_step = int(state["opt"]["step"])
        print(f"resumed from {ckpt_path} at step {start_step}")

    step_fn = make_train_step(cfg, oc)
    frames_spec = ((global_batch, cfg.encoder_seq, cfg.d_model)
                   if cfg.family == "audio" else None)
    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        batch = batch_at(seed, step, global_batch, seq_len, cfg.vocab_size,
                         frames_spec, device=dev)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, metrics)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)",
                  flush=True)
        if ckpt_path and (step + 1) % ckpt_every == 0:
            ckpt_io.save_tree(ckpt_path, state)
    if ckpt_path:
        ckpt_io.save_tree(ckpt_path, state)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, args.steps, args.reduced,
                      global_batch=args.batch, seq_len=args.seq,
                      ckpt_path=args.ckpt, device=args.device)
    print(f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
