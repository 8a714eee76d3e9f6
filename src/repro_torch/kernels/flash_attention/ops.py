# repro: quarantine -- growth-seed attention kernel; unrelated to the TestU01 battery kernels
"""Public attention wrapper (port of
``repro/kernels/flash_attention/ops.py::mha``): the ``(B, S, H, dh)``
layout with GQA head grouping.

The reference leaves padding to its callers and asserts S, T % 128 == 0;
here ``mha`` pads S and T up to a multiple of 128 itself and slices the
result, so prompts and frame counts of any length work. Under the causal
mask that is exact when S <= T: padded keys sit after every real query,
and padded query rows are dropped. A sliding window keeps the causal
bound (it only adds a lower one), so padded keys stay masked for every
real query under it too. The non-causal form (the reference's
``mode="bidir"``) passes the real key count ``kv_len = T`` to the kernel,
which masks the padded keys, so it takes any S and T. A CUDA tensor goes
to the kernel, a CPU tensor to the plain version.

Gradients: when grad is enabled and q, k or v requires it, ``mha`` goes
through ``_Attention``, a ``torch.autograd.Function`` around the padded
call. On CUDA its forward saves (q, k, v, o, lse) from the kernel's
forward with ``return_lse=True`` and its backward is the kernel's
(``flash_attention_bwd``); on the CPU the same Function runs the plain
versions (``mha_ref(return_lse=True)``, ``attention_bwd_ref``). Padded
query rows get a zero output gradient (the slice's backward), so they
add nothing. Without grad, ``mha`` makes the serving call unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.kernel import (BLOCK, flash_attention,
                                                        flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, mha_ref


def _pad_seq(x, n):
    return x if x.shape[1] == n else F.pad(x, (0, 0, 0, 0, 0, n - x.shape[1]))


def _forward(q, k, v, mask, return_lse=False):
    """The padded call on the kernel (CUDA) or its plain version (CPU)."""
    if q.is_cuda:
        return flash_attention(q, k, v, **mask, return_lse=return_lse)
    if q.device.type == "cpu":
        return mha_ref(q, k, v, **mask, return_lse=return_lse)
    raise ValueError(f"no flash-attention kernel for device {q.device}")


class _Attention(torch.autograd.Function):
    """Attention on padded q, k, v with the kernel's backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        o, lse = _forward(q, k, v, mask, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = mask
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if q.is_cuda else attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, lse, do, **ctx.mask)
        return dq, dk, dv, None


def mha(q, k, v, *, scale, softcap=0.0, window=0, causal=True):
    """Attention. q: (B, S, H, dh); k: (B, T, K, dh), v: (B, T, K, dv)
    with H % K == 0 and dv <= dh -> (B, S, H, dv) in q's dtype.
    ``causal`` keeps the keys with ``kpos <= qpos``, and ``window`` w > 0
    with it those with ``0 <= qpos - kpos < w`` (the reference's local
    attention); ``causal=False`` keeps every key (the Pallas kernel's
    non-causal form: whisper's encoder self-attention and its decoder's
    cross attention) and takes no window. Differentiable in q, k and v
    (``_Attention``)."""
    if window < 0:
        raise ValueError(f"window {window} is negative (0 is no window)")
    if window and not causal:
        raise ValueError("a sliding window needs the causal form")
    s, t = q.shape[1], k.shape[1]
    sp, tp = -(-s // BLOCK) * BLOCK, -(-t // BLOCK) * BLOCK
    if window and s > t:
        raise ValueError(f"a window needs S <= T, got S={s}, T={t}: a "
                         f"query past T + window - 1 has no key")
    if causal and tp != t and s > t:
        raise ValueError(f"T={t} is not a multiple of {BLOCK}, and padded "
                         f"keys would be attended (S={s} > T)")
    # the causal form masks padded keys by position; the non-causal one
    # by the key count
    mask = {"scale": scale, "softcap": softcap, "window": window,
            "causal": causal, "kv_len": tp if causal else t}
    q, k, v = _pad_seq(q, sp), _pad_seq(k, tp), _pad_seq(v, tp)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = _Attention.apply(q, k, v, mask)
    else:
        o = _forward(q, k, v, mask)
    return o[:, :s]
