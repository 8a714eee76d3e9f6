# repro: quarantine -- growth-seed attention kernel; unrelated to the TestU01 battery kernels
"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``), and of the kernel's call in
the ``(B, S, H, dh)`` GQA layout. v may have a head dim of its own
(``dv``, MLA's 128 beside its 192-wide q and k); the output has v's."""
import torch

NEG = -2.3819763e38


def attention_ref(q, k, v, *, scale, softcap=0.0, window=0, causal=True,
                  kv_len=None):
    """Attention, the kernel's plain version. q: (BH, S, dh), k: (BH, T,
    dh), v: (BH, T, dv) -> (BH, S, dv) in q's dtype, computed in fp32.
    Keys at ``kpos >= kv_len`` (default T) are masked: the padding of a
    ragged key count. ``causal`` also masks ``kpos > qpos``; with it,
    ``window`` w > 0 is a sliding window (``0 <= qpos - kpos < w``), the
    reference's ``kind="local"`` mask. ``causal=False`` is the reference's
    non-causal form (``mode="bidir"``: every key below ``kv_len``) and
    takes no window. The softcap comes before the mask, as in the
    reference."""
    if window and not causal:
        raise ValueError("a sliding window needs the causal form")
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qn, kn = s.shape[1], s.shape[2]
    keep = torch.arange(kn, device=s.device) < (kn if kv_len is None
                                                else kv_len)
    mask = keep.expand(qn, kn)
    if causal:
        mask = mask.tril()
        if window:
            mask = mask.triu(1 - window)
    s = torch.where(mask[None], s, torch.tensor(NEG, device=s.device))
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def mha_ref(q, k, v, *, scale, softcap=0.0, window=0, causal=True,
            kv_len=None):
    """The kernel's function in its own layout: q (B, S, H, dh), k
    (B, T, K, dh), v (B, T, K, dv) -> (B, S, H, dv). Repeats the kv heads
    and folds the heads into the batch, as the reference wrapper does,
    then calls ``attention_ref``."""
    b, s, h, dh = q.shape
    kh, dv = k.shape[2], v.shape[3]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, dh)
    kf = k.transpose(1, 2).reshape(b * h, k.shape[1], dh)
    vf = v.transpose(1, 2).reshape(b * h, v.shape[1], dv)
    o = attention_ref(qf, kf, vf, scale=scale, softcap=softcap, window=window,
                      causal=causal, kv_len=kv_len)
    return o.reshape(b, h, s, dv).transpose(1, 2)
