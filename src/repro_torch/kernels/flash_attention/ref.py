# repro: quarantine -- growth-seed attention kernel; unrelated to the TestU01 battery kernels
"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``), and of the kernel's call in
the ``(B, S, H, dh)`` GQA layout. v may have a head dim of its own
(``dv``, MLA's 128 beside its 192-wide q and k); the output has v's.

The backward (``attention_bwd_ref``) is the plain version of the
kernel's backward (``fa_bwd.cuh``): the gradient the reference takes by
autodiff through its blocked XLA path (``models/attention.py``
``_attend_blocked``), written out from the forward's row log-sum-exp
as flash attention computes it."""
import torch

NEG = -2.3819763e38


def _mask(qn, kn, device, *, window, causal, kv_len):
    """(qn, kn) bool: the keys each query keeps."""
    keep = torch.arange(kn, device=device) < (kn if kv_len is None
                                              else kv_len)
    mask = keep.expand(qn, kn)
    if causal:
        mask = mask.tril()
        if window:
            mask = mask.triu(1 - window)
    return mask


def _scores(q, k, scale, softcap):
    """Scores after the scale and the softcap, float32 (no mask)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def attention_ref(q, k, v, *, scale, softcap=0.0, window=0, causal=True,
                  kv_len=None, return_lse=False):
    """Attention, the kernel's plain version. q: (BH, S, dh), k: (BH, T,
    dh), v: (BH, T, dv) -> (BH, S, dv) in q's dtype, computed in fp32.
    Keys at ``kpos >= kv_len`` (default T) are masked: the padding of a
    ragged T. ``causal`` also masks ``kpos > qpos``; with it,
    ``window`` w > 0 is a sliding window (``0 <= qpos - kpos < w``), the
    reference's ``kind="local"`` mask. ``causal=False`` is the reference's
    non-causal form (``mode="bidir"``: every key below ``kv_len``) and
    takes no window. The softcap comes before the mask, as in the
    reference. ``return_lse`` also returns each row's log-sum-exp, float32
    (BH, S), in natural log, over the softcapped and masked scores."""
    if window and not causal:
        raise ValueError("a sliding window needs the causal form")
    s = _scores(q, k, scale, softcap)
    mask = _mask(s.shape[1], s.shape[2], s.device, window=window,
                 causal=causal, kv_len=kv_len)
    s = torch.where(mask[None], s, torch.tensor(NEG, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    w = torch.exp(s - m)
    total = w.sum(dim=-1, keepdim=True)
    w = w / total
    o = torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(total))[..., 0]
    return o


def _fold(x):
    """(B, S, H, d) -> (B*H, S, d)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _repeat_kv(k, h):
    kh = k.shape[2]
    return k if kh == h else k.repeat_interleave(h // kh, dim=2)


def mha_ref(q, k, v, *, scale, softcap=0.0, window=0, causal=True,
            kv_len=None, return_lse=False):
    """The kernel's function in its own layout: q (B, S, H, dh), k
    (B, T, K, dh), v (B, T, K, dv) -> (B, S, H, dv). Repeats the kv heads
    and folds the heads into the batch, as the reference wrapper does,
    then calls ``attention_ref``. ``return_lse`` also returns the rows'
    log-sum-exp as float32 (B, H, S), the layout the kernel writes."""
    b, s, h, _ = q.shape
    dv = v.shape[3]
    out = attention_ref(_fold(q), _fold(_repeat_kv(k, h)),
                        _fold(_repeat_kv(v, h)), scale=scale,
                        softcap=softcap, window=window, causal=causal,
                        kv_len=kv_len, return_lse=return_lse)
    o, lse = out if return_lse else (out, None)
    o = o.reshape(b, h, s, dv).transpose(1, 2)
    return (o, lse.reshape(b, h, s)) if return_lse else o


def attention_bwd_ref(q, k, v, o, lse, do, *, scale, softcap=0.0, window=0,
                      causal=True, kv_len=None):
    """The backward of ``mha_ref``, the kernel backward's plain version.
    q (B, S, H, dqk), k (B, T, K, dqk), v (B, T, K, dv), the forward's o
    (B, S, H, dv) and lse (B, H, S) float32, the output's gradient do
    (B, S, H, dv) -> (dq, dk, dv) in the inputs' dtypes, computed in
    float32. It recomputes ``p = exp(s - lse)`` and takes

        D = rowsum(do . o), dv = p^T do, ds = p (do v^T - D),
        with a softcap ds *= 1 - (s / cap)^2,
        dq = ds k * scale, dk = ds^T q * scale,

    dk and dv summed over each GQA group. A masked key's p is exactly 0,
    so keys at or past ``kv_len`` (and masked pairs) get exactly 0."""
    if window and not causal:
        raise ValueError("a sliding window needs the causal form")
    b, s, h, dqk = q.shape
    t, kh, dvw = k.shape[1], k.shape[2], v.shape[3]
    qf, kf, vf = _fold(q), _fold(_repeat_kv(k, h)), _fold(_repeat_kv(v, h))
    of, dof = _fold(o).float(), _fold(do).float()
    sc = _scores(qf, kf, scale, softcap)
    mask = _mask(s, t, sc.device, window=window, causal=causal,
                 kv_len=kv_len)
    p = torch.where(mask[None], torch.exp(sc - lse.reshape(b * h, s, 1)),
                    0.0)
    dd = (dof * of).sum(-1, keepdim=True)
    dvf = torch.einsum("bqk,bqd->bkd", p, dof)
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, vf.float()) - dd)
    if softcap:
        ds = ds * (1 - (sc / softcap) ** 2)
    dqf = torch.einsum("bqk,bkd->bqd", ds, kf.float()) * scale
    dkf = torch.einsum("bqk,bqd->bkd", ds, qf.float()) * scale

    def unfold(x, n, heads):
        # (B*H, n, d) -> (B, n, heads, d), summing each GQA group
        d = x.shape[-1]
        x = x.reshape(b, heads, h // heads, n, d).sum(2)
        return x.transpose(1, 2)
    return (unfold(dqf, s, h).to(q.dtype), unfold(dkf, t, kh).to(k.dtype),
            unfold(dvf, t, kh).to(v.dtype))
