# repro: quarantine -- growth-seed attention kernel; unrelated to the TestU01 battery kernels
"""ctypes launchers of the CUDA flash-attention forward
(``flash_attention.cu``) and backward (``fa_bwd.cuh``).

Replaces the Pallas kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention``), with the GQA grouping and head layout of its
wrapper folded in: the kernel reads q in ``(B, S, H, dh)`` and k/v in
``(B, T, K, dh)`` through their strides.

v may have a head dim of its own, ``dv <= dh`` (MLA's 128 beside its
192-wide q and k); the output has v's. Two routes, chosen by dtype and
head dims before launch (``route``): ``"wgmma"``, the tensor-core kernel
of ``fa_hopper.cuh``, for bfloat16 at dh = dv = 64 or 128; ``"simt"``,
the CUDA-core kernel, for float32 (tensor cores would round it to TF32),
for bfloat16 at other head dims up to ``MAX_HEAD_DIM`` (192,
nemotron-4-340b's), and for any call with ``dv != dh``.

Both routes take the causal form (the default) and the Pallas kernel's
non-causal one (``causal=False``: whisper's encoder and cross
attention), and a count of real keys ``kv_len`` (default T): keys at
``kpos >= kv_len``, a ragged T's padding, are masked.

``flash_attention.launches`` counts launches,
``flash_attention.calls`` counts them by
``(B, S, T, H, K, dh, dtype, route)`` (dh is q's and k's),
``flash_attention.windowed`` counts those given a sliding window
(``window`` > 0), ``flash_attention.split_dv`` those with
``dv != dh`` and ``flash_attention.bidir`` the non-causal ones; nothing
else touches them.

``return_lse=True`` also returns each row's log-sum-exp, float32
(B, H, S), natural log, after the softcap and the mask: what the
backward recomputes the probabilities from. The output is the same,
bit for bit, with it and without it.

``flash_attention_bwd`` is the backward, three launches on the CUDA
cores for both dtypes (``fa_bwd.cuh``: D = rowsum(dO . O), then dK and
dV per kv tile over every q head of its GQA group, then dQ per q tile);
it replaces no Pallas kernel (the reference's gradient is XLA's autodiff
through its blocked attention). ``flash_attention_bwd.launches`` counts
its calls (three kernels each) and ``flash_attention_bwd.calls`` counts
them by the forward's key, ``(B, S, T, H, K, dh, dtype, "simt")``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

# the reference's tile: callers pad S and T to a multiple of it
BLOCK = 128
# the CUDA-core route's largest head dim (its DH 192 instantiation)
MAX_HEAD_DIM = 192
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 128)
_SYMBOLS = {"wgmma": "repro_flash_attention_wgmma",
            "simt": "repro_flash_attention",
            "bwd": "repro_flash_attention_bwd"}


def route(dtype: torch.dtype, dh: int, dv: int = None) -> str:
    """The kernel that takes a call: ``"wgmma"`` for bfloat16 at head
    dims dh = dv (default dh) of 64 or 128, ``"simt"`` otherwise."""
    dv = dh if dv is None else dv
    return ("wgmma" if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS
            and dv == dh else "simt")


@functools.lru_cache(maxsize=None)
def _entry(kind: str):
    fn = getattr(build.load("flash_attention"), _SYMBOLS[kind])
    if kind == "bwd":
        # dtype; q, k, v, o, dO, lse, D, dq, dk, dv; B, S, T, H, K, dh, dv
        head = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
    else:
        # dtype; q, k, v, o; B, S, T, H, K, dh, dv
        head = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    # strides; causal, kv_len; (the forward's lse); scale, softcap, window,
    # stream
    fn.argtypes = (head + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                   + ([] if kind == "bwd" else [ctypes.c_void_p])
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          scale: float, softcap: float, window: int = 0, causal: bool = True,
          kv_len: int = None, lse: torch.Tensor = None):
    """Launch route ``kind`` on inputs that ``flash_attention`` has
    checked, on q's current stream, uncounted -> (CUDA error code, o).
    v's head dim goes to the kernel right after q's and k's ``dh``;
    ``causal`` and ``kv_len`` (default T) right after the strides, then
    ``lse`` (a float32 (B, H, S) the kernel fills, or None)."""
    b, s, h, dh = q.shape
    dv = v.shape[3]
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    o = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    # shared memory: the forward's largest instantiation, fa_wgmma<128>
    # (fa_hopper.cuh Layout<128>::kBytes, 164,920 B); the CUDA-core
    # route's largest, fa_fwd<float, 192, 192>, takes 164,864 B, and
    # fa_fwd<float, 192, 128> 148,480 B. The backward's (``_call_bwd``)
    # bound the directory: 214,784 B
    # repro: vmem-bound 41230
    with torch.cuda.device(q.device):
        rc = _entry(kind)(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), o.data_ptr(), b, s, k.shape[1], h,
                          k.shape[2], dh, dv, *strides, int(bool(causal)),
                          int(k.shape[1] if kv_len is None else kv_len),
                          None if lse is None else lse.data_ptr(),
                          float(scale), float(softcap), int(window),
                          torch.cuda.current_stream(q.device).cuda_stream)
    return rc, o


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           causal: bool, kv_len) -> tuple:
    """The checks both launchers make before they launch anything ->
    (route, kv_len): dtypes, layouts, shapes, the mask's arguments and
    the device; raises on what the kernels do not take."""
    if not 0 <= window < 2 ** 31:
        raise ValueError(f"window {window} is not in [0, 2^31) (0 is no "
                         f"window)")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel needs q, k, v of one "
                            f"of {sorted(map(str, DTYPES))}, got {name} "
                            f"{t.dtype} with q {q.dtype}")
        st = t.stride()
        if len(st) != 4 or st[3] != 1:
            raise ValueError(f"flash_attention kernel needs 4-d {name} with "
                             f"a contiguous last dim, got {tuple(t.shape)} "
                             f"strides {st}")
        strides += st[:3]
    b, s, h, dh = q.shape
    t_len, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != dh
            or not 0 < dv <= dh):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B,S,H,dh) / "
                         f"(B,T,K,dh) / (B,T,K,dv) with 0 < dv <= dh")
    kv_len = t_len if kv_len is None else kv_len
    if not 0 < kv_len <= t_len:
        raise ValueError(f"kv_len {kv_len} is not in (0, T={t_len}]")
    if window and (not causal or kv_len != t_len):
        raise ValueError(f"a window needs the causal form over all T keys, "
                         f"got causal={causal}, kv_len={kv_len}, T={t_len}")
    if window and s > t_len:
        raise ValueError(f"a window needs S <= T, got S={s}, T={t_len}: "
                         f"a query past T + window - 1 has no key")
    if kh == 0 or h % kh:
        raise ValueError(f"H={h} is not a multiple of K={kh}")
    if s % BLOCK or t_len % BLOCK or s == 0 or t_len == 0:
        raise ValueError(f"S={s} and T={t_len} must be positive multiples "
                         f"of {BLOCK} (ops.mha pads)")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} is not in (0, {MAX_HEAD_DIM}], "
                         f"the kernel's range")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    kind = route(q.dtype, dh, dv)
    # TMA: 16-byte aligned starts; bf16 strides of whole 16 bytes
    if kind == "wgmma" and (any(t.data_ptr() % 16 for t in (q, k, v))
                            or any(st % 8 for st in strides)):
        raise ValueError(f"the tensor-core route needs q, k, v on a 16-byte "
                         f"boundary with strides of whole 16 bytes, got "
                         f"strides {q.stride()}, {k.stride()}, {v.stride()}")
    return kind, kv_len


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, softcap: float = 0.0, window: int = 0,
                    causal: bool = True, kv_len: int = None,
                    return_lse: bool = False):
    """Attention. q: (B, S, H, dh), k: (B, T, K, dh), v: (B, T, K, dv)
    CUDA tensors, all float32 or all bfloat16, H % K == 0, S and T
    multiples of BLOCK, 0 < dv <= dh <= MAX_HEAD_DIM (192), each with a
    contiguous last dim -> o: contiguous (B, S, H, dv) in q's dtype, and
    with ``return_lse`` also (o, lse), lse float32 (B, H, S): each row's
    log-sum-exp (natural log, after the softcap and the mask); o is the
    same either way. Keys at ``kpos >= kv_len`` (default T; 0 < kv_len
    <= T) are masked. ``causal`` also masks ``kpos > qpos``;
    ``causal=False`` is the non-causal form. ``window`` 0 is no window;
    w > 0 (causal form, kv_len = T) keeps only the keys with ``0 <= qpos
    - kpos < w`` (a window of at least S is the causal mask), and needs
    S <= T. On the ``wgmma`` route the tensors must also start on 16
    bytes and have strides of whole 16 bytes (TMA)."""
    kind, kv_len = _check(q, k, v, window, causal, kv_len)
    b, s, h, dh = q.shape
    t_len, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc, o = _call(kind, q, k, v, scale, softcap, window, causal, kv_len, lse)
    if rc:
        raise RuntimeError(f"flash_attention kernel ({kind}) launch failed: "
                           f"CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.calls[(b, s, t_len, h, kh, dh, str(q.dtype), kind)] += 1
    if window:
        flash_attention.windowed += 1
    if dv != dh:
        flash_attention.split_dv += 1
    if not causal:
        flash_attention.bidir += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention.calls = collections.Counter()
flash_attention.windowed = 0
flash_attention.split_dv = 0
flash_attention.bidir = 0


def _call_bwd(q, k, v, o, lse, do, scale, softcap, window, causal, kv_len):
    """Launch the backward on inputs that ``flash_attention_bwd`` has
    checked, on q's current stream, uncounted -> (CUDA error code, dq,
    dk, dv). D goes through a float32 (B, H, S) scratch."""
    b, s, h, dh = q.shape
    t_len, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t_len, kh, dh), dtype=q.dtype, device=q.device)
    dvo = torch.empty((b, t_len, kh, dv), dtype=q.dtype, device=q.device)
    # shared memory: fa_bwd.cuh smem_bytes<float, 192, 192>, 214,784 B
    # (fa_bwd_dkdv and fa_bwd_dq); the largest of the directory
    # repro: vmem-bound 53696
    with torch.cuda.device(q.device):
        rc = _entry("bwd")(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(), b, s, t_len, h, kh,
            dh, dv, *strides, int(bool(causal)), int(kv_len), float(scale),
            float(softcap), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    return rc, dq, dk, dvo


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, scale: float, softcap: float = 0.0,
                        window: int = 0, causal: bool = True,
                        kv_len: int = None):
    """The backward of ``flash_attention``: q, k, v as it takes them, its
    output o and ``lse`` (from ``return_lse=True``), and the output's
    gradient do (B, S, H, dv) -> (dq (B, S, H, dh), dk (B, T, K, dh),
    dv (B, T, K, dv)), contiguous, in q's dtype; dk and dv summed over
    each GQA group, 0 at keys at or past ``kv_len``. Three launches on
    the CUDA cores (``fa_bwd.cuh``), float32 sums, no atomics: the same
    inputs give the same bits. o and do are made contiguous here."""
    kind, kv_len = _check(q, k, v, window, causal, kv_len)
    b, s, h, dh = q.shape
    t_len, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("o", o), ("do", do)):
        if (t.shape != (b, s, h, dv) or t.dtype != q.dtype
                or t.device != q.device):
            raise ValueError(f"flash_attention_bwd needs {name} of shape "
                             f"{(b, s, h, dv)} in {q.dtype} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd needs lse contiguous float32 "
                         f"{(b, h, s)} on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} {lse.device}")
    rc, dq, dk, dvo = _call_bwd(q, k, v, o.contiguous(), lse,
                                do.contiguous(), scale, softcap, window,
                                causal, kv_len)
    if rc:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {rc}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.calls[(b, s, t_len, h, kh, dh, str(q.dtype),
                               "simt")] += 1
    return dq, dk, dvo


flash_attention_bwd.launches = 0
flash_attention_bwd.calls = collections.Counter()
