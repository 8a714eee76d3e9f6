"""ctypes launcher of the CUDA flash-attention forward
(``flash_attention.cu``).

Replaces the Pallas kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention``), with the GQA grouping and head layout of its
wrapper folded in: the kernel reads q in ``(B, S, H, dh)`` and k/v in
``(B, T, K, dh)`` through their strides.

Two routes, chosen by dtype and head dim before launch (``route``):
``"wgmma"``, the tensor-core kernel of ``fa_hopper.cuh``, for bfloat16
at head dims 64 and 128; ``"simt"``, the CUDA-core kernel, for float32
(tensor cores would round it to TF32) and for bfloat16 at other head
dims. ``flash_attention.launches`` counts launches and
``flash_attention.calls`` counts them by
``(B, S, T, H, K, dh, dtype, route)``; nothing else touches either.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

# the reference's tile: callers pad S and T to a multiple of it
BLOCK = 128
MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 128)
_SYMBOLS = {"wgmma": "repro_flash_attention_wgmma",
            "simt": "repro_flash_attention"}


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel that takes a call: ``"wgmma"`` for bfloat16 at head
    dims 64 and 128, ``"simt"`` otherwise."""
    return ("wgmma" if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS
            else "simt")


@functools.lru_cache(maxsize=None)
def _entry(kind: str):
    fn = getattr(build.load("flash_attention"), _SYMBOLS[kind])
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          scale: float, softcap: float):
    """Launch route ``kind`` on inputs that ``flash_attention`` has
    checked, on q's current stream, uncounted -> (CUDA error code, o)."""
    b, s, h, dh = q.shape
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    o = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _entry(kind)(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), o.data_ptr(), b, s, k.shape[1], h,
                          k.shape[2], dh, *strides, float(scale),
                          float(softcap),
                          torch.cuda.current_stream(q.device).cuda_stream)
    return rc, o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, softcap: float = 0.0) -> torch.Tensor:
    """Causal attention. q: (B, S, H, dh), k/v: (B, T, K, dh) CUDA
    tensors, all float32 or all bfloat16, H % K == 0, S and T multiples
    of BLOCK, dh <= 128, each with a contiguous last dim -> o: contiguous
    (B, S, H, dh) in q's dtype. On the ``wgmma`` route the tensors must
    also start on 16 bytes and have strides of whole 16 bytes (TMA)."""
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
    t_len, kh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B,S,H,dh) / "
                         f"(B,T,K,dh)")
    if kh == 0 or h % kh:
        raise ValueError(f"H={h} is not a multiple of K={kh}")
    if s % BLOCK or t_len % BLOCK or s == 0 or t_len == 0:
        raise ValueError(f"S={s} and T={t_len} must be positive multiples "
                         f"of {BLOCK} (ops.mha pads)")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} is above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    kind = route(q.dtype, dh)
    # TMA: 16-byte aligned starts; bf16 strides of whole 16 bytes
    if kind == "wgmma" and (any(t.data_ptr() % 16 for t in (q, k, v))
                            or any(st % 8 for st in strides)):
        raise ValueError(f"the tensor-core route needs q, k, v on a 16-byte "
                         f"boundary with strides of whole 16 bytes, got "
                         f"strides {q.stride()}, {k.stride()}, {v.stride()}")
    rc, o = _call(kind, q, k, v, scale, softcap)
    if rc:
        raise RuntimeError(f"flash_attention kernel ({kind}) launch failed: "
                           f"CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.calls[(b, s, t_len, h, kh, dh, str(q.dtype), kind)] += 1
    return o


flash_attention.launches = 0
flash_attention.calls = collections.Counter()
