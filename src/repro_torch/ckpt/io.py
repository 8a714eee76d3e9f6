"""Checkpoint IO: a flat list of leaves in the reference's msgpack layout
(``repro/ckpt/io.py``), without ``msgpack`` or ``jax``.

A file is a msgpack map ``{"leaves": [...], "treedef": "PyTreeDef([*,
...])"}``. A numpy leaf (array or scalar) is the map ``{b"__nd__": true,
b"d": <bytes>, b"t": dtype.str, b"s": [shape...]}``; other leaves are
plain msgpack values. ``save`` writes exactly the bytes the reference's
``msgpack.packb(..., use_bin_type=True)`` writes for the same list of
leaves (the smallest encoding of every integer, float64 for floats,
str8 and bin types), so the two packages' files are byte-identical, and
``load_flat`` reads any file either package wrote. The treedef string is
written as jax prints a list of leaves and ignored on read, as the
reference ignores it.
"""
from __future__ import annotations

import os
import struct
import tempfile
from typing import Any, List

import numpy as np


# ---------------------------------------------------------------------------
# msgpack: the subset the format uses (no extension types)

def _pack_int(v: int, out: bytearray) -> None:
    if v < -(1 << 5):
        if v < -(1 << 63):
            raise OverflowError(f"integer {v} does not fit msgpack")
        for lim, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                               (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
    if v < (1 << 7):
        out += struct.pack(">b", v)         # positive or negative fixint
        return
    for lim, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                           (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
        if v < lim:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form from ``codes`` (``None`` where the type has none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for lim, code, fmt in zip((1 << 8, 1 << 16, 1 << 32), codes,
                              (">B", ">H", ">I")):
        if code is not None and n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        obj = {b"__nd__": True, b"d": a.tobytes(), b"t": a.dtype.str,
               b"s": list(a.shape)}
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} in a "
                        f"checkpoint")


def packb(obj) -> bytes:
    """``obj`` in msgpack, as ``msgpack.packb(obj, use_bin_type=True)``
    writes it (numpy values as ``__nd__`` maps)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    """msgpack decoder over one buffer; strings come back as bytes (the
    reference reads with ``raw=True``)."""

    _FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
              0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
              0xCA: ">f", 0xCB: ">d"}
    _LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}

    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        chunk = self.buf[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def _num(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F or b >= 0xE0:
            return b if b <= 0x7F else b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self._take(b & 0x1F))
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in self._FIXED:
            return self._num(self._FIXED[b])
        if b in self._LEN:
            n = self._num(self._LEN[b])
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self._map(n)
            return bytes(self._take(n))     # bin or str
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(blob: bytes):
    """Decode one msgpack value (strings as bytes); trailing bytes are an
    error."""
    r = _Reader(blob)
    v = r.value()
    if r.pos != len(blob):
        raise ValueError("extra bytes after the msgpack value")
    return v


def _unpack_leaf(obj):
    if isinstance(obj, dict) and obj.get(b"__nd__"):
        return np.frombuffer(obj[b"d"], dtype=np.dtype(obj[b"t"].decode())
                             ).reshape(obj[b"s"]).copy()
    return obj


# ---------------------------------------------------------------------------
# files

def save(path: str, leaves: List[Any]) -> None:
    """Write a list of leaves atomically (a temporary file in the same
    directory, then ``os.replace``): a crash mid-save never corrupts the
    previous checkpoint."""
    if not isinstance(leaves, list):
        raise TypeError(f"a checkpoint is a list of leaves, got "
                        f"{type(leaves).__name__}")
    if any(x is None for x in leaves):
        raise TypeError("a checkpoint leaf cannot be None")
    treedef = "PyTreeDef([" + ", ".join("*" * len(leaves)) + "])"
    _write(path, packb({"leaves": list(leaves), "treedef": treedef}))


def _write(path: str, blob: bytes) -> None:
    """``blob`` to ``path`` atomically: a temporary file in the same
    directory, then ``os.replace``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    with os.fdopen(fd, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_flat(path: str) -> list:
    """The list of leaves (the caller applies its own structure)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    return [_unpack_leaf(x) for x in payload[b"leaves"]]


def exists(path: str) -> bool:
    return os.path.exists(path)


# ---------------------------------------------------------------------------
# trees of tensors (the training state): the reference's save(path, tree)

def treedef(tree) -> str:
    """The string jax prints for the structure of a tree of nested dicts
    (keys in sorted order, ``*`` for a leaf), as the reference writes it."""
    def render(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({render(tree)})"


def _tensor_leaf(t):
    """A tensor as the leaf the reference writes for the same array:
    numpy for the dtypes numpy has; bfloat16 as its raw 2-byte words
    under ``ml_dtypes``' type string ``<V2``."""
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return {b"__nd__": True, b"d": t.view(torch.int16).numpy().tobytes(),
                b"t": "<V2", b"s": list(t.shape)}
    return t.numpy()


def save_tree(path: str, tree) -> None:
    """``tree`` (nested dicts of tensors, numpy arrays or scalars) in the
    reference's layout: its leaves in sorted key order and its treedef
    string, so the file is byte for byte the one ``repro.ckpt.io.save``
    writes for the same arrays."""
    import torch
    flat = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            flat.append(_tensor_leaf(t) if isinstance(t, torch.Tensor) else t)
    walk(tree)
    _write(path, packb({"leaves": flat, "treedef": treedef(tree)}))


def load_into(path: str, template):
    """A file either package wrote, in the structure of ``template``
    (nested dicts of tensors): each leaf a tensor of its template leaf's
    shape, dtype and device (a ``<V2`` leaf is read as bfloat16 words)."""
    import torch
    it = iter(load_flat(path))

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        a = next(it)
        if a.dtype.kind == "V":
            x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(a)
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(x.shape)} "
                             f"where the template has {tuple(t.shape)}")
        return x.to(device=t.device, dtype=t.dtype)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError(f"{path} holds more leaves than the template")
    return out
