"""Kernel backend registry (``repro/stats/backends.py``): every test
family behind one ``bits -> (stat, p)`` signature, with a ``reference``
(plain PyTorch, ``stats/tests.py``) and, where a hand-written kernel
covers the counting loop, an ``accelerated`` implementation:

  gap / poker / weight / serial2d / collision
      -> ``kernels/histogram`` (collision only up to ``HIST_MAX_BINS``
         urns; larger urn spaces keep the sort-based path)
  rank
      -> ``kernels/gf2_rank``, with its 4-bin histogram on
         ``kernels/histogram``

Families without a kernel (birthday, coupon, maxoft, hamcorr,
pairstream) take their reference under ``accelerated``. The kernel
wrappers launch the CUDA kernel for a CUDA tensor and take the plain
version for a CPU tensor, so the accelerated families also run (and are
tested) on the CPU.

Backend names: ``reference``, ``accelerated``, and ``auto``, which is
``accelerated`` on a CUDA device of compute capability 9.0 (Hopper, the
only target the kernels are built for: ``sm_90a``) and ``reference``
elsewhere, as the reference resolves ``auto`` to its kernels only on a
TPU. An explicit ``accelerated`` on another card is kept as asked, and
fails when the kernels build or launch.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.kernels.gf2_rank.ops import rank32
from repro_torch.kernels.histogram.ops import bincount
from repro_torch.stats import tests as T
from repro_torch.stats.special import poisson_midp_upper

BACKENDS = ("auto", "reference", "accelerated")

# Largest urn space collision sends to the histogram kernel (the
# reference's bound). The kernel keeps up to CLUSTER_MAX_BINS (2^17) bins
# in the shared memory of a thread-block cluster
# (kernels/histogram/kernel.py::plan), so 2^16 urns stay on chip.
HIST_MAX_BINS = 1 << 16

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register(kname: str, backend: str, fn: Callable) -> None:
    """Register ``fn(bits, **params) -> (stat, p)`` as the ``backend``
    implementation of family ``kname``."""
    if backend not in ("reference", "accelerated"):
        raise KeyError(f"backend must be reference|accelerated, "
                       f"got {backend!r}")
    _REGISTRY.setdefault(kname, {})[backend] = fn  # repro: noqa RPA103 -- registration at import


# compute capability the kernels are built for (kernels/build.py: sm_90a)
KERNEL_CAPABILITY = (9, 0)


def resolve(backend: str,
            device: Optional[Union[str, torch.device]] = "cuda") -> str:
    """Map a backend name to a concrete one; ``auto`` is ``accelerated``
    only on a CUDA device of compute capability ``KERNEL_CAPABILITY``."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend != "auto":
        return backend
    device = torch.device(device)
    if (device.type == "cuda" and tuple(torch.cuda.get_device_capability(
            device)) == KERNEL_CAPABILITY):
        return "accelerated"
    return "reference"


def get_kernel(kname: str, backend: str = "reference",
               device: Optional[Union[str, torch.device]] = "cuda"
               ) -> Callable:
    """The family's implementation under ``backend``; a family without
    an accelerated implementation falls back to its reference."""
    impls = _REGISTRY[kname]
    b = resolve(backend, device)
    return impls.get(b, impls["reference"])


# ---------------------------------------------------------------------------
# accelerated implementations: the counting loops on the kernels, the
# probability models shared with stats/tests.py


def gap_accel(bits, n=65536, beta=0.125, maxlen=20):
    """`gap` with the gap-length histogram on the bin-count kernel."""
    counts = bincount(T.gap_bins(bits, n, beta, maxlen), maxlen + 2)
    return T.gap_stat(counts[:maxlen + 1], beta, maxlen)


def poker_accel(bits, n=32768, d=8, hand=5):
    """`poker` with the distinct-count histogram on the bin-count kernel."""
    return T.poker_stat(bincount(T.poker_bins(bits, n, hand), hand - 1),
                        n, d, hand)


def weight_accel(bits, n=65536):
    """`weight` with the Hamming-weight histogram on the bin-count kernel."""
    return T.weight_stat(bincount(T.weight_bins(bits, n), 13), n)


def serial2d_accel(bits, n=65536, d=64):
    """`serial2d` with the cell histogram on the bin-count kernel."""
    return T.serial2d_stat(bincount(T.serial2d_bins(bits, n, d), d * d),
                           n, d)


def collision_accel(bits, n=65536, kbits=24):
    """`collision` with urn occupancy on the bin-count kernel: distinct
    urns = occupied bins, no sort. Urn spaces above ``HIST_MAX_BINS``
    keep the sort-based reference."""
    k = 1 << kbits
    if k > HIST_MAX_BINS:
        return T.collision(bits, n=n, kbits=kbits)
    urns = (bits[:n] >> (32 - kbits)).to(torch.int32)
    distinct = torch.sum(bincount(urns, k) > 0).to(torch.float32)
    coll = n - distinct
    return coll, poisson_midp_upper(coll, T.collision_mean(n, kbits))


def rank_accel(bits, n_mats=1024):
    """`rank` on the GF(2) rank kernel, its 4-bin histogram on the
    bin-count kernel."""
    r = rank32(bits[:n_mats * 32].reshape(n_mats, 32))
    return T.rank_stat(bincount(T.rank_bins(r), 4), n_mats)


for _k, _fn in T.KERNELS.items():
    register(_k, "reference", _fn)

for _k, _fn in {"gap": gap_accel, "poker": poker_accel,
                "weight": weight_accel, "serial2d": serial2d_accel,
                "collision": collision_accel, "rank": rank_accel}.items():
    register(_k, "accelerated", _fn)
