"""The battery's statistical test families in PyTorch
(``repro/stats/tests.py``).

Every family has the job signature ``kernel(bits) -> (stat, p)`` with
its parameters bound statically; ``bits`` is an int64 tensor of words in
``[0, 2^32)``. Statistics and p-values are float32, as in the
reference, so both packages score the same words to the same
``(stat, p)`` within the reference's own float32 tolerance.

These are the plain versions; the six families with a hand-written
kernel behind their counting loop have accelerated twins in
``stats/backends.py``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.common.ints import popcount32, to_unit
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.stats.special import (chi2_from_counts, chi2_sf, ks_pvalue,
                                       normal_p_two_sided,
                                       poisson_midp_upper)


def _f32(x) -> torch.Tensor:
    return x.to(torch.float32)


def _count_nonzero(mask: torch.Tensor) -> torch.Tensor:
    return _f32(torch.sum(mask))


def birthday(bits, n=4096, tbits=30):
    """Birthday spacings: duplicate spacings ~ Poisson(n^3 / 4k)."""
    days = bits[:n] >> (32 - tbits)
    s = torch.sort(days).values
    spacings = torch.sort(torch.diff(s)).values
    dup = _count_nonzero(torch.diff(spacings) == 0)
    lam = n ** 3 / (4.0 * (1 << tbits))
    return dup, poisson_midp_upper(dup, lam)


def collision_mean(n: int, kbits: int) -> float:
    """Expected collisions of n balls in 2^kbits urns."""
    k = float(1 << kbits)
    return max(n - k + k * (1.0 - 1.0 / k) ** n, 1e-9)


def collision(bits, n=65536, kbits=24):
    """n balls into 2^kbits urns; collision count, Poisson upper tail."""
    urns = bits[:n] >> (32 - kbits)
    s = torch.sort(urns).values
    distinct = 1.0 + _count_nonzero(torch.diff(s) != 0)
    coll = n - distinct
    return coll, poisson_midp_upper(coll, collision_mean(n, kbits))


def gap_bins(bits, n, beta, maxlen):
    """Per-word bin of the gap test: the clipped gap length ending at a
    hit, ``maxlen + 1`` for a miss (int32)."""
    u = to_unit(bits[:n])
    hit = u < beta
    idx = torch.arange(n, device=bits.device)
    last = torch.cummax(torch.where(hit, idx, -1), dim=0).values
    prev = torch.cat([idx.new_full((1,), -1), last[:-1]])
    gaps = torch.where(hit, idx - prev - 1, -1)
    gapc = torch.clamp(gaps, -1, maxlen)
    return torch.where(hit, gapc, maxlen + 1).to(torch.int32)


def gap_stat(counts, beta, maxlen):
    """chi2 of gap-length counts against the geometric law."""
    n_hits = torch.sum(counts)
    probs = np.array([beta * (1 - beta) ** i for i in range(maxlen)]
                     + [(1 - beta) ** maxlen], np.float32)
    stat = chi2_from_counts(counts, n_hits * torch.as_tensor(  # repro: noqa RPA102 -- model probs (PERF.md §7)
        probs, device=counts.device))
    return stat, chi2_sf(stat, maxlen)


def gap(bits, n=65536, beta=0.125, maxlen=20):
    """Gaps between visits to [0, beta); chi2 vs geometric."""
    bins = gap_bins(bits, n, beta, maxlen)
    counts = histogram_ref(bins, maxlen + 2)[:maxlen + 1]
    return gap_stat(counts, beta, maxlen)


def _stirling_probs(d=8, hand=5):
    """P[r distinct among `hand` draws from d values]."""
    S = np.zeros((hand + 1, hand + 1))
    S[0, 0] = 1
    for nn in range(1, hand + 1):
        for rr in range(1, nn + 1):
            S[nn, rr] = rr * S[nn - 1, rr] + S[nn - 1, rr - 1]
    probs = []
    for r in range(1, hand + 1):
        perm = 1.0
        for j in range(r):
            perm *= (d - j)
        probs.append(S[hand, r] * perm / d ** hand)
    return np.array(probs, np.float32)


def poker_bins(bits, n, hand):
    """Per-hand bin: distinct 3-bit digits, the rare r <= 2 merged (int32)."""
    digits = (bits[:n * hand] >> 29).reshape(n, hand)
    s = torch.sort(digits, dim=1).values
    distinct = 1 + torch.sum(torch.diff(s, dim=1) != 0, dim=1)
    return (torch.clamp(distinct, min=2) - 2).to(torch.int32)


def poker_stat(counts, n, d, hand):
    """chi2 of distinct-count counts against the Stirling law."""
    probs = _stirling_probs(d, hand)
    probs = np.concatenate([[probs[0] + probs[1]], probs[2:]])
    stat = chi2_from_counts(counts, n * probs)
    return stat, chi2_sf(stat, hand - 2)


def poker(bits, n=32768, d=8, hand=5):
    """Distinct values per hand of 5 3-bit digits; chi2."""
    counts = histogram_ref(poker_bins(bits, n, hand), hand - 1)
    return poker_stat(counts, n, d, hand)


def _coupon_probs(d, maxlen):
    def p_all_seen(ln):
        tot = 0.0
        for i in range(d + 1):
            tot += (-1) ** i * math.comb(d, i) * ((d - i) / d) ** ln
        return tot
    return np.array(
        [p_all_seen(d + j) - p_all_seen(d + j - 1) for j in range(maxlen - 1)]
        + [1.0 - p_all_seen(d + maxlen - 2)], np.float32)


def coupon(bits, n=65536, d=8, maxlen=30):
    """Coupon-collector segment lengths; chi2 vs exact distribution.

    The reference scans a state machine word by word. Here the segment
    starting at word i ends at ``end(i)``, the first word by which all d
    values have been seen; segments chain ``s -> end(s) + 1`` from word
    0. The chain's members are found by pointer doubling (log2 n
    passes), which gives exactly the scan's segments."""
    dbits = int(d).bit_length() - 1
    if (1 << dbits) != d:
        raise ValueError("d must be a power of two")
    dev = bits.device
    digits = bits[:n] >> (32 - dbits)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    vals = torch.arange(d, dtype=torch.int64, device=dev)
    # next occurrence of each value at or after i (n = never)
    occ = torch.where(digits[None, :] == vals[:, None], pos[None, :], n)
    nxt = torch.flip(torch.cummin(torch.flip(occ, [1]), dim=1).values, [1])
    end = torch.max(nxt, dim=0).values              # n when incomplete
    succ = torch.cat([torch.clamp(end + 1, max=n),
                      torch.full((1,), n, dtype=torch.int64, device=dev)])
    on_chain = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    on_chain[0] = 1  # repro: noqa RPA102 -- a host int copied per call (PERF.md §7)
    jump = succ
    for _ in range(max(n, 1).bit_length()):    # S |= jump(S), jump = jump^2
        on_chain = on_chain.scatter_reduce(0, jump, on_chain, reduce="amax")
        jump = jump[jump]
    starts = (on_chain[:n] == 1) & (end < n)
    binp = torch.where(starts, torch.clamp(end - pos + 1 - d, 0, maxlen - 1),
                       maxlen).to(torch.int32)
    hist = histogram_ref(binp, maxlen + 1)[:maxlen]
    probs = _coupon_probs(d, maxlen)
    n_seg = torch.sum(hist)
    stat = chi2_from_counts(hist, n_seg * torch.as_tensor(  # repro: noqa RPA102 -- model probs (PERF.md §7)
        np.maximum(probs, 1e-12), device=dev))
    return stat, chi2_sf(stat, maxlen - 1)


def _integer_pow(x, t: int):
    """``x ** t`` by the square-and-multiply JAX's ``integer_pow`` uses."""
    acc = None
    while t > 0:
        if t & 1:
            acc = x if acc is None else acc * x
        t >>= 1
        if t:
            x = x * x
    return acc


def maxoft(bits, n=16384, t=8):
    """max(u_1..u_t)^t ~ U(0,1); KS."""
    u = to_unit(bits[:n * t]).reshape(n, t)
    m = _integer_pow(torch.max(u, dim=1).values, t)
    return torch.max(m), ks_pvalue(torch.sort(m).values)


def weight_bins(bits, n, lo=10, hi=22):
    """Hamming weight per word, clipped to [lo, hi], minus lo (int32)."""
    w = popcount32(bits[:n])
    return (torch.clamp(w, lo, hi) - lo).to(torch.int32)


def weight_stat(counts, n, lo=10, hi=22):
    """chi2 of clipped Hamming weights against Binomial(32, 1/2)."""
    probs = []
    for k in range(lo, hi + 1):
        if k == lo:
            probs.append(sum(math.comb(32, j)
                             for j in range(0, lo + 1)) / 2 ** 32)
        elif k == hi:
            probs.append(sum(math.comb(32, j)
                             for j in range(hi, 33)) / 2 ** 32)
        else:
            probs.append(math.comb(32, k) / 2 ** 32)
    stat = chi2_from_counts(counts, n * np.array(probs, np.float32))
    return stat, chi2_sf(stat, hi - lo)


def weight(bits, n=65536):
    """Hamming weights of words vs Binomial(32, 1/2); chi2."""
    return weight_stat(histogram_ref(weight_bins(bits, n), 13), n)


def gf2_rank32(mats: torch.Tensor) -> torch.Tensor:
    """GF(2) rank of (M, 32) matrices of 32-bit rows (int64 words), by the
    reference's vectorized 32-step elimination: the pivot is the first
    unused row holding the column bit."""
    m = mats.shape[0]
    dev = mats.device
    rows = mats
    used = torch.zeros((m, 32), dtype=torch.bool, device=dev)
    rank = torch.zeros((m,), dtype=torch.int32, device=dev)
    ridx = torch.arange(32, device=dev)[None, :]
    for i in range(32):
        col = ((rows >> (31 - i)) & 1) == 1
        cand = col & ~used
        has = cand.any(dim=1)
        piv = torch.argmax(cand.to(torch.int8), dim=1)
        pivrow = torch.gather(rows, 1, piv[:, None])[:, 0]
        pivrow = torch.where(has, pivrow, 0)
        is_piv = ridx == piv[:, None]
        rows = torch.where(col & ~is_piv, rows ^ pivrow[:, None], rows)
        used = used | (is_piv & has[:, None])
        rank = rank + has.to(torch.int32)
    return rank


def _rank_probs(dim=32):
    """P[rank = dim - j] for random GF(2) dim x dim; bins j=0,1,2,>=3."""
    def p_rank(r):
        p = 2.0 ** (-(dim - r) * (dim - r))
        for i in range(r):
            p *= (1 - 2.0 ** (i - dim)) ** 2 / (1 - 2.0 ** (i - r))
        return p
    full, m1, m2 = p_rank(dim), p_rank(dim - 1), p_rank(dim - 2)
    return np.array([max(1 - full - m1 - m2, 1e-12), m2, m1, full],
                    np.float32)


def rank_stat(counts, n_mats):
    """chi2 of the rank histogram over {<=29, 30, 31, 32}."""
    stat = chi2_from_counts(counts, n_mats * _rank_probs(32))
    return stat, chi2_sf(stat, 3)


def rank_bins(ranks):
    """Rank -> histogram bin {<=29, 30, 31, 32} -> 0..3 (int32)."""
    return torch.clamp(ranks - 29, 0, 3).to(torch.int32)


def rank(bits, n_mats=1024):
    """32x32 GF(2) matrix rank distribution; chi2."""
    r = gf2_rank32(bits[:n_mats * 32].reshape(n_mats, 32))
    return rank_stat(histogram_ref(rank_bins(r), 4), n_mats)


def hamcorr(bits, n=65536):
    """Lag-1 correlation of word Hamming weights; normal."""
    w = _f32(popcount32(bits[:n])) - 16.0
    z = torch.sum(w[:-1] * w[1:]) / (8.0 * math.sqrt(n - 1))
    return z, normal_p_two_sided(z)


def serial2d_bins(bits, n, d):
    """Cell of each non-overlapping pair in the d x d grid (int32)."""
    dbits = int(d).bit_length() - 1
    if (1 << dbits) != d:
        raise ValueError("d must be a power of two")
    u = bits[:2 * n]
    return ((u[0::2] >> (32 - dbits)) * d
            + (u[1::2] >> (32 - dbits))).to(torch.int32)


def serial2d_stat(counts, n, d):
    """chi2 of the cell counts against the uniform grid."""
    expected = torch.full((d * d,), n / (d * d), dtype=torch.float32,
                          device=counts.device)
    stat = chi2_from_counts(counts, expected)
    return stat, chi2_sf(stat, d * d - 1)


def serial2d(bits, n=65536, d=64):
    """Non-overlapping pairs into d x d cells; chi2."""
    return serial2d_stat(histogram_ref(serial2d_bins(bits, n, d), d * d),
                         n, d)


def pairstream(bits, n=32768, mode="corr"):
    """Inter-stream disjointness/correlation at a sub-stream seam: the
    halves ``bits[:n]`` and ``bits[n:2n]`` are adjacent sub-streams
    (modes ``corr``, ``hamcorr``, ``match``, ``shift`` as in the
    reference)."""
    a, b = bits[:n], bits[n:2 * n]
    if mode == "corr":
        # float64 sum: the products cancel, and a float32 sum's error
        # would depend on its reduction order
        ua = (to_unit(a) - 0.5).to(torch.float64)
        ub = (to_unit(b) - 0.5).to(torch.float64)
        z = _f32(torch.sum(ua * ub) * 12.0 / math.sqrt(n))
        return z, normal_p_two_sided(z)
    if mode == "hamcorr":
        wa = _f32(popcount32(a)) - 16.0
        wb = _f32(popcount32(b)) - 16.0
        z = torch.sum(wa * wb) / (8.0 * math.sqrt(n))
        return z, normal_p_two_sided(z)
    if mode == "match":
        m = _count_nonzero(a == b)
        return m, poisson_midp_upper(m, n / 2.0 ** 32)
    if mode == "shift":
        maxk = 8
        m = torch.zeros((), dtype=torch.float32, device=bits.device)
        for k in range(1, maxk + 1):
            m = m + _count_nonzero(a[n - k:] == b[:k])
        lam = sum(range(1, maxk + 1)) / 2.0 ** 32
        return m, poisson_midp_upper(m, lam)
    raise KeyError(f"unknown pairstream mode {mode!r}; "
                   "known: corr, hamcorr, match, shift")


KERNELS: Dict[str, Callable] = {
    "birthday": birthday, "collision": collision, "gap": gap,
    "poker": poker, "coupon": coupon, "maxoft": maxoft, "weight": weight,
    "rank": rank, "hamcorr": hamcorr, "serial2d": serial2d,
    "pairstream": pairstream,
}
