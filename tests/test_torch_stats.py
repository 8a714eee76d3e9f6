"""PyTorch port: p-value machinery and the 11 test families against the
JAX reference.

Special functions run in-process (float32, no 64-bit mode needed); the
families run as the reference's pool runs them, under its 64-bit trace,
in ``test_torch_reference.py``'s subprocess. Inputs are uint32 words
made from a seed with numpy; both packages get the same words.
"""
import math

import numpy as np
import pytest
import torch

from test_torch_reference import (ATOL, EPS32, RTOL, assert_stat_p,
                                  gamma_tolerance, run_reference)

from repro_torch.stats import backends as TB
from repro_torch.stats import special as TS

N_ROWS = 4            # word rows per case; row 3 has bit 0 stuck at 0
N_WORDS = 40000

CASES = [
    ("birthday", {"n": 512, "tbits": 20}),
    ("collision", {"n": 4096, "kbits": 16}),      # histogram path
    ("collision", {"n": 4096, "kbits": 20}),      # sort path
    ("gap", {"n": 8192, "beta": 0.125}),
    ("gap", {"n": 4096, "beta": 0.0625}),
    ("poker", {"n": 2048}),
    ("coupon", {"n": 8192, "d": 8}),
    ("coupon", {"n": 4096, "d": 16}),
    ("coupon", {"n": 2048, "d": 4}),
    ("maxoft", {"n": 2048, "t": 8}),
    ("maxoft", {"n": 1024, "t": 16}),
    ("weight", {"n": 8192}),
    ("rank", {"n_mats": 300}),
    ("hamcorr", {"n": 8192}),
    ("serial2d", {"n": 8192, "d": 64}),
    ("serial2d", {"n": 4096, "d": 16}),
    ("pairstream", {"n": 4096, "mode": "corr"}),
    ("pairstream", {"n": 4096, "mode": "hamcorr"}),
    ("pairstream", {"n": 4096, "mode": "match"}),
    ("pairstream", {"n": 4096, "mode": "shift"}),
]
BACKENDS = ("reference", "accelerated")


def _bits():
    rows = []
    for seed in range(N_ROWS):
        w = np.random.default_rng(1000 + seed).integers(
            0, 2 ** 32, size=N_WORDS, dtype=np.uint64).astype(np.uint32)
        if seed == N_ROWS - 1:
            w &= np.uint32(0xFFFFFFFE)      # a defective source
        rows.append(w)
    # a seam duplicated at offset: pairstream match/shift must notice
    rows[1][4096:4096 + 8] = rows[1][4096 - 8:4096]
    return np.stack(rows)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_stats")
    bits = _bits()
    np.save(d / "bits.npy", bits)
    (res,) = run_reference([{"kind": "families", "bits": str(d / "bits.npy"),
                             "cases": CASES, "backends": list(BACKENDS)}],
                           str(d / "out"))
    return bits, {(k, json_key(p), b, row): (s, pv)
                  for k, p, b, row, s, pv in res}


def json_key(params):
    return tuple(sorted(params.items()))


def _stat_atol(kname, params, words):
    """pairstream corr sums products that cancel: its float32 sum in the
    reference carries ~eps32 * log2(n) * sum|terms| of order-dependent
    rounding, scaled by 12/sqrt(n). Every other statistic is a sum of
    integers or of same-signed terms, held to the contract."""
    if kname != "pairstream" or params["mode"] != "corr":
        return ATOL
    n = params["n"]
    u = (words[:2 * n] >> 8).astype(np.float64) / (1 << 24) - 0.5
    return ATOL + EPS32 * math.log2(n) * np.abs(u[:n] * u[n:]).sum() \
        * 12.0 / math.sqrt(n)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kname", sorted({k for k, _ in CASES}))
def test_family_matches_reference(ref, kname, backend):
    """(stat, p) of every family, both backends, equal the reference's
    within its tolerance; the accelerated families take their kernels'
    plain versions here (CPU tensors)."""
    bits, table = ref
    for k, params in CASES:
        if k != kname:
            continue
        fn = TB.get_kernel(kname, backend, device="cpu")
        for row in range(N_ROWS):
            words = bits[row]
            s, p = fn(torch.from_numpy(words.astype(np.int64)), **params)
            got = (float(s.to(torch.float32)), float(p.to(torch.float32)))
            want = table[(kname, json_key(params), backend, row)]
            assert_stat_p(kname, params, want, got, f"{backend} row {row}",
                          stat_atol=_stat_atol(kname, params, words))


def test_backends_registry(monkeypatch):
    accelerated = [k for k in sorted(TB.T.KERNELS)
                   if TB.get_kernel(k, "accelerated")
                   is not TB.get_kernel(k, "reference")]
    assert accelerated == ["collision", "gap", "poker", "rank", "serial2d",
                           "weight"]
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    assert TB.resolve("auto", "cuda") == "accelerated"
    assert TB.resolve("auto", "cpu") == "reference"
    assert TB.get_kernel("coupon", "accelerated") is TB.get_kernel("coupon")
    with pytest.raises(KeyError):
        TB.resolve("fast")


@pytest.mark.parametrize("device,capability,want", [
    ("cuda", (9, 0), "accelerated"),      # Hopper: the kernels' sm_90a
    ("cuda:1", (9, 0), "accelerated"),
    ("cuda", (8, 0), "reference"),        # Ampere: sm_90a does not run
    ("cuda", (10, 0), "reference"),
    ("cpu", None, "reference")])
def test_auto_backend_needs_hopper(monkeypatch, device, capability, want):
    """``auto`` takes the kernels only on a CUDA device of compute
    capability 9.0 (stubbed here), and never asks a CPU device for one;
    explicit names are kept as given on any device."""
    asked = []

    def capability_of(dev=None):
        asked.append(torch.device(dev))
        if capability is None:
            raise AssertionError("a CPU device has no compute capability")
        return capability
    monkeypatch.setattr(torch.cuda, "get_device_capability", capability_of)
    assert TB.resolve("auto", device) == want
    assert asked == ([] if capability is None else [torch.device(device)])
    for name in ("reference", "accelerated"):
        assert TB.resolve(name, device) == name
    auto = TB.get_kernel("gap", "auto", device)
    assert auto is TB.get_kernel("gap", want)


def test_coupon_segments_match_a_scan():
    """The pointer-doubling coupon collector finds exactly the segments
    of the word-by-word state machine."""
    words = np.random.default_rng(3).integers(0, 2 ** 32, size=3000,
                                              dtype=np.uint64)
    d, maxlen = 8, 30
    hist = np.zeros(maxlen)
    mask = ln = 0
    for w in words:
        mask |= 1 << int(w >> np.uint64(29))
        ln += 1
        if mask == (1 << d) - 1:
            hist[min(max(ln - d, 0), maxlen - 1)] += 1
            mask = ln = 0
    probs = TB.T._coupon_probs(d, maxlen)
    n_seg = hist.sum()
    expected = n_seg * np.maximum(probs, 1e-12).astype(np.float32)
    want = float(np.sum((hist - expected) ** 2 / expected))
    s, _ = TB.T.coupon(torch.from_numpy(words.astype(np.int64)), n=3000,
                       d=d, maxlen=maxlen)
    assert math.isclose(float(s), want, rel_tol=1e-5)


# -- special functions in-process, float32 as the reference computes them

def _jax_special():
    from repro.stats import special
    return special


def test_chi2_sf_matches_reference():
    RS = _jax_special()
    rng = np.random.default_rng(0)
    for k in (3, 12, 20, 29, 255, 4095):
        x = (k * rng.uniform(0.3, 2.0, 64)).astype(np.float32)
        want = np.asarray(RS.chi2_sf(x, k))
        got = TS.chi2_sf(torch.from_numpy(x), k).numpy()
        assert got.dtype == np.float32
        for xi, w, g in zip(x, want, got):
            assert abs(g - w) <= gamma_tolerance(k / 2.0, xi / 2.0, w), \
                (k, xi, w, g)


def test_poisson_midp_matches_reference():
    RS = _jax_special()
    for lam in (0.5, 2.0, 32.0, 128.0):
        k = np.arange(0, int(3 * lam) + 5, dtype=np.float32)
        want = np.asarray(RS.poisson_midp_upper(k, lam))
        got = TS.poisson_midp_upper(torch.from_numpy(k), lam).numpy()
        for ki, w, g in zip(k, want, got):
            assert abs(g - w) <= gamma_tolerance(ki + 1.0, lam, w), \
                (lam, ki, w, g)


def test_normal_and_ks_match_reference():
    RS = _jax_special()
    z = np.linspace(-6, 6, 97).astype(np.float32)
    np.testing.assert_allclose(
        TS.normal_p_two_sided(torch.from_numpy(z)).numpy(),
        np.asarray(RS.normal_p_two_sided(z)), rtol=RTOL, atol=ATOL)
    u = np.sort(np.random.default_rng(2).uniform(size=500)).astype(np.float32)
    np.testing.assert_allclose(float(TS.ks_pvalue(torch.from_numpy(u))),
                               float(RS.ks_pvalue(u)), rtol=RTOL, atol=ATOL)
    for lam in (0.2, 0.8, 1.3, 2.5):
        np.testing.assert_allclose(
            float(TS.kolmogorov_sf(torch.tensor(lam, dtype=torch.float32))),
            float(RS.kolmogorov_sf(np.float32(lam))), rtol=RTOL, atol=ATOL)
    c = np.random.default_rng(4).poisson(9.0, 50).astype(np.float32)
    e = np.full(50, 9.0, np.float32)
    np.testing.assert_allclose(
        float(TS.chi2_from_counts(torch.from_numpy(c), e)),
        float(RS.chi2_from_counts(c, e)), rtol=RTOL, atol=ATOL)
