"""PyTorch port: the histogram and GF(2)-rank kernels' wrappers against
the JAX reference's Pallas kernels (interpret mode, in-process: int32
and uint32 inputs need no 64-bit mode) and their oracles.

On the CPU the wrappers take the plain versions; the CUDA kernels
themselves are held against those plain versions on the card by the
``cuda``-marked tests below (skipped without a card) and by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gf2_rank import kernel as gk
from repro_torch.kernels.gf2_rank.ops import rank32
from repro_torch.kernels.gf2_rank.ref import gf2_rank_ref
from repro_torch.kernels.histogram import kernel as hk
from repro_torch.kernels.histogram.ops import bincount
from repro_torch.kernels.histogram.ref import histogram_ref


def _idx(seed, n, k):
    return np.random.default_rng(seed).integers(0, k, size=n, dtype=np.int32)


def _mats(seed, m):
    """(m, 32) uint32 rows; a third of the matrices are made
    rank-deficient (zero rows, repeated rows, XOR combinations)."""
    rng = np.random.default_rng(seed)
    mats = rng.integers(0, 2 ** 32, size=(m, 32), dtype=np.uint64)
    mats = mats.astype(np.uint32)
    for i in range(0, m, 3):
        r = rng.integers(1, 8)
        if i % 2:
            mats[i, :r] = 0
        else:
            mats[i, -r:] = mats[i, :r] ^ mats[i, r:2 * r]
    mats[1::7] = mats[1::7] & np.uint32(0x0000FFFF)       # low rank
    return mats


def _words(mats):
    return torch.from_numpy(mats.astype(np.int64))


@pytest.mark.parametrize("n,k", [(2048, 4), (5000, 13), (4096, 22),
                                 (3000, 4096), (2048, 1)])
def test_bincount_matches_pallas_histogram(n, k):
    """Counts equal the reference Pallas kernel's (interpret mode), and
    its oracle's, bitwise."""
    from repro.kernels.histogram.ops import bincount as ref_bincount
    from repro.kernels.histogram.ref import histogram_ref as jax_ref
    idx = _idx(n + k, n, k)
    got = bincount(torch.from_numpy(idx), k).numpy()
    assert got.dtype == np.float32 and got.shape == (k,)
    np.testing.assert_array_equal(
        got, np.asarray(ref_bincount(idx, k, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_ref(idx, k)))


def test_bincount_padding_rule():
    """N is padded to a CHUNK multiple with the index k, whose extra bin
    is dropped; N already a multiple is not padded."""
    for n in (1, hk.CHUNK - 1, hk.CHUNK, hk.CHUNK + 1):
        idx = _idx(n, n, 7)
        np.testing.assert_array_equal(
            bincount(torch.from_numpy(idx), 7).numpy(),
            np.bincount(idx, minlength=7).astype(np.float32))


@pytest.mark.parametrize("m", [256, 300, 1000])
def test_rank32_matches_pallas_gf2_rank(m):
    """Ranks equal the reference Pallas kernel's (interpret mode) and
    its oracle ``gf2_rank32``, bitwise, rank-deficient matrices
    included."""
    from repro.kernels.gf2_rank.ops import rank32 as ref_rank32
    from repro.stats.tests import gf2_rank32 as jax_gf2_rank32
    mats = _mats(m, m)
    got = rank32(_words(mats)).numpy()
    assert got.dtype == np.int32 and got.shape == (m,)
    np.testing.assert_array_equal(
        got, np.asarray(ref_rank32(mats, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_gf2_rank32(mats)))
    assert got.min() < 29 and got.max() == 32


def test_rank32_edge_matrices():
    eye = np.array([1 << (31 - i) for i in range(32)], np.uint32)
    mats = np.stack([np.zeros(32, np.uint32), eye, np.full(32, 1, np.uint32),
                     np.roll(eye, 5)])
    np.testing.assert_array_equal(rank32(_words(mats)).numpy(),
                                  [0, 32, 1, 32])
    np.testing.assert_array_equal(gf2_rank_ref(_words(mats)).numpy(),
                                  [0, 32, 1, 32])


def test_wrappers_validate_inputs():
    launches = (hk.histogram.launches, gk.gf2_rank.launches)
    with pytest.raises(TypeError):
        bincount(torch.zeros(10, dtype=torch.int64), 4)
    with pytest.raises(TypeError):
        rank32(torch.zeros((4, 31), dtype=torch.int64))
    # the launchers take CUDA tensors only; a CPU tensor never reaches
    # (or builds) the kernel
    with pytest.raises(ValueError, match="CUDA"):
        hk.histogram(torch.zeros(hk.CHUNK, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gf2_rank(torch.zeros((gk.TILE_M, 32), dtype=torch.int32))
    assert (hk.histogram.launches, gk.gf2_rank.launches) == launches


def test_build_hash_covers_every_kernel_source(monkeypatch, tmp_path):
    """A kernel's library path hashes every ``*.cu`` and ``*.cuh`` of its
    directory and the flags: editing an included header, adding a
    header or changing a flag gives a new library; a file of another
    kind or another kernel's directory does not."""
    from repro_torch.kernels import build
    src = tmp_path / "k"
    src.mkdir()
    (src / "k.cu").write_text('#include "tile.cuh"\n')
    (src / "tile.cuh").write_text("// v1\n")
    (tmp_path / "other").mkdir()
    monkeypatch.setattr(build, "KERNEL_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "SOURCES", {"k": src / "k.cu"})
    first = build.library_path("k")
    assert first.parent == tmp_path / "_build" and first.name.startswith("k-")
    assert build.library_path("k") == first
    (src / "notes.txt").write_text("not a source")
    (tmp_path / "other" / "x.cuh").write_text("// elsewhere")
    assert build.library_path("k") == first
    (src / "tile.cuh").write_text("// v2\n")
    edited = build.library_path("k")
    assert edited != first
    (src / "more.cuh").write_text("// new header\n")
    added = build.library_path("k")
    assert added not in (first, edited)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") not in (first, edited, added)


def test_histogram_ref_drops_out_of_range_bins():
    idx = torch.tensor([0, 1, 1, 5, 9], dtype=torch.int32)
    np.testing.assert_array_equal(histogram_ref(idx, 3).numpy(), [1, 2, 0])


# shared-memory limit of an H100 block (232,448 B opt-in, less the
# kernels' static words) and its SM count, for the launch plan
H100_SMS = 132
H100_SMEM_LIMIT = 232448 - 16
HIST_FAMILIES = ("gap", "poker", "weight", "serial2d", "collision", "rank")


def _ranked(seed, m):
    """(m, 32) uint32 rows, matrix i of rank i % 33 (i % 33 rows with
    distinct leading bits, the rest XOR combinations of them, rows
    shuffled), and those ranks."""
    rng = np.random.default_rng(seed)
    want = np.arange(m) % 33
    k = np.arange(32, dtype=np.uint64)
    lead = np.uint64(1) << (np.uint64(31) - k)
    low = rng.integers(0, 2 ** 31, size=(m, 32), dtype=np.uint64)
    base = np.where(k[None, :] < want[:, None], lead | (low & (lead - 1)), 0)
    base = base.astype(np.uint64)
    fixed = np.arange(32)[None, :] < want[:, None]
    words = np.zeros((m, 32), np.uint64)
    for j in range(32):
        pick = np.where(fixed, np.arange(32)[None, :] == j,
                        rng.integers(0, 2, size=(m, 32)) == 1)
        words ^= np.where(pick, base[:, j:j + 1], np.uint64(0))
    words = np.take_along_axis(words, rng.permuted(
        np.tile(np.arange(32), (m, 1)), axis=1), axis=1)
    return words.astype(np.uint32), want.astype(np.int32)


def _histogram_shapes(battery, scale):
    """Every (N, nbins) the accelerated families of the port's battery
    table hand the bin-count, padding included: each entry run once on
    the CPU with the plain version recording its shapes."""
    from repro_torch.core.battery import build_battery
    from repro_torch.kernels.histogram import ops
    shapes = set()
    real = ops.histogram_ref

    def spy(idx, nbins):
        shapes.add((idx.shape[0], nbins))
        return real(idx, nbins)
    rng = np.random.default_rng(0)
    entries = build_battery(battery, scale, backend="accelerated",
                            device="cpu")
    ops.histogram_ref = spy
    try:
        for e in entries:
            if e.kname in HIST_FAMILIES:
                bits = torch.from_numpy(rng.integers(
                    0, 2 ** 32, size=e.n_words, dtype=np.int64))
                e.kernel(bits)
    finally:
        ops.histogram_ref = real
    return shapes


@pytest.mark.parametrize("battery", ["bigcrush", "crush"])
@pytest.mark.parametrize("scale", [0.0625, 0.25, 1.0])
def test_plan_keeps_main_path_bins_on_chip(battery, scale):
    """Every bin-count the main path makes is one launch with its bins in
    shared memory (the copies or split route, a grid of whole clusters),
    never the global-atomics route."""
    shapes = _histogram_shapes(battery, scale)
    assert {k for _, k in shapes} >= {4, 13, 22}
    for n, k in shapes:
        pl = hk.plan(n, k, H100_SMS, H100_SMEM_LIMIT)
        assert pl.route in ("copies", "split"), (n, k, pl)
        assert pl.blocks % pl.cluster == 0 and pl.cluster <= hk.CLUSTER_MAX
        assert pl.blocks <= hk.BLOCKS_PER_SM * H100_SMS
        assert 0 < pl.smem_bytes <= H100_SMEM_LIMIT


def test_plan_routes_by_bin_count():
    """Route boundaries: a copy of the bins per block up to
    COPY_MAX_BINS, split across the cluster up to CLUSTER_MAX_BINS (so
    HIST_MAX_BINS stays on chip), global atomics beyond; a grid of one
    cluster touches no global scratch."""
    from repro_torch.stats.backends import HIST_MAX_BINS
    assert hk.COPY_MAX_BINS < HIST_MAX_BINS <= hk.CLUSTER_MAX_BINS
    routes = {k: hk.plan(1 << 24, k, H100_SMS, H100_SMEM_LIMIT)
              for k in (1, 4, 32, 33, 4096, hk.COPY_MAX_BINS,
                        hk.COPY_MAX_BINS + 1, HIST_MAX_BINS,
                        hk.CLUSTER_MAX_BINS, hk.CLUSTER_MAX_BINS + 1,
                        1 << 20)}
    for k, pl in routes.items():
        want = ("copies" if k <= hk.COPY_MAX_BINS else "split"
                if k <= hk.CLUSTER_MAX_BINS else "global")
        assert pl.route == want, (k, pl)
        assert pl.blocks % pl.cluster == 0
        assert pl.scratch_words == hk.COUNTS_OFFSET + k    # many clusters
        if want == "copies":
            copies = pl.lanes * pl.warp_copies
            assert pl.lanes == (32 if k <= hk.LANE_COPY_MAX_BINS else 1)
            assert pl.smem_bytes == 4 * (k * copies
                                         + (k if copies > 1 else 0))
        elif want == "split":
            assert pl.cluster <= hk.SPLIT_CLUSTER_MAX
            assert ((pl.cluster - 1) << pl.slice_log2) < k <= (
                pl.cluster << pl.slice_log2)
            assert pl.slice_log2 == hk.SLICE_MAX_LOG2
            assert pl.smem_bytes == 4 << pl.slice_log2
        else:
            assert pl.smem_bytes == 0
        assert pl.smem_bytes <= H100_SMEM_LIMIT
    for k in (4, 4096, HIST_MAX_BINS):
        small = hk.plan(hk.CHUNK, k, H100_SMS, H100_SMEM_LIMIT)
        assert small.blocks == small.cluster and small.scratch_words == 0
    big = hk.plan(1 << 20, hk.CLUSTER_MAX_BINS + 1, H100_SMS,
                  H100_SMEM_LIMIT)
    assert big.route == "global" and big.scratch_words > 0
    with pytest.raises(ValueError, match="shared memory"):
        hk.plan(1 << 20, hk.COPY_MAX_BINS, H100_SMS, 48 * 1024)


def test_plan_overrides_keep_the_layout_rules():
    """Keyword overrides of ``plan`` (to time other layouts) change only
    what they name: the shared memory, grid rounding and scratch follow
    from them by the same rules, and a layout that cannot run raises."""
    from dataclasses import replace
    lim = (H100_SMS, H100_SMEM_LIMIT)
    base = hk.plan(1 << 24, 4096, *lim)
    assert hk.plan(1 << 24, 4096, *lim, warp_copies=base.warp_copies) == base
    one = hk.plan(1 << 24, 4096, *lim, warp_copies=1)
    assert one.smem_bytes == 4 * 4096 and one.warp_copies == 1
    assert hk.plan(1 << 24, 4096, *lim, cluster=8) == replace(base, cluster=8)
    split = hk.plan(1 << 26, 1 << 16, *lim, slice_log2=14, blocks=132)
    assert (split.route, split.cluster, split.blocks, split.smem_bytes) == (
        "split", 4, 132, 4 << 14)
    glob = hk.plan(1 << 24, 4096, *lim, route="global")
    assert glob == replace(hk.plan(1 << 24, hk.CLUSTER_MAX_BINS + 1, *lim),
                           scratch_words=hk.COUNTS_OFFSET + 4096)
    small = hk.plan(hk.CHUNK, 22, *lim, cluster=2)
    assert small.blocks == 2 and small.scratch_words == 0
    with pytest.raises(ValueError, match="cluster"):
        hk.plan(1 << 26, 1 << 16, *lim, slice_log2=14, cluster=2)
    with pytest.raises(ValueError, match="whole number"):
        hk.plan(1 << 24, 22, *lim, cluster=8, blocks=100)
    with pytest.raises(ValueError, match="route"):
        hk.plan(1 << 24, 22, *lim, route="shared")


def test_rank32_high_bit_words_match_pallas():
    """int64 words at or above 2^31 (the bit the int32 path had to
    reinterpret; every non-zero matrix here has one) give the Pallas
    kernel's ranks (interpret mode) and the ranks built in, 0-32."""
    from repro.kernels.gf2_rank.ops import rank32 as ref_rank32
    mats, want = _ranked(5, 512)
    hi = mats.astype(np.int64)
    assert (hi >= 2 ** 31).any(axis=1)[want > 0].all()
    got = rank32(torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_rank32(mats, interpret=True)))
    np.testing.assert_array_equal(got, want)


# -- on the card (skipped without one)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a and run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2048, 4), (1 << 20, 22), (1 << 18, 4096),
                                 (1 << 20, 65537), (5000, 13)])
def test_histogram_kernel_matches_plain_on_card(cuda, n, k):
    idx = torch.from_numpy(_idx(n, n, k)).to(cuda)
    before = hk.histogram.launches
    got = bincount(idx, k)
    torch.cuda.synchronize()
    assert hk.histogram.launches == before + 1
    assert torch.equal(got.cpu(), histogram_ref(idx.cpu(), k))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 1000, 1 << 16])
def test_gf2_rank_kernel_matches_plain_on_card(cuda, m):
    words = _words(_mats(m, m))
    before = gk.gf2_rank.launches
    got = rank32(words.to(cuda))
    torch.cuda.synchronize()
    assert gk.gf2_rank.launches == before + 1
    assert torch.equal(got.cpu(), gf2_rank_ref(words))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [hk.CHUNK, 1 << 20])
@pytest.mark.parametrize("k", [hk.COPY_MAX_BINS, hk.COPY_MAX_BINS + 1,
                               1 << 16, hk.CLUSTER_MAX_BINS,
                               hk.CLUSTER_MAX_BINS + 1])
def test_histogram_route_boundaries_on_card(cuda, n, k):
    """Each side of every route boundary, in one cluster (N = CHUNK) and
    in many, against the plain version, bitwise."""
    idx = torch.from_numpy(_idx(n + k, n, k)).to(cuda)
    got = hk.histogram(idx, k)
    assert torch.equal(got.cpu(), histogram_ref(idx.cpu(), k))


@pytest.mark.cuda
def test_histogram_scratch_resets_across_calls_and_streams(cuda):
    """The multi-cluster routes leave their scratch zero: back-to-back
    calls on other data, and calls alternating on two streams (one
    scratch each), give each call's own counts."""
    n = 1 << 20
    datas = [torch.from_numpy(_idx(s, n, k)).to(cuda)
             for s, k in ((1, 22), (2, 4096), (3, 1 << 16), (4, 1 << 20))]
    for idx in datas + datas[::-1]:
        k = int(idx.max()) + 1
        assert hk.plan(n, k, *hk.device_limits(cuda.index)).scratch_words
        assert torch.equal(hk.histogram(idx, k).cpu(),
                           histogram_ref(idx.cpu(), k))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for i in range(8):
        idx = datas[i % len(datas)]
        with torch.cuda.stream(streams[i % 2]):
            outs.append((idx, hk.histogram(idx, 1 << 16)))
    torch.cuda.synchronize()
    for idx, got in outs:
        assert torch.equal(got.cpu(), histogram_ref(idx.cpu(), 1 << 16))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_histogram_unaligned_view_on_card(cuda, offset):
    """A contiguous view that does not start on 16 bytes (the kernel's
    scalar head before its 16-byte loads) counts every index."""
    n, k = 1 << 16, 22
    base = torch.from_numpy(_idx(offset, n + offset, k)).to(cuda)
    idx = base[offset:]
    assert idx.data_ptr() % 16
    assert torch.equal(hk.histogram(idx, k).cpu(),
                       histogram_ref(idx.cpu(), k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 22, 4096, 1 << 16, (1 << 17) + 1])
def test_histogram_drops_out_of_range_and_negative_indices(cuda, k):
    """Indices below 0 or at and above nbins are not counted, on every
    route (the Pallas kernel's iota compare matches none of them)."""
    rng = np.random.default_rng(k)
    idx = rng.integers(-k, 2 * k, size=1 << 16, dtype=np.int32)
    idx[:4] = [np.iinfo(np.int32).min, -1, k, np.iinfo(np.int32).max]
    want = np.bincount(idx[(idx >= 0) & (idx < k)], minlength=k)
    got = hk.histogram(torch.from_numpy(idx).to(cuda), k)
    np.testing.assert_array_equal(got.cpu().numpy(), want.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1 << 24, 22), (1 << 24, 4096),
                                 (1 << 26, 1 << 16), (1 << 22, 1 << 20)])
def test_histogram_routes_repeat_across_streams(cuda, n, k):
    """Many-cluster grids of every route (lane copies, copies, split,
    global), 24 calls on other data in turns over four streams, each
    scratch shared by the calls of its stream: every call's counts equal
    the plain version's, bitwise."""
    assert hk.plan(n, k, *hk.device_limits(cuda.index)).scratch_words
    g = torch.Generator(device=cuda).manual_seed(n + k)
    datas = [torch.randint(0, k, (n,), generator=g, device=cuda,
                           dtype=torch.int32) for _ in range(3)]
    wants = [histogram_ref(idx, k) for idx in datas]
    streams = [torch.cuda.Stream() for _ in range(4)]
    torch.cuda.synchronize()
    outs = []
    for i in range(24):
        with torch.cuda.stream(streams[i % 4]):
            outs.append((i % 3, hk.histogram(datas[i % 3], k)))
    torch.cuda.synchronize()
    for d, got in outs:
        assert torch.equal(got, wants[d]), d


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 1024, 1 << 16])
def test_gf2_rank_int64_entry_on_card(cuda, m):
    """Ranks 0-32: the kernel on the port's int64 words, as ``rank32``
    hands them over in one launch, equals the plain version and the
    ranks built in; any other word type is refused."""
    mats, want = _ranked(m, m)
    words = torch.from_numpy(mats.astype(np.int64)).to(cuda)
    before = gk.gf2_rank.launches
    got = rank32(words)
    torch.cuda.synchronize()
    assert gk.gf2_rank.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(gf2_rank_ref(words.cpu()).numpy(), want)
    with pytest.raises(TypeError, match="int64"):
        gk.gf2_rank(words.to(torch.int32))
    assert gk.gf2_rank.launches == before + 1
