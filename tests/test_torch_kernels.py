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
