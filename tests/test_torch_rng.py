"""PyTorch port: generators and the generator registry, bitwise against
the JAX reference (which runs in ``test_torch_reference.py``'s
subprocess)."""
import numpy as np
import pytest
import torch

from test_torch_reference import run_reference

from repro_torch.common import ints
from repro_torch.rng import generators as G
from repro_torch.rng import sources as S

NAMES = ("splitmix64", "msweyl", "threefry", "pcg32", "lcg64",
         "xorshift64s", "mwc", "randu", "minstd")

# (seed, stream, n, offset): offsets cover continuation, the 64-bit
# counter's high half (threefry folds hi32/lo32 separately) and a
# non-multiple of the xorshift lane length
CASES = [(7, 3, 1000, None), (0, 0, 64, None), (123456, 77, 300, 5),
         (7, 3, 500, 500), (7, 3, 257, (1 << 32) - 100), (5, 9, 129, 63)]


def _cases():
    out = []
    for name in NAMES:
        for seed, stream, n, off in CASES:
            if name == "mwc" and off is not None:
                continue
            out.append((name, seed, stream, n, off))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    (res,) = run_reference([{"kind": "words", "cases": _cases()}],
                           str(tmp_path_factory.mktemp("ref_rng")))
    return res


def _block(name, seed, stream, n, off):
    fn = G.GENERATORS[name]
    if off is None:
        return fn(seed, stream, n, device="cpu")
    return fn(seed, stream, n, off, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_generator_words_bitwise(ref, name):
    """All nine generators equal the reference word for word (integer
    data: bitwise), with and without an offset."""
    for case, words in zip(_cases(), ref["words"]):
        if case[0] != name:
            continue
        got = _block(*case).numpy()
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, words.astype(np.int64),
                                      err_msg=str(case))


@pytest.mark.parametrize("name", [n for n in NAMES if n != "mwc"])
def test_offset_continuation(name):
    """block(2k) == block(k) ++ block(k, offset=k) for every
    counter-based generator."""
    whole = G.GENERATORS[name](11, 4, 2 * 333, device="cpu")
    a = G.GENERATORS[name](11, 4, 333, device="cpu")
    b = G.GENERATORS[name](11, 4, 333, 333, device="cpu")
    assert torch.equal(whole, torch.cat([a, b]))


@pytest.mark.parametrize("name", sorted(G.SCAN_REFERENCE))
def test_jump_ahead_equals_sequential_twin(name):
    """The jump-ahead generators equal their O(n) recurrences."""
    assert torch.equal(G.GENERATORS[name](3, 2, 777, device="cpu"),
                       G.SCAN_REFERENCE[name](3, 2, 777, device="cpu"))


def test_registry_order_matches_reference(ref):
    """Gen ids keep the reference's built-in order, and the offset
    capability agrees."""
    assert {n: S.get_generator(n).gen_id for n in NAMES} == ref["gen_ids"]
    assert [n for n in NAMES if S.get_generator(n).counter_based] == \
        ref["counter_based"]
    assert S.registry_size() == len(NAMES)
    # the port's threefry follows jax_threefry_partitionable=True
    assert ref["threefry_partitionable"] is True


def test_registry_rejects_duplicates_and_unknown():
    with pytest.raises(ValueError):
        S.register_generator("pcg32", G.pcg32_block, counter_based=True)
    with pytest.raises(KeyError):
        S.get_generator("nope")


def test_offset_gate_refuses_mwc():
    src = S.GeneratorSource("mwc")
    with pytest.raises(S.OffsetNotSupportedError):
        S.require_offsetable(src, 5)
    S.require_offsetable(src, 0)
    S.require_offsetable(src, None)
    with pytest.raises(S.OffsetNotSupportedError):
        S.switch_block(src.gen_id, 1, 2, 8, 4, device="cpu")


def test_switch_block_dispatches_by_gen_id():
    for name in NAMES:
        gid = S.get_generator(name).gen_id
        assert torch.equal(S.switch_block(gid, 9, 1, 40, device="cpu"),
                           G.GENERATORS[name](9, 1, 40, device="cpu"))


def test_generator_without_device_needs_cuda():
    """Entry points default to cuda; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        G.splitmix64_block(1, 2, 8)


# -- u32/u64-on-int64 helpers, against numpy's unsigned arithmetic


def _u64(rng, n):
    return rng.integers(0, 2 ** 64, size=n, dtype=np.uint64)


def test_ints_against_numpy_unsigned():
    rng = np.random.default_rng(5)
    a, b = _u64(rng, 1000), _u64(rng, 1000)
    ta, tb = (torch.from_numpy(x.view(np.int64)) for x in (a, b))
    np.testing.assert_array_equal((ta * tb).numpy().view(np.uint64), a * b)
    np.testing.assert_array_equal((ta + tb).numpy().view(np.uint64), a + b)
    for s in (1, 12, 31, 32, 59, 63):
        np.testing.assert_array_equal(
            ints.lsr(ta, s).numpy().view(np.uint64), a >> np.uint64(s))
    np.testing.assert_array_equal(ints.hi32(ta).numpy(),
                                  (a >> np.uint64(32)).astype(np.int64))
    w = (a >> np.uint64(32)).astype(np.int64)
    tw = torch.from_numpy(w)
    np.testing.assert_array_equal(
        ints.popcount32(tw).numpy(),
        np.array([bin(int(x)).count("1") for x in w]))
    np.testing.assert_array_equal(
        ints.to_unit(tw).numpy(),
        (w >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24)))
    assert ints.s64(2 ** 64 - 1) == -1 and ints.s64(2 ** 63) == -2 ** 63
