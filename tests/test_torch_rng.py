"""PyTorch port: generators and the generator registry, bitwise against
the JAX reference (which runs in ``test_torch_reference.py``'s
subprocess)."""
import numpy as np
import pytest
import torch

from test_torch_reference import run_reference

from repro_torch.common import ints
from repro_torch.kernels.mwc import kernel as mwc_kernel
from repro_torch.kernels.mwc.ops import mwc as mwc_words
from repro_torch.kernels.mwc.ref import mwc_ref
from repro_torch.rng import generators as G
from repro_torch.rng import sources as S

NAMES = ("splitmix64", "msweyl", "threefry", "pcg32", "lcg64",
         "xorshift64s", "mwc", "randu", "minstd")

# (seed, stream, n, offset): offsets cover continuation, the 64-bit
# counter's high half (threefry folds hi32/lo32 separately) and a
# non-multiple of the xorshift lane length
CASES = [(7, 3, 1000, None), (0, 0, 64, None), (123456, 77, 300, 5),
         (7, 3, 500, 500), (7, 3, 257, (1 << 32) - 100), (5, 9, 129, 63)]
# mwc (seed, stream) pairs, found by search, whose start carry
# c0 = (mix mod 2^32) | 1 is >= a = 4294957665 (c0 = a + 2 and c0 = a):
# there the first state z0 = c0*2^32 + x0 is not below the prime
# a*2^32 - 1 that the kernel jumps with
MWC_WIDE_CARRY = [(131490111, 0), (2010969873, 1)]
MWC_A = mwc_kernel.MWC_A


def _cases():
    out = []
    for name in NAMES:
        for seed, stream, n, off in CASES:
            if name == "mwc" and off is not None:
                continue
            out.append((name, seed, stream, n, off))
    out += [("mwc", seed, stream, 300, None)
            for seed, stream in MWC_WIDE_CARRY]
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


# -- mwc: the kernel's jump-ahead, modelled in pure Python


def _mwc_state(seed, stream):
    s = G._mix_seed(seed, stream) % (1 << 64)
    return (s >> 32) | 1, (s & ints.MASK32) | 1


def _mwc_by_jumps(x0, c0, n, chunk):
    """The kernel's arithmetic (``mwc.cu``) with Python ints: chunk 0 by
    the loop's own steps from (x0, c0); chunk j >= 1 from
    z_{j*chunk+1} = A^j * (z_1 mod P) mod P, A^j as the product of the
    ``jump_powers`` table's entries for the bits of j."""
    p = mwc_kernel.MWC_P
    pows = mwc_kernel.jump_powers(chunk)
    z1 = (MWC_A * x0 + c0) % p
    out = []
    for j in range(-(-n // chunk)):
        if j == 0:
            x, c, words = x0, c0, []
        else:
            z = z1
            for b in range(j.bit_length()):
                if j >> b & 1:
                    z = z * pows[b] % p
            assert z < p
            x, c, words = z & ints.MASK32, z >> 32, [z & ints.MASK32]
        while len(words) < min(chunk, n - j * chunk):
            t = MWC_A * x + c
            x, c = t & ints.MASK32, t >> 32
            words.append(x)
        out += words
    return out


def _is_prime(m):
    """Deterministic Miller-Rabin for m < 3.3e24."""
    d, r = m - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41):
        x = pow(a, d, m)
        if x in (1, m - 1):
            continue
        for _ in range(r - 1):
            x = x * x % m
            if x == m - 1:
                break
        else:
            return False
    return True


def test_mwc_modulus_is_a_prime_below_2_64():
    """The jump works modulo P = a*2^32 - 1, a prime that fits 64 bits;
    the table holds A^(2^i) for A = a^CHUNK."""
    p = mwc_kernel.MWC_P
    assert p == MWC_A * (1 << 32) - 1 and p < 1 << 64 and _is_prime(p)
    pows = mwc_kernel.jump_powers()
    assert len(pows) == mwc_kernel.JUMP_BITS
    assert pows[0] == pow(MWC_A, mwc_kernel.CHUNK, p)
    assert all(pows[i + 1] == pows[i] ** 2 % p for i in range(len(pows) - 1))


@pytest.mark.parametrize("chunk", [1, 2, 7, 64])
def test_mwc_jump_arithmetic_equals_the_loop(chunk):
    """The kernel's jumps give the loop's words, also from states whose
    carry is >= a (z0 above P) and from the largest x0 (where
    z1 = a*x0 + c0 can pass P too), at lengths around chunk edges."""
    rng = np.random.default_rng(chunk)
    states = [_mwc_state(*pair) for pair in MWC_WIDE_CARRY]
    states += [((1 << 32) - 1, MWC_A), ((1 << 32) - 1, (1 << 32) - 1),
               ((1 << 32) - 1, MWC_A + 2), (1, 1)]
    states += [(int(x) | 1, int(c) | 1)
               for x, c in rng.integers(0, 1 << 32, size=(4, 2))]
    for x0, c0 in states:
        for n in sorted({1, 2, chunk - 1, chunk, chunk + 1, 3 * chunk + 2,
                         200} - {0}):
            want = mwc_ref(x0, c0, n, "cpu").tolist()
            assert _mwc_by_jumps(x0, c0, n, chunk) == want, (x0, c0, n)


def test_mwc_wide_carry_pairs_are_wide():
    for pair in MWC_WIDE_CARRY:
        assert _mwc_state(*pair)[1] >= MWC_A


def test_mwc_block_on_cpu_is_the_plain_loop():
    """On the CPU ``mwc_block`` is ``ref.py``'s loop from the mixed
    seed; the launcher refuses a CPU device."""
    for seed, stream in [(7, 3)] + MWC_WIDE_CARRY:
        x0, c0 = _mwc_state(seed, stream)
        assert torch.equal(G.mwc_block(seed, stream, 333, device="cpu"),
                           mwc_ref(x0, c0, 333, "cpu"))
        assert torch.equal(mwc_words(x0, c0, 333, "cpu"),
                           mwc_ref(x0, c0, 333, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        mwc_kernel.mwc_words(1, 1, 8, "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the mwc kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, (1 << 10) + 3, 1 << 20])
def test_mwc_kernel_matches_plain_on_card(cuda, n):
    """The kernel equals the loop word for word, also where c0 >= a."""
    states = [_mwc_state(7, 3), ((1 << 32) - 1, MWC_A)]
    states += [_mwc_state(*pair) for pair in MWC_WIDE_CARRY]
    for x0, c0 in states:
        got = mwc_kernel.mwc_words(x0, c0, n, cuda)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), mwc_ref(x0, c0, n, "cpu")), (x0, c0)
