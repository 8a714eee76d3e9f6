"""PyTorch port: the mwc kernel (``kernels/mwc/mwc.cu``) modelled in
Python integers step for step, against the plain loop (``ref.py``).

The model follows the ``.cu``: its product modulo the prime
``P = a*2^32 - 1`` (three word-by-word Montgomery steps, no 128-bit
division), the jump by word index from one table (the warp's butterfly
of ``__shfl_xor`` products and the lane's own factor), the launch that
``kernel.plan`` lays out, each thread's steps and the block's staging
through shared memory. The card's test holds the kernel itself to the
loop at the plan's boundaries (skipped without a card). Inputs come from
``numpy.random.default_rng``.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_rng import MWC_WIDE_CARRY, _mwc_state

from repro_torch.kernels.mwc import kernel as K
from repro_torch.kernels.mwc.ref import mwc_ref

P, A = K.MWC_P, K.MWC_A
LOW = (1 << 32) - 1
U64 = (1 << 64) - 1
WARP = 32
SMS = 132                    # an H100 SXM's SMs
CU = Path(K.__file__).with_name("mwc.cu")


# -- the model


def mont_steps(u, v):
    """``mwc.cu``'s ``mont(u, v)`` with Python ints, cut to 64 bits where
    the ``.cu``'s uint64_t wraps. Returns the result, u*v*a^3 mod P, and
    whether the carry out of 64 bits and the final subtraction were
    taken (so a test can see both paths run)."""
    assert 0 <= u < P and 0 <= v < P, "operands are residues"
    lo, hi = u * v & U64, u * v >> 64
    w = (hi << 32 | lo >> 32) & U64
    t = (w + A * (lo & LOW)) & U64
    top = (hi >> 32) + (t < w)
    assert top < 1 << 32                          # V1 < 2^96
    w = (top << 32 | t >> 32) & U64
    t = (w + A * (t & LOW)) & U64
    carry = int(t < w)                            # V2 = carry:t < 2^65
    w = carry << 32 | t >> 32
    t = w + A * (t & LOW)
    assert t < P + A + 1                          # V3: no wrap
    return (t - P if t >= P else t), bool(carry), t >= P


def mont(u, v):
    return mont_steps(u, v)[0]


def form(x):
    """``x`` in the product's form, ``x * a^-3 mod P``."""
    return x * K.MONT_ONE % P


TABLE = K.jump_table()
ONE = TABLE[-1]


@functools.lru_cache(maxsize=None)
def warp_factors(warp_first):
    """Every lane's ``f`` after the butterfly, for the warp whose first
    word is ``warp_first``: lane l takes bit l (lanes 0-7 also bit
    l + 32) from the table, then 5 rounds of ``f = mont(f, f[l ^ m])``."""
    f = []
    for lane in range(WARP):
        high = lane + WARP
        v = TABLE[lane] if warp_first >> lane & 1 else ONE
        f.append(mont(v, TABLE[high % K.JUMP_BITS]
                      if high < K.JUMP_BITS and warp_first >> high & 1
                      else ONE))
    m = 1
    while m < WARP:
        f = [mont(f[lane], f[lane ^ m]) for lane in range(WARP)]
        m <<= 1
    return tuple(f)


@functools.lru_cache(maxsize=None)
def lane_factor(lane, chunk_log2):
    """``g``: the lane's 5 bits, word-index bits chunk_log2 + b."""
    g = TABLE[chunk_log2] if lane & 1 else ONE
    for b in range(1, 5):
        g = mont(g, TABLE[chunk_log2 + b] if lane >> b & 1 else ONE)
    return g


def z1_residue(x0, c0):
    z1 = A * x0 + c0
    assert z1 < 1 << 64 and z1 - P < P
    return z1 - P if z1 >= P else z1


@functools.lru_cache(maxsize=None)
def jump(z1r, first, chunk_log2):
    """The state ``z_{first+1}`` that the thread whose first word is
    ``first`` (a multiple of 2^chunk_log2) starts from."""
    lane = first >> chunk_log2 & (WARP - 1)
    f = warp_factors(first - (lane << chunk_log2))[lane]
    return mont(mont(z1r, f), lane_factor(lane, chunk_log2))


def model_words(x0, c0, n, pl):
    """The launch of plan ``pl``: each block's threads step their chunks
    into the block's tile (pitch chunk | 1), then the block writes the
    tile out in word order."""
    chunk_log2 = pl.chunk.bit_length() - 1
    pitch = pl.chunk | 1
    per_block = pl.threads * pl.chunk
    z1r = z1_residue(x0, c0)
    out = [None] * n
    for block in range(pl.blocks):
        base = block * per_block
        tile = [None] * (pl.threads * pitch)
        for tid in range(pl.threads):
            first = base + (tid << chunk_log2)
            if first >= n:
                break
            count = min(pl.chunk, n - first)
            mine = tid * pitch
            if first == 0:
                x, c, k = x0, c0, 0
            else:
                z = jump(z1r, first, chunk_log2)
                assert z < P
                x, c, k = z & LOW, z >> 32, 1
                tile[mine] = x
            for k in range(k, count):
                t = A * x + c
                x, c = t & LOW, t >> 32
                tile[mine + k] = x
        for i in range(min(per_block, n - base)):
            word = tile[(i >> chunk_log2) * pitch + (i & (pl.chunk - 1))]
            assert word is not None and out[base + i] is None
            out[base + i] = word
    assert None not in out
    return out


def loop_states():
    """The start states of ``test_mwc_jump_arithmetic_equals_the_loop``
    (wide-carry starts, the largest x0, four drawn with its chunk 64)."""
    rng = np.random.default_rng(64)
    states = [_mwc_state(*pair) for pair in MWC_WIDE_CARRY]
    states += [((1 << 32) - 1, A), ((1 << 32) - 1, (1 << 32) - 1),
               ((1 << 32) - 1, A + 2), (1, 1)]
    states += [(int(x) | 1, int(c) | 1)
               for x, c in rng.integers(0, 1 << 32, size=(4, 2))]
    return states


STATES = loop_states()
MODEL_LIMIT = 1 << 16


@functools.lru_cache(maxsize=None)
def loop_words(x0, c0, n):
    return mwc_ref(x0, c0, n, "cpu").tolist()


# -- the product


def subtracting_pairs(count):
    """Residues u, v whose V3 lies at or above P (the final subtraction,
    about 2^-32 of random pairs): V2 = H*2^32 + 2^32 - 1 with H >= a,
    from V1 = (V2 - a*(2^32 - 1))*2^32 + 2^32 - 1 and
    V = V1*2^32 - l*P = u*v, with l < 2^32 the solution of V = 0 mod u
    for the first u > 2^34 that has one."""
    out = []
    for h in range(A, A + count):
        v1 = (h * 2 ** 32 + LOW - A * LOW) * 2 ** 32 + LOW
        u = (1 << 34) + 1
        while True:
            low = v1 * 2 ** 32 * pow(P, -1, u) % u
            if low <= LOW:
                out.append((u, (v1 * 2 ** 32 - low * P) // u))
                break
            u += 2
    return out


def test_mont_product_is_the_modular_product():
    """mont(u, v) = u*v*a^3 mod P and mont(u, form(v)) = u*v mod P, on
    random residues, on the edges (0, 1, P - 1, the largest residues
    next to 2^64, the 32-bit halves) and on pairs built to take the final
    subtraction; the carry out of 64 bits is taken on some of them."""
    rng = np.random.default_rng(0)
    drawn = [int(v) for v in rng.integers(0, P, size=4000, dtype=np.uint64)]
    top = [P - 1 - k for k in range(4)] + [P - (1 << 32), 1 << 63,
                                           (LOW << 32) - (9631 << 32)]
    edges = [0, 1, 2, A, A + 1, LOW, 1 << 32] + top
    pairs = [(u, v) for u in edges for v in edges]
    pairs += list(zip(drawn[::2], drawn[1::2]))
    pairs += [(u, v) for u in top for v in drawn[:200]]
    built = subtracting_pairs(3)
    a3 = pow(A, 3, P)
    carries = 0
    for u, v in pairs + built:
        got, carry, sub = mont_steps(u, v)
        assert got == u * v * a3 % P, (u, v)
        assert mont(u, form(v)) == u * v % P, (u, v)
        carries += carry
        assert sub == ((u, v) in built), (u, v)
    assert carries


def test_jump_table_is_jump_powers_1_in_the_products_form():
    pows = K.jump_powers(1)
    assert len(TABLE) == K.JUMP_BITS + 1 and ONE == K.MONT_ONE
    assert ONE * pow(A, 3, P) % P == 1
    assert all(TABLE[i] == form(pows[i]) == pow(A, (1 << i) - 3, P)
               for i in range(K.JUMP_BITS))
    assert all(mont(z, TABLE[i]) == z * pows[i] % P
               for z in (1, 7, P - 1) for i in range(K.JUMP_BITS))


def test_jump_by_word_index_is_a_power_of_a():
    """A thread that starts at word s jumps to a^s * (z1 mod P), s up to
    2^40 - 1, at every chunk the plan may take."""
    rng = np.random.default_rng(1)
    z1s = [int(v) for v in rng.integers(1, P, size=3, dtype=np.uint64)]
    z1s += [z1_residue(LOW, LOW), z1_residue(LOW, A)]
    words = [int(v) for v in rng.integers(1, 1 << 40, size=40,
                                          dtype=np.uint64)]
    words += [1, 2, 31, 32, 33, (1 << 32) - 1, 1 << 32, 1 << 39,
              (1 << 40) - 1, (1 << 40) - 64]
    for chunk_log2 in range(K.CHUNK.bit_length()):
        for s in words:
            s = s >> chunk_log2 << chunk_log2
            if s == 0:
                continue
            for z1r in z1s:
                assert jump(z1r, s, chunk_log2) == pow(A, s, P) * z1r % P, \
                    (chunk_log2, s, z1r)


# -- the plan


def test_plan_covers_every_word_once_and_fills_the_card():
    """Every word in exactly one thread's chunk and no block without one;
    a block or more on each of 132 SMs from 2^14 words; a grid below 2^31
    blocks; each layout within mwc.cu's limits and 48 KB of shared
    memory."""
    rng = np.random.default_rng(2)
    lengths = [1 << e for e in range(10, 24)]
    lengths += [n + d for n in lengths for d in (-1, 1)]
    lengths += K.boundaries(1 << 23, SMS, every_block=False)
    lengths += [K.MAX_WORDS - 1]
    lengths += [int(v) for v in rng.integers(1, K.MAX_WORDS, size=200,
                                             dtype=np.uint64)]
    for n in lengths:
        pl = K.plan(n, SMS)
        per_block = pl.chunk * pl.threads
        assert pl.chunk & (pl.chunk - 1) == 0 and pl.chunk <= K.CHUNK
        assert pl.threads % WARP == 0 and pl.threads <= K.MAX_THREADS
        assert (pl.blocks - 1) * per_block < n <= pl.blocks * per_block
        assert pl.blocks < 1 << 31
        assert 4 * pl.threads * (pl.chunk | 1) <= 48 * 1024
        if n >= 1 << 14:
            assert pl.blocks >= SMS, (n, pl)
        if n <= 1 << 16:
            seen = [0] * n
            for g in range(pl.blocks * pl.threads):
                for w in range(g * pl.chunk, min(n, (g + 1) * pl.chunk)):
                    seen[w] += 1
            assert seen == [1] * n, (n, pl)


def test_plan_at_bigcrush_buckets():
    """The chunk grows with n, one word a thread up to 2^14 and 16 from
    2^18; 256 blocks at every bucket from 2^13 to 2^19, then blocks of
    2048 words (512 at 2^20, 4096 at 2^23)."""
    got = {e: tuple(K.plan(1 << e, SMS)) for e in range(10, 24)}
    assert got[10] == (1, 32, 32) and got[13] == (1, 32, 256)
    assert got[14] == (1, 64, 256) and got[16] == (4, 64, 256)
    assert got[18] == (16, 64, 256) and got[19] == (16, 128, 256)
    assert got[20] == (16, 128, 512) and got[23] == (16, 128, 4096)
    assert all(got[e][2] == 256 for e in range(13, 20))


def test_plan_refuses_what_the_kernel_cannot_launch():
    for n in (0, K.MAX_WORDS):
        with pytest.raises(ValueError, match="2\\^40"):
            K.plan(n, SMS)
    for chunk in (3, 128):
        with pytest.raises(ValueError, match="power of two"):
            K.plan(1000, SMS, chunk=chunk)
    for threads in (16, 160, 256):
        with pytest.raises(ValueError, match="multiple of 32"):
            K.plan(1000, SMS, threads=threads)
    assert K.plan(1000, SMS, chunk=64, threads=128) == (64, 128, 1)


def test_cu_constants_match_the_launcher():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert const("kMaxThreads") == K.MAX_THREADS
    assert 1 << const("kMaxChunkLog2") == K.CHUNK
    assert const("kJumpBits") == K.JUMP_BITS
    assert const("kWarp") == WARP
    assert int(re.search(r"kA = (\d+)ull", src).group(1)) == A


# -- the whole launch against the loop


@pytest.mark.parametrize(
    "n", K.boundaries(MODEL_LIMIT, SMS, every_block=False))
def test_model_equals_the_loop_at_plan_boundaries(n):
    """Plan, jump, steps and staging give the loop's words from every
    start state of the fixed-chunk test, wide-carry starts included."""
    pl = K.plan(n, SMS)
    for x0, c0 in STATES:
        want = loop_words(x0, c0, MODEL_LIMIT)[:n]
        assert model_words(x0, c0, n, pl) == want, (x0, c0, pl)


def test_model_equals_the_loop_at_every_block_count():
    """Every length up to 2^14 where the plan's block count changes (and
    the one after), from the largest start state."""
    x0, c0 = (1 << 32) - 1, A
    want = loop_words(x0, c0, MODEL_LIMIT)
    picked = set(K.boundaries(MODEL_LIMIT, SMS, every_block=False))
    for n in K.boundaries(1 << 14, SMS):
        if n not in picked:
            assert model_words(x0, c0, n, K.plan(n, SMS)) == want[:n], n


def test_model_under_other_splits():
    """The layouts ``chip_mwc_plans.py`` times (plan's overrides) give the
    loop's words too."""
    x0, c0 = _mwc_state(*MWC_WIDE_CARRY[0])
    want = loop_words(x0, c0, MODEL_LIMIT)
    for n in (8191, 8193, 40001):
        for chunk, threads in ((64, 128), (32, 64), (16, 128), (2, 96),
                               (64, 32), (1, 128)):
            pl = K.plan(n, SMS, chunk=chunk, threads=threads)
            assert model_words(x0, c0, n, pl) == want[:n], (n, pl)


# -- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the mwc kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mwc_kernel_matches_the_loop_at_plan_boundaries(cuda):
    """The kernel equals the loop word for word at every length up to
    2^20 where the card's plan changes its layout or block count, and at
    2^23 - 1, from (7, 3), the wide-carry starts and the largest state."""
    sms = K.sm_count(torch.cuda.current_device())
    states = [_mwc_state(7, 3), ((1 << 32) - 1, A)]
    states += [_mwc_state(*pair) for pair in MWC_WIDE_CARRY]
    lengths = K.boundaries(1 << 20, sms)
    for x0, c0 in states:
        want = mwc_ref(x0, c0, 1 << 20, "cpu")
        for n in lengths:
            got = K.mwc_words(x0, c0, n, cuda)
            assert torch.equal(got.cpu(), want[:n]), (x0, c0, n)
    n = (1 << 23) - 1
    x0, c0 = states[1]
    got = K.mwc_words(x0, c0, n, cuda)
    assert torch.equal(got.cpu(), mwc_ref(x0, c0, n, "cpu"))
