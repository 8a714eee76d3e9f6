"""PyTorch port: the flash-attention wrapper against the JAX reference's
Pallas kernel (interpret mode, in-process: it needs no 64-bit mode) and
its oracle.

On the CPU ``ops.mha`` takes the plain version; the CUDA kernel itself is
held against that plain version on the card by the ``cuda``-marked tests
below (skipped without a card) and by ``chip_smoke.py``. Inputs come
from ``numpy.random.default_rng`` with fixed seeds and go to both
packages as the same numbers (bfloat16 inputs are rounded from the same
float32 draws on both sides).

Tolerances are the reference suite's own (``tests/test_kernels.py``):
2e-5 absolute in float32, 2e-2 in bfloat16 (one bfloat16 rounding of
outputs of magnitude up to ~3). The same 2e-2 holds the bfloat16
tensor-core route, whose one numerical change (P rounded to bfloat16
before P.V) is emulated here on the CPU.
"""
import collections
import contextlib
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import attention_ref, mha_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the tensor-core route against its own arithmetic emulated in float32
# (``wgmma_emulation``), each output row relative to its largest value:
# two bfloat16 steps (2^-6) for the output's rounding and the roundings of
# P that exp2's last bits can flip. On an H100 the route stays within one
# step (2^-7) at every bfloat16 shape of ``chip_smoke.py``
WGMMA_ROW_RTOL = 2.0 ** -6

# the reference suite's four shapes (tests/test_kernels.py)
REF_SHAPES = [(2, 256, 4, 2, 64, 0.0, "float32"),
              (1, 384, 2, 2, 128, 50.0, "float32"),
              (1, 128, 8, 1, 64, 0.0, "float32"),      # MQA
              (2, 256, 4, 4, 64, 0.0, "bfloat16")]
# head dim 192 (nemotron-4-340b's, 18432 / 96) in both dtypes: the
# CUDA-core route's DH 192 instantiation takes both on the card
DH192_SHAPES = [(1, 256, 4, 2, 192, 0.0, "float32"),
                (1, 256, 4, 2, 192, 30.0, "bfloat16")]


def _qkv(seed, b, s, h, kh, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh), dtype=np.float32),
            rng.standard_normal((b, s, kh, dh), dtype=np.float32),
            rng.standard_normal((b, s, kh, dh), dtype=np.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    import jax.numpy as jnp
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("b,s,h,kh,dh,cap,dtype", REF_SHAPES + DH192_SHAPES)
def test_mha_matches_pallas_kernel(b, s, h, kh, dh, cap, dtype):
    """The port's wrapper equals the reference wrapper over its Pallas
    kernel (interpret mode) at the reference suite's shapes, and at head
    dim 192 in float32 and bfloat16."""
    from repro.kernels.flash_attention.ops import mha as ref_mha
    q, k, v = _qkv(s + h + dh, b, s, h, kh, dh)
    got = mha(*(_torch(x, dtype) for x in (q, k, v)), scale=dh ** -0.5,
              softcap=cap)
    want = ref_mha(*(_jax(x, dtype) for x in (q, k, v)), scale=dh ** -0.5,
                   softcap=cap, interpret=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, dh)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_pads_ragged_lengths(dtype):
    """S = 200 is padded to 256 and sliced back; the result equals the
    reference oracle on the unpadded inputs (the reference wrapper
    asserts S % 128 == 0, so its oracle is the yardstick here)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    b, s, h, kh, dh = 2, 200, 4, 2, 64
    q, k, v = _qkv(7, b, s, h, kh, dh)
    got = mha(*(_torch(x, dtype) for x in (q, k, v)), scale=dh ** -0.5)
    assert got.shape == (b, s, h, dh)
    qj, kj, vj = (_jax(x, dtype) for x in (q, k, v))
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, s, dh)
    want = jax_ref(fold(qj), fold(jnp.repeat(kj, h // kh, 2)),
                   fold(jnp.repeat(vj, h // kh, 2)), scale=dh ** -0.5)
    want = np.asarray(want, np.float32).reshape(b, h, s, dh)
    np.testing.assert_allclose(got.float().numpy(),
                               want.transpose(0, 2, 1, 3), atol=TOL[dtype])


def test_attention_ref_matches_jax_oracle():
    """The plain version equals the reference oracle (causal), softcap
    included."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    q, k, v = (x[0].transpose(1, 0, 2) for x in _qkv(3, 1, 96, 6, 6, 32))
    for cap in (0.0, 30.0):
        got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                            scale=0.2, softcap=cap)
        want = jax_ref(q, k, v, scale=0.2, softcap=cap, causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_mha_refuses_padding_it_cannot_mask():
    """Padded keys stay masked only when no query sits at or after them:
    a ragged T shorter than S is refused."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 200, 2, 2, 16))
    with pytest.raises(ValueError, match="padded keys"):
        mha(q, k[:, :136], v[:, :136], scale=0.25)


NEG = -2.3819763e38


def wgmma_emulation(q, k, v, *, scale, softcap=0.0, window=0, causal=True,
                    kv_len=None):
    """The arithmetic of the bfloat16 tensor-core route (``fa_hopper.cuh``)
    in float32 on the CPU: 128-row q tiles and 128-key kv tiles up to the
    tile that holds key ``kv_len - 1`` (default T) and, causal, up to the
    diagonal, scores in the log2 domain (scale or softcap folded with
    log2(e), exp2), the mask applied to the diagonal tile and the tile
    that holds key ``kv_len`` only, l summed from float32 P, and P
    rounded to bfloat16 before P.V. With a sliding ``window`` w > 0, the
    kv tiles start at the kernel's ``max(0, q0 - w + 1) // 128`` and the
    tiles at the window's lower edge (``k0 <= q0 + 127 - w``) are masked
    too. On q's device; S and T multiples of 128."""
    b, s, h, dh = q.shape
    t, kh = k.shape[1], k.shape[2]
    dev = q.device
    log2e = 1.4426950408889634
    fold = lambda x: x.transpose(1, 2).float()             # (B, heads, S, dh)
    qf = fold(q)
    kf = fold(k).repeat_interleave(h // kh, dim=1)
    vf = fold(v).repeat_interleave(h // kh, dim=1)
    out = torch.empty((b, h, s, dh), dtype=torch.bfloat16, device=dev)
    pos = torch.arange(128, device=dev)
    kv_len = t if kv_len is None else kv_len
    for q0 in range(0, s, 128):
        qt = qf[:, :, q0:q0 + 128]
        m = torch.full((b, h, 128), NEG, device=dev)
        l = torch.zeros((b, h, 128), device=dev)
        acc = torch.zeros((b, h, 128, dh), device=dev)
        lo = max(0, q0 - window + 1) // 128 * 128 if window else 0
        hi = -(-kv_len // 128) * 128
        for k0 in range(lo, min(hi, q0 + 128) if causal else hi, 128):
            x = qt @ kf[:, :, k0:k0 + 128].transpose(-1, -2)
            x = (torch.tanh(x * (scale / softcap)) * (softcap * log2e)
                 if softcap else x * (scale * log2e))
            if ((causal and k0 + 127 > q0) or k0 + 128 > kv_len
                    or (window and q0 + 127 - k0 >= window)):
                diff = (q0 + pos)[:, None] - (k0 + pos)[None, :]
                masked = (k0 + pos >= kv_len)[None, :]
                if causal:
                    masked = masked | (diff < 0)
                if window:
                    masked = masked | (diff >= window)
                x = x.masked_fill(masked, NEG)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = (acc * alpha[..., None]
                   + p.bfloat16().float() @ vf[:, :, k0:k0 + 128])
            m = m_new
        out[:, :, q0:q0 + 128] = (acc / l.clamp_min(1e-37)[..., None]
                                  ).bfloat16()
    return out.transpose(1, 2)


def simt_emulation(q, k, v, *, scale, softcap=0.0, window=0, causal=True,
                   kv_len=None):
    """The CUDA-core route's loop (``flash_attention.cu``) in float32:
    64-row q tiles, 64-key kv tiles from ``max(0, q0 - w + 1) // 64`` up
    to the tile that holds key ``kv_len - 1`` (default T) and, causal, to
    the diagonal, softcap then mask with NEG on every tile, online softmax
    with exp; a row whose keys all lie past a walked tile carries p = 1
    there until its first kept key clears it."""
    b, s, h, dh = q.shape
    t, kh = k.shape[1], k.shape[2]
    fold = lambda x: x.transpose(1, 2).float()
    qf = fold(q)
    kf = fold(k).repeat_interleave(h // kh, dim=1)
    vf = fold(v).repeat_interleave(h // kh, dim=1)
    out = torch.empty((b, h, s, dh))
    pos = torch.arange(64)
    kv_len = t if kv_len is None else kv_len
    for q0 in range(0, s, 64):
        m = torch.full((b, h, 64), NEG)
        l = torch.zeros((b, h, 64))
        acc = torch.zeros((b, h, 64, dh))
        lo = max(0, q0 - window + 1) // 64 * 64 if window else 0
        hi = -(-kv_len // 64) * 64
        for k0 in range(lo, min(hi, q0 + 64) if causal else hi, 64):
            x = qf[:, :, q0:q0 + 64] @ kf[:, :, k0:k0 + 64].transpose(-1, -2)
            x = x * scale
            if softcap:
                x = torch.tanh(x / softcap) * softcap
            diff = (q0 + pos)[:, None] - (k0 + pos)[None, :]
            masked = (k0 + pos >= kv_len)[None, :].expand(64, 64)
            if causal:
                masked = masked | (diff < 0)
            if window:
                masked = masked | (diff >= window)
            x = x.masked_fill(masked, NEG)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, k0:k0 + 64]
            m = m_new
        out[:, :, q0:q0 + 64] = acc / l.clamp_min(1e-37)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def row_rel_err(got, want):
    """Largest error of a (B, S, H, dh) output relative to its row: over
    every (b, s, h), max |got - want| / max |want| along dh. Late causal
    rows average many keys and are small; this holds them as tightly as
    the early, large ones."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_wgmma_arithmetic_within_tolerance(softcap):
    """The tensor-core route's arithmetic, emulated at a reduced serving
    shape (B1 S512 H4 K2 dh128, four q tiles), stays within the bfloat16
    tolerance of the plain version and of the reference's Pallas kernel
    (interpret mode): rounding P to bfloat16 does not leave 2e-2."""
    from repro.kernels.flash_attention.ops import mha as ref_mha
    b, s, h, kh, dh = 1, 512, 4, 2, 128
    q, k, v = _qkv(16, b, s, h, kh, dh)
    qt, kt, vt = (_torch(x, "bfloat16") for x in (q, k, v))
    got = wgmma_emulation(qt, kt, vt, scale=dh ** -0.5, softcap=softcap)
    assert got.shape == (b, s, h, dh) and got.dtype == torch.bfloat16
    plain = mha_ref(qt, kt, vt, scale=dh ** -0.5, softcap=softcap)
    pallas = ref_mha(*(_jax(x, "bfloat16") for x in (q, k, v)),
                     scale=dh ** -0.5, softcap=softcap, interpret=True)
    for want in (plain.float().numpy(), np.asarray(pallas, np.float32)):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL["bfloat16"])
    # the emulation differs from the plain version (P is rounded), so the
    # check above is not vacuous
    assert float((got.float() - plain.float()).abs().max()) > 0


def test_launcher_routes_by_dtype_and_head_dim(monkeypatch):
    """bfloat16 at dh 64 and 128 takes the tensor-core route, float32 and
    bfloat16 at other head dims (up to 192) the CUDA-core one; the choice is made
    before launch, counted under its route, and no call changes route.
    No kernel is built: ``_entry`` is stubbed, and the CPU tensors pass
    for CUDA ones."""
    asked = []

    def entry(kind):
        def fn(*args):
            asked.append((kind, args[0], args[10]))      # route, dtype, dh
            return 0
        return fn
    monkeypatch.setattr(fk, "_entry", entry)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fk.flash_attention, "launches", 0)
    monkeypatch.setattr(fk.flash_attention, "calls", collections.Counter())
    cases = [(torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
             (torch.bfloat16, 96, "simt"), (torch.bfloat16, 32, "simt"),
             (torch.float32, 128, "simt"), (torch.float32, 64, "simt"),
             (torch.bfloat16, 192, "simt"), (torch.float32, 192, "simt")]
    for dtype, dh, want in cases:
        assert fk.route(dtype, dh) == want
        x = torch.zeros((1, 128, 2, dh), dtype=dtype)
        fk.flash_attention(x, x, x, scale=1.0)
        assert asked[-1] == (want, fk.DTYPES[dtype], dh)
        assert fk.flash_attention.calls[
            (1, 128, 128, 2, 2, dh, str(dtype), want)] == 1
    assert fk.flash_attention.launches == len(cases)
    # _call launches a route as asked and counts nothing (the yardstick
    # launches of chip_smoke.py)
    x = torch.zeros((1, 128, 2, 128), dtype=torch.bfloat16)
    rc, o = fk._call("simt", x, x, x, 1.0, 0.0)
    assert rc == 0 and o.shape == x.shape and o.dtype == x.dtype
    assert asked[-1] == ("simt", fk.DTYPES[torch.bfloat16], 128)
    assert fk.flash_attention.launches == len(cases)
    # the tensor-core route refuses strides TMA cannot take (16 bytes)
    odd = torch.zeros((1, 128, 2, 132), dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="16-byte"):
        fk.flash_attention(odd, odd, odd, scale=1.0)
    assert fk.flash_attention.launches == len(cases)


def test_launcher_validates_inputs():
    """The launcher refuses a wrong dtype, dh > 192 and CPU tensors
    before it builds or launches anything; none of that counts as a
    launch, and neither does the CPU path of ``mha``."""
    launches = fk.flash_attention.launches
    ok = torch.zeros((1, 128, 2, 64))
    with pytest.raises(TypeError, match="dtype|float"):
        fk.flash_attention(ok.to(torch.int32), ok.to(torch.int32),
                           ok.to(torch.int32), scale=1.0)
    with pytest.raises(TypeError):
        fk.flash_attention(ok, ok.to(torch.bfloat16), ok, scale=1.0)
    wide = torch.zeros((1, 128, 2, 256))
    with pytest.raises(ValueError, match="head_dim 256"):
        fk.flash_attention(wide, wide, wide, scale=1.0)
    with pytest.raises(ValueError, match="multiples of 128"):
        fk.flash_attention(ok[:, :100], ok[:, :100], ok[:, :100], scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention(ok, ok, ok, scale=1.0)
    mha(ok, ok, ok, scale=1.0)
    assert fk.flash_attention.launches == launches


# -- on the card (skipped without one)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is built with nvcc for "
                    "sm_90a and runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,dh,cap,dtype", REF_SHAPES + [
    (4, 512, 12, 2, 128, 0.0, "bfloat16"),       # qwen2-1.5b serving shapes
    (2, 2048, 12, 2, 128, 0.0, "bfloat16"),
    (4, 512, 12, 2, 128, 0.0, "float32"),        # the same, float32: the
    (2, 2048, 12, 2, 128, 0.0, "float32"),       # long kv loop at 2e-5
    (1, 200, 12, 2, 128, 0.0, "bfloat16"),       # padded
    (1, 384, 2, 2, 128, 50.0, "bfloat16"),       # tensor cores: softcap
    (1, 128, 8, 1, 64, 0.0, "bfloat16"),         # and MQA at dh 64
    (1, 2048, 32, 2, 128, 0.0, "bfloat16"),      # glm4-9b: GQA group 16
    (1, 2048, 32, 2, 128, 0.0, "float32"),
    (1, 1024, 64, 8, 128, 0.0, "bfloat16"),      # chameleon-34b
    (1, 1024, 96, 8, 192, 0.0, "bfloat16"),      # nemotron-4-340b: dh 192
    (1, 1024, 96, 8, 192, 0.0, "float32"),       # on the CUDA-core route
    (1, 1000, 96, 8, 192, 0.0, "bfloat16")])     # padded
def test_kernel_matches_plain_on_card(cuda, b, s, h, kh, dh, cap, dtype):
    q, k, v = (_torch(x, dtype).to(cuda) for x in _qkv(s, b, s, h, kh, dh))
    before = fk.flash_attention.launches
    calls = fk.flash_attention.calls[
        (b, -(-s // 128) * 128, -(-s // 128) * 128, h, kh, dh,
         str(q.dtype), fk.route(q.dtype, dh))]
    got = mha(q, k, v, scale=dh ** -0.5, softcap=cap)
    torch.cuda.synchronize()
    assert fk.flash_attention.launches == before + 1
    assert fk.flash_attention.calls[
        (b, -(-s // 128) * 128, -(-s // 128) * 128, h, kh, dh,
         str(q.dtype), fk.route(q.dtype, dh))] == calls + 1
    want = mha_ref(q, k, v, scale=dh ** -0.5, softcap=cap)
    assert got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
    if fk.route(q.dtype, dh) == "wgmma" and s % 128 == 0:
        # the same arithmetic (P in bfloat16), each row to its own size
        same = wgmma_emulation(q, k, v, scale=dh ** -0.5, softcap=cap)
        assert row_rel_err(got, same) <= WGMMA_ROW_RTOL


_WATCHDOG_PROBE = r"""
#include <chrono>
#include <cstdio>
#include "fa_hopper.cuh"

__global__ void stuck() {
  __shared__ alignas(8) unsigned long long bar;
  const uint32_t addr = fa_hopper::smem_addr(&bar);
  if (threadIdx.x == 0) fa_hopper::bar_init(addr, 1);
  __syncthreads();
  fa_hopper::bar_wait(addr, 0);   // nothing arrives: phase 0 never ends
}

int main() {
  cudaFree(nullptr);              // create the context before the clock
  const auto t0 = std::chrono::steady_clock::now();
  stuck<<<1, 32>>>();
  const cudaError_t err = cudaDeviceSynchronize();
  const std::chrono::duration<double> dt =
      std::chrono::steady_clock::now() - t0;
  std::printf("%s %.6f\n", cudaGetErrorName(err), dt.count());
  return 0;
}
"""


@pytest.mark.cuda
def test_bar_wait_watchdog_fails_the_launch(cuda, tmp_path):
    """A pipeline fault does not hang the card: ``bar_wait`` on an
    mbarrier that never completes traps once the wait has lasted
    ``kWatchdogNs`` (1 s), and the launch returns an error. Run in a
    process of its own, whose CUDA context the trap ends."""
    import subprocess
    from repro_torch.kernels import build
    src = tmp_path / "watchdog.cu"
    src.write_text(_WATCHDOG_PROBE)
    exe = tmp_path / "watchdog"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xptxas=-v")]
    subprocess.run([build.nvcc(), *flags, "-I",
                    str(build.SOURCES["flash_attention"].parent), "-o",
                    str(exe), str(src)], check=True, capture_output=True,
                   timeout=300)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=60).stdout.split()
    error, seconds = out[0], float(out[1])
    print(f"bar_wait watchdog: {error} after {seconds:.3f} s")
    assert error != "cudaSuccess"
    assert 1.0 <= seconds < 10.0


# -- a v head dim of its own (DeepSeek-V2's MLA: q and k 192 wide, v 128)

# (B, S, H, K, dqk, dv): GQA and plain heads, MLA's 192/128 (the CUDA-core
# route's (192, 128) instantiation), and a pair that instantiation does
# not take (128/64: DV = DQK, v zero-filled past dv)
SPLIT_DV_SHAPES = [(1, 256, 4, 4, 192, 128), (2, 256, 4, 2, 48, 32),
                   (1, 200, 2, 2, 192, 128), (1, 128, 4, 1, 128, 64)]


def _qkv_split(seed, b, s, h, kh, dqk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dqk), dtype=np.float32),
            rng.standard_normal((b, s, kh, dqk), dtype=np.float32),
            rng.standard_normal((b, s, kh, dv), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,dqk,dv", SPLIT_DV_SHAPES)
def test_mha_split_dv_matches_reference_sdpa(b, s, h, kh, dqk, dv, dtype):
    """``mha`` (and ``mha_ref`` under it) with v narrower than q and k
    equals the reference's XLA attention (``repro.models.attention.sdpa``,
    causal, in the model layout with positions), which is what its MLA
    calls; the output has v's head dim. S = 200 is padded to 256."""
    import jax.numpy as jnp
    from repro.models.attention import sdpa
    q, k, v = _qkv_split(s + dqk + dv, b, s, h, kh, dqk, dv)
    scale = dqk ** -0.5
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    got = mha(tq, tk, tv, scale=scale)
    assert got.shape == (b, s, h, dv) and got.dtype == getattr(torch, dtype)
    pos = jnp.arange(s)
    want = sdpa(*(_jax(x, dtype) for x in (q, k, v)), pos, pos, "causal", 0,
                scale, 0.0)
    assert want.shape == got.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])
    if s % 128 == 0:
        assert torch.equal(mha_ref(tq, tk, tv, scale=scale), got)


def test_launcher_passes_dv_after_dh(monkeypatch):
    """A call with dv != dh takes the CUDA-core route, also at bfloat16
    dh 64 and 128 where dv = dh takes the tensor cores; ``args[10]`` stays
    dh, dv is ``args[11]``, right after it, and ``window`` stays the
    argument before the stream; the output is (B, S, H, dv), the 8-field
    ``calls`` key is unchanged and ``split_dv`` counts the call. No
    kernel is built: ``_entry`` is stubbed, and the CPU tensors pass for
    CUDA ones."""
    asked = []

    def entry(kind):
        def fn(*args):
            asked.append((kind, args[0], args[10], args[-2], args[11]))
            return 0
        return fn
    monkeypatch.setattr(fk, "_entry", entry)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fk.flash_attention, "launches", 0)
    monkeypatch.setattr(fk.flash_attention, "calls", collections.Counter())
    monkeypatch.setattr(fk.flash_attention, "split_dv", 0)
    cases = [(torch.bfloat16, 192, 128, 0, "simt"),
             (torch.float32, 192, 128, 0, "simt"),
             (torch.bfloat16, 128, 64, 300, "simt"),
             (torch.bfloat16, 64, 32, 0, "simt"),
             (torch.bfloat16, 128, 128, 0, "wgmma")]
    for i, (dtype, dh, dv, window, want) in enumerate(cases):
        assert fk.route(dtype, dh, dv) == want
        q = torch.zeros((1, 128, 4, dh), dtype=dtype)
        k = torch.zeros((1, 128, 2, dh), dtype=dtype)
        v = torch.zeros((1, 128, 2, dv), dtype=dtype)
        o = fk.flash_attention(q, k, v, scale=1.0, window=window)
        assert o.shape == (1, 128, 4, dv) and o.dtype == dtype
        assert asked[-1] == (want, fk.DTYPES[dtype], dh, window, dv)
        assert fk.flash_attention.calls[
            (1, 128, 128, 4, 2, dh, str(dtype), want)] == 1
        assert fk.flash_attention.split_dv == min(i + 1, 4)
    assert fk.route(torch.bfloat16, 64) == "wgmma"
    assert fk.flash_attention.launches == len(cases)


def test_launcher_refuses_a_v_that_does_not_fit():
    """dv above q's and k's head dim, and a v that differs from k in B, T
    or K, are refused before any build or launch."""
    launches = fk.flash_attention.launches
    q = torch.zeros((1, 128, 4, 128))
    k = torch.zeros((1, 128, 2, 128))
    bad = {"dv above dh": torch.zeros((1, 128, 2, 192)),
           "B": torch.zeros((2, 128, 2, 64)),
           "T": torch.zeros((1, 256, 2, 64)),
           "K": torch.zeros((1, 128, 4, 64))}
    for what, v in bad.items():
        with pytest.raises(ValueError, match="do not fit"):
            fk.flash_attention(q, k, v, scale=1.0)
    assert fk.flash_attention.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,h,kh,dqk,dv", [
    (1, 1024, 128, 128, 192, 128),              # deepseek-v2's MLA heads
    (1, 1000, 128, 128, 192, 128),              # padded
    (2, 256, 4, 2, 48, 32)])
def test_split_dv_kernel_matches_plain_on_card(cuda, b, s, h, kh, dqk, dv,
                                               dtype):
    q, k, v = (_torch(x, dtype).to(cuda)
               for x in _qkv_split(s, b, s, h, kh, dqk, dv))
    before = (fk.flash_attention.launches, fk.flash_attention.split_dv)
    got = mha(q, k, v, scale=dqk ** -0.5)
    torch.cuda.synchronize()
    assert (fk.flash_attention.launches,
            fk.flash_attention.split_dv) == (before[0] + 1, before[1] + 1)
    want = mha_ref(q, k, v, scale=dqk ** -0.5)
    assert got.shape == want.shape == (b, s, h, dv)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


# -- the non-causal form (whisper's encoder self-attention and its
# decoder's cross attention) and a count of real keys

# (B, S, T, H, K, dh, softcap, dtype): S and T multiples of 128, S < T,
# S = T and S > T
BIDIR_SHAPES = [(2, 256, 256, 4, 2, 64, 0.0, "float32"),
                (1, 128, 384, 2, 2, 128, 50.0, "float32"),
                (2, 256, 128, 4, 4, 64, 0.0, "bfloat16"),
                (1, 384, 256, 4, 1, 64, 30.0, "bfloat16")]


def _qkv_st(seed, b, s, t, h, kh, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh), dtype=np.float32),
            rng.standard_normal((b, t, kh, dh), dtype=np.float32),
            rng.standard_normal((b, t, kh, dh), dtype=np.float32))


@pytest.mark.parametrize("b,s,t,h,kh,dh,cap,dtype", BIDIR_SHAPES)
def test_mha_bidir_matches_pallas_kernel(b, s, t, h, kh, dh, cap, dtype):
    """``mha(causal=False)`` and its plain version equal the reference
    wrapper over its Pallas kernel's ``causal=False`` form (interpret
    mode), with S below, at and above T."""
    from repro.kernels.flash_attention.ops import mha as ref_mha
    q, k, v = _qkv_st(s + t + dh, b, s, t, h, kh, dh)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    want = np.asarray(ref_mha(*(_jax(x, dtype) for x in (q, k, v)),
                              scale=dh ** -0.5, softcap=cap, causal=False,
                              interpret=True), np.float32)
    for got in (mha(tq, tk, tv, scale=dh ** -0.5, softcap=cap, causal=False),
                mha_ref(tq, tk, tv, scale=dh ** -0.5, softcap=cap,
                        causal=False)):
        assert got.dtype == getattr(torch, dtype)
        assert got.shape == (b, s, h, dh)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL[dtype])
    # the non-causal form is not the causal one at these shapes
    assert not torch.allclose(mha(tq, tk, tv, scale=dh ** -0.5,
                                  causal=False),
                              mha(tq, tk, tv, scale=dh ** -0.5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t", [(12, 300), (200, 300), (4, 1500), (1, 1),
                                 (300, 130)])
def test_kv_len_mask_matches_reference_sdpa(s, t, dtype):
    """At a key count T that is no multiple of 128, ``mha(causal=False)``
    pads T and masks the padding by the count (``kv_len = T``): it equals
    the reference's XLA attention (``repro.models.attention.sdpa``,
    ``"bidir"``: whisper's encoder and cross attention) on the unpadded
    inputs, and so does ``mha_ref(kv_len=T)`` on zero-padded keys."""
    import jax.numpy as jnp
    from repro.models.attention import sdpa
    b, h, kh, dh = 2, 4, 2, 32
    q, k, v = _qkv_st(s * 7 + t, b, s, t, h, kh, dh)
    scale = dh ** -0.5
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    got = mha(tq, tk, tv, scale=scale, causal=False)
    assert got.shape == (b, s, h, dh) and got.dtype == getattr(torch, dtype)
    want = sdpa(*(_jax(x, dtype) for x in (q, k, v)), jnp.arange(s),
                jnp.arange(t), "bidir", 0, scale, 0.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])
    tp = -(-t // 128) * 128
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, tp - t))
    padded = mha_ref(tq, pad(tk), pad(tv), scale=scale, causal=False,
                     kv_len=t)
    np.testing.assert_allclose(
        padded.float().numpy(),
        mha_ref(tq, tk, tv, scale=scale, causal=False).float().numpy(),
        atol=TOL[dtype])


def test_mha_refuses_a_window_without_the_causal_form():
    """A sliding window needs the causal form: ``mha``, ``mha_ref`` and
    the launcher refuse it with ``causal=False``; the launcher also
    refuses a key count outside (0, T] and a window over fewer than T
    keys, before any build or launch. The causal form keeps refusing a
    ragged T shorter than S, which the non-causal one takes."""
    launches = fk.flash_attention.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 256, 2, 2, 16))
    with pytest.raises(ValueError, match="causal form"):
        mha(q, k, v, scale=0.25, window=64, causal=False)
    with pytest.raises(ValueError, match="causal form"):
        mha_ref(q, k, v, scale=0.25, window=64, causal=False)
    for kw in ({"window": 64, "causal": False}, {"kv_len": 0},
               {"kv_len": 257}, {"window": 64, "kv_len": 200}):
        with pytest.raises(ValueError, match="causal form|kv_len"):
            fk.flash_attention(q, k, v, scale=0.25, **kw)
    with pytest.raises(ValueError, match="padded keys"):
        mha(q, k[:, :136], v[:, :136], scale=0.25)
    assert mha(q, k[:, :136], v[:, :136], scale=0.25,
               causal=False).shape == q.shape
    assert fk.flash_attention.launches == launches


@pytest.mark.parametrize("kv_len", [1, 64, 100, 128, 300, 384])
def test_noncausal_loops_of_both_routes_match_plain(kv_len):
    """The two CUDA routes' non-causal loops, emulated (tiles from 0 to
    the one that holds key ``kv_len - 1``; the CUDA-core route masks
    keys past the count on every tile, the tensor-core one on that last
    tile only, P in bfloat16), equal the plain version at S = 256
    queries over T = 384 keys of which ``kv_len`` are real: float32 within
    2e-5 (with a softcap), bfloat16 within 2e-2."""
    q, k, v = (torch.from_numpy(x)
               for x in _qkv_st(kv_len, 1, 256, 384, 4, 2, 64))
    kw = {"scale": 0.125, "causal": False, "kv_len": kv_len}
    got = simt_emulation(q, k, v, softcap=30.0, **kw)
    want = mha_ref(q, k, v, softcap=30.0, **kw)
    assert float((got - want).abs().max()) <= TOL["float32"]
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    got = wgmma_emulation(qb, kb, vb, **kw)
    want = mha_ref(qb, kb, vb, **kw)
    assert float((got.float() - want.float()).abs().max()) <= TOL["bfloat16"]
    assert row_rel_err(got, want) <= 2.0 ** -5


def test_launcher_passes_causal_and_kv_len(monkeypatch):
    """``causal`` and ``kv_len`` go to both C entry points right after
    the strides (``args[21:23]``); the two floats and the window stay the
    three arguments before the stream, dh ``args[10]``. The causal
    default passes (1, T); a non-causal launch is counted in
    ``flash_attention.bidir`` and keeps the 8-field ``calls`` key. No
    kernel is built: ``_entry`` is stubbed, and the CPU tensors pass for
    CUDA ones."""
    asked = []

    def entry(kind):
        def fn(*args):
            asked.append((kind, args[10], args[21:23], args[-4:-1]))
            return 0
        return fn
    monkeypatch.setattr(fk, "_entry", entry)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fk.flash_attention, "launches", 0)
    monkeypatch.setattr(fk.flash_attention, "bidir", 0)
    monkeypatch.setattr(fk.flash_attention, "calls", collections.Counter())
    q = torch.zeros((2, 128, 12, 64), dtype=torch.bfloat16)
    kv = torch.zeros((2, 1536, 12, 64), dtype=torch.bfloat16)
    fk.flash_attention(q, kv, kv, scale=0.125, causal=False, kv_len=1500)
    assert asked[-1] == ("wgmma", 64, (0, 1500), (0.125, 0.0, 0))
    fk.flash_attention(q, kv, kv, scale=0.125, softcap=5.0)
    assert asked[-1] == ("wgmma", 64, (1, 1536), (0.125, 5.0, 0))
    x = torch.zeros((1, 256, 4, 64))
    fk.flash_attention(x, x, x, scale=0.5, causal=False)
    assert asked[-1] == ("simt", 64, (0, 256), (0.5, 0.0, 0))
    fk.flash_attention(x, x, x, scale=0.5, window=300)
    assert asked[-1] == ("simt", 64, (1, 256), (0.5, 0.0, 300))
    assert (fk.flash_attention.launches, fk.flash_attention.bidir) == (4, 2)
    assert fk.flash_attention.calls[
        (2, 128, 1536, 12, 12, 64, str(torch.bfloat16), "wgmma")] == 2
    rc, _ = fk._call("wgmma", q, kv, kv, 0.125, 0.0)
    assert rc == 0 and asked[-1][2] == (1, 1536)
    rc, _ = fk._call("simt", q, kv, kv, 0.125, 0.0, 0, False, 7)
    assert rc == 0 and asked[-1][2] == (0, 7)
    assert (fk.flash_attention.launches, fk.flash_attention.bidir) == (4, 2)


# whisper-small's attention on the card: (B, S, T, kv_len, H, dh). The
# encoder (1,500 frames padded to 1,536; B 2 here, 8 in chip_smoke.py),
# the decoder's cross attention from a 4- and a 224-token prompt, and key
# counts of one key, half a tile, one tile and every key
WHISPER_BIDIR = [(2, 1536, 1536, 1500, 12, 64), (8, 128, 1536, 1500, 12, 64),
                 (1, 256, 1536, 1500, 12, 64), (1, 256, 1536, 1, 12, 64),
                 (1, 256, 1536, 64, 12, 64), (1, 256, 1536, 128, 12, 64),
                 (1, 256, 1536, 1536, 12, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,t,kv_len,h,dh", WHISPER_BIDIR)
def test_noncausal_kernel_matches_plain_on_card(cuda, b, s, t, kv_len, h, dh,
                                                dtype):
    """Both routes' non-causal form (bfloat16 on ``wgmma``, float32 on
    ``simt``) against the plain version at whisper's shapes and at the
    edge key counts; bfloat16 also row by row against its own
    arithmetic."""
    q, k, v = (_torch(x, dtype).to(cuda)
               for x in _qkv_st(kv_len, b, s, t, h, h, dh))
    before = (fk.flash_attention.launches, fk.flash_attention.bidir)
    got = fk.flash_attention(q, k, v, scale=dh ** -0.5, causal=False,
                             kv_len=kv_len)
    torch.cuda.synchronize()
    assert (fk.flash_attention.launches,
            fk.flash_attention.bidir) == (before[0] + 1, before[1] + 1)
    want = mha_ref(q, k, v, scale=dh ** -0.5, causal=False, kv_len=kv_len)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
    if dtype == "bfloat16":
        same = wgmma_emulation(q, k, v, scale=dh ** -0.5, causal=False,
                               kv_len=kv_len)
        assert row_rel_err(got, same) <= WGMMA_ROW_RTOL
