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


@pytest.mark.parametrize("b,s,h,kh,dh,cap,dtype", REF_SHAPES)
def test_mha_matches_pallas_kernel(b, s, h, kh, dh, cap, dtype):
    """The port's wrapper equals the reference wrapper over its Pallas
    kernel (interpret mode) at the reference suite's shapes."""
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


def wgmma_emulation(q, k, v, *, scale, softcap=0.0):
    """The arithmetic of the bfloat16 tensor-core route (``fa_hopper.cuh``)
    in float32 on the CPU: 128-row q tiles and 128-key kv tiles up to the
    diagonal, scores in the log2 domain (scale or softcap folded with
    log2(e), exp2), the mask applied to the diagonal tile only, l summed
    from float32 P, and P rounded to bfloat16 before P.V. On q's device;
    S a multiple of 128."""
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
    for q0 in range(0, s, 128):
        qt = qf[:, :, q0:q0 + 128]
        m = torch.full((b, h, 128), -2.3819763e38, device=dev)
        l = torch.zeros((b, h, 128), device=dev)
        acc = torch.zeros((b, h, 128, dh), device=dev)
        for k0 in range(0, min(t, q0 + 128), 128):
            x = qt @ kf[:, :, k0:k0 + 128].transpose(-1, -2)
            x = (torch.tanh(x * (scale / softcap)) * (softcap * log2e)
                 if softcap else x * (scale * log2e))
            if k0 + 127 > q0:
                masked = (q0 + pos)[:, None] < (k0 + pos)[None, :]
                x = x.masked_fill(masked, -2.3819763e38)
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
    bfloat16 at other head dims the CUDA-core one; the choice is made
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
             (torch.float32, 128, "simt"), (torch.float32, 64, "simt")]
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
    """The launcher refuses a wrong dtype, dh > 128 and CPU tensors
    before it builds or launches anything; none of that counts as a
    launch, and neither does the CPU path of ``mha``."""
    launches = fk.flash_attention.launches
    ok = torch.zeros((1, 128, 2, 64))
    with pytest.raises(TypeError, match="dtype|float"):
        fk.flash_attention(ok.to(torch.int32), ok.to(torch.int32),
                           ok.to(torch.int32), scale=1.0)
    with pytest.raises(TypeError):
        fk.flash_attention(ok, ok.to(torch.bfloat16), ok, scale=1.0)
    wide = torch.zeros((1, 128, 2, 160))
    with pytest.raises(ValueError, match="head_dim 160"):
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
    (1, 128, 8, 1, 64, 0.0, "bfloat16")])        # and MQA at dh 64
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
