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
outputs of magnitude up to ~3).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import attention_ref, mha_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

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
    (1, 200, 12, 2, 128, 0.0, "bfloat16")])      # padded
def test_kernel_matches_plain_on_card(cuda, b, s, h, kh, dh, cap, dtype):
    q, k, v = (_torch(x, dtype).to(cuda) for x in _qkv(s, b, s, h, kh, dh))
    before = fk.flash_attention.launches
    got = mha(q, k, v, scale=dh ** -0.5, softcap=cap)
    torch.cuda.synchronize()
    assert fk.flash_attention.launches == before + 1
    want = mha_ref(q, k, v, scale=dh ** -0.5, softcap=cap)
    assert got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
