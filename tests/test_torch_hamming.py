"""The Hamming distance matrix in bf16 (ops/hamming.py).

The port multiplies the unpacked bits as bf16, as the JAX package does:
0/1 operands and counts up to 256 are exact in bf16, so the distances must
be bit-equal to the f32 product of the same bits and to the JAX
`distance_matrix`, for a [K1,8] x [K2,8] pair and for a batched
[N, K2, 8] second set, with invalid rows on both sides (+inf).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.ops import hamming as jhamming
from mono_slam_framework_torch.ops import hamming


def _f32_reference(d1, d2, v1, v2):
    """The f32 product of the same bits (the port's previous form)."""
    b1 = hamming.unpack_bits(d1)
    b2 = hamming.unpack_bits(d2)
    assert b1.dtype == torch.float32
    d = b1.sum(-1)[:, None] + b2.sum(-1)[..., None, :] - 2.0 * (b1 @ b2.transpose(-1, -2))
    return torch.where(v1[:, None] & v2[..., None, :], d, torch.inf)


def _descs(rng, *shape):
    d = rng.integers(0, 2**32, size=(*shape, 8), dtype=np.uint32)
    d[..., :3, :] = np.uint32(0xFFFFFFFF)  # 256 set bits: the largest count
    return d


@pytest.mark.parametrize("batch", [(), (3,)])
def test_distance_matrix_bf16_is_exact(batch):
    rng = np.random.default_rng(len(batch))
    a = _descs(rng, 300)
    b = _descs(rng, *batch, 200)
    b[..., 10, :] = a[4]  # an exact match: distance 0
    va = np.ones(300, bool)
    vb = np.ones((*batch, 200), bool)
    va[[7, 8]] = False
    vb[..., [20, 21]] = False
    args = [torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)),
            torch.from_numpy(va), torch.from_numpy(vb)]
    got = hamming.distance_matrix(*args)
    assert got.dtype == torch.float32 and got.shape == (*batch, 300, 200)
    np.testing.assert_array_equal(got.numpy(), _f32_reference(*args).numpy())
    if batch:
        for i in range(batch[0]):
            ref = np.asarray(jhamming.distance_matrix(
                jnp.asarray(a), jnp.asarray(b[i]), jnp.asarray(va), jnp.asarray(vb[i])))
            np.testing.assert_array_equal(got[i].numpy(), ref)
    else:
        ref = np.asarray(jhamming.distance_matrix(*map(jnp.asarray, (a, b, va, vb))))
        np.testing.assert_array_equal(got.numpy(), ref)
    g = got.reshape(-1, 300, 200)
    assert (g[:, 4, 10] == 0).all() and (g[:, 0, 0] == 0).all()  # all-ones pair
    assert np.isinf(g[:, 7].numpy()).all() and np.isinf(g[:, :, 20].numpy()).all()
    assert float(g[torch.isfinite(g)].max()) <= 256.0


def test_unpack_bits_dtypes():
    words = torch.tensor([[-1, 0, 1, 2**31 - 1, -(2**31), 5, 6, 7]], dtype=torch.int32)
    f32 = hamming.unpack_bits(words)
    bf16 = hamming.unpack_bits(words, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and f32.dtype == torch.float32
    np.testing.assert_array_equal(bf16.float().numpy(), f32.numpy())
    assert f32[0, :32].sum() == 32 and f32[0, 32:64].sum() == 0 and f32[0, 159] == 1
