"""The float forward's linear layers round once, as the JAX package's do.

The JAX encoder forms each product with ``preferred_element_type=float32``,
adds the f32 bias (and, for the FFN's first projection, the exact GELU) and
rounds once to the compute dtype (``adaptive_classifier_tpu/models/
encoder.py:454-456`` QKV, ``:514-515`` O, ``:523-527`` FFN).  A product
rounded to bf16 before the bias is added rounds twice and equals that order
on only ~0.7 of the outputs.  Here the port's ``_linear`` (and
``_linear_gelu``) plus the cast must equal the JAX order bit for bit on at
least 95% of the bf16 outputs (CPU; the rest differ by the order of the
f32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_classifier_tpu_torch.models import encoder as tenc

#: rows, contraction, columns: a 256 x 16 chunk of the zoo's encoder through
#: its QKV projection (D 512, 3D 1,536)
M, K, N = 4096, 512, 1536


def _operands(seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32)
    w = (0.05 * r.standard_normal((K, N))).astype(np.float32)
    b = (0.1 * r.standard_normal(N)).astype(np.float32)
    return x, w, b


def _jax_order(x, w, b, gelu):
    y = jnp.einsum("md,de->me", jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                   preferred_element_type=jnp.float32) + jnp.asarray(b)
    if gelu:
        y = jax.nn.gelu(y, approximate=False)
    return torch.from_numpy(np.array(y.astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("gelu", [False, True], ids=["qkv_o_ffn_out", "ffn_in_gelu"])
def test_linear_rounds_once_like_jax(seed, gelu):
    x, w, b = _operands(seed)
    want = _jax_order(x, w, b, gelu)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    layer = tenc._linear_gelu if gelu else tenc._linear
    got = layer(tx, tw, torch.from_numpy(b)).to(torch.bfloat16).float()
    equal = (got == want).double().mean().item()
    print(f"gelu={gelu} seed={seed}: {equal:.6f} of the bf16 outputs equal the JAX "
          f"order's, max abs error {(got - want).abs().max().item():.3g}")
    assert got.shape == (M, N)
    assert equal >= 0.95


def test_linear_keeps_leading_axes_and_f32():
    """``[B, S, D]`` rows in, ``[B, S, N]`` f32 out; in float32 the product
    is the plain f32 one."""
    x, w, b = _operands(2)
    tx = torch.from_numpy(x[:96]).reshape(4, 24, K)
    got = tenc._linear(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.shape == (4, 24, N) and got.dtype == torch.float32
    torch.testing.assert_close(got.reshape(96, N),
                               torch.from_numpy(x[:96] @ w + b), atol=1e-4, rtol=1e-5)
    bf = tenc._linear(tx.to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16),
                      torch.from_numpy(b))
    assert bf.dtype == torch.float32
