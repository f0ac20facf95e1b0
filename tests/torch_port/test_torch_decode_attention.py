"""trlx_tpu_torch.ops.decode_attention on the CPU (its plain version)
against the JAX package's Pallas `decode_attention_int8` (interpret
mode): every layer of an L=3 int8 cache, a padded row, GQA. fp32 q;
atol 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.decode_attention import decode_attention_int8 as j_decode

from trlx_tpu_torch.ops.decode_attention import decode_attention_int8


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_every_layer_matches_jax_kernel(H, Hkv):
    L, B, S, D = 3, 2, 128, 16  # the reference kernel needs 128 | S
    rng = np.random.default_rng(H + Hkv)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    ck = rng.integers(-127, 128, size=(L, B, Hkv, S, D)).astype(np.int8)
    cv = rng.integers(-127, 128, size=(L, B, Hkv, S, D)).astype(np.int8)
    ks = (rng.random(size=(L, B, Hkv, 1, S)) * 0.02).astype(np.float32)
    vs = (rng.random(size=(L, B, Hkv, 1, D)) * 0.02).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :9] = 0  # left-padded prompt
    mask[:, 100:] = 0  # unwritten slots
    for ix in range(L):
        ref = j_decode(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(ks),
            jnp.asarray(vs[ix]), jnp.asarray(mask), ix, sm_scale=D ** -0.5,
        )
        got = decode_attention_int8(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            torch.from_numpy(ks), torch.from_numpy(vs[ix]), torch.from_numpy(mask),
            ix, D ** -0.5,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
