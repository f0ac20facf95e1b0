"""trlx_tpu_torch.ops.flash_attention on the CPU (its plain version)
against the JAX package's Pallas `flash_attention` (interpret mode) and
`_attention_reference`, including the (m, l) stats of `_flash_forward`.
fp32 inputs from numpy; atol = rtol = 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.flash_attention import (
    _attention_reference,
    _flash_forward,
    flash_attention as j_flash,
)

from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

TOL = dict(atol=2e-5, rtol=2e-5)

# (B, H, Hkv, T, S, D)
CASES = {
    "square": (2, 2, 2, 16, 16, 8),
    "gqa": (2, 4, 2, 16, 16, 8),
    "ragged-s": (1, 2, 2, 8, 136, 8),  # S not a multiple of 128
}


def _inputs(B, H, Hkv, T, S, D, seed=0, pad=()):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    for b, n in pad:
        mask[b, :n] = 0  # left padding
    return q, k, v, mask


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_kernel_and_stats(case, causal):
    B, H, Hkv, T, S, D = CASES[case]
    q, k, v, mask = _inputs(B, H, Hkv, T, S, D, pad=((0, 3),))
    scale = D ** -0.5
    if case == "ragged-s":
        # the reference's TPU tiling needs 128 | S; compare with its plain
        # oracle there (it has no stats)
        ref_out = _attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal, scale
        )
        out = flash_attention(*_torch(q, k, v, mask), causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
        return
    ref_out, ref_m, ref_l = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        causal, scale, 256, with_stats=True,
    )
    out, m, l = flash_attention(*_torch(q, k, v, mask), causal=causal, with_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(ref_l), **TOL)


def test_prefill_offset_matches_jax_kernel():
    """A KV-cache prefill: T queries at slots [q_offset, q_offset + T) of
    an S-slot cache whose unwritten slots are masked."""
    B, H, T, S, D, off = 2, 2, 8, 128, 8, 0
    q, k, v, mask = _inputs(B, H, H, T, S, D, seed=1, pad=((1, 3),))
    mask[:, off + T:] = 0
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), q_offset=off)
    out = flash_attention(*_torch(q, k, v, mask), q_offset=off)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fully_masked_row_is_uniform_average():
    """A left-pad query sees no attendable slot: every score is -1e30, so
    the output is the plain mean of v over all S slots (not NaN)."""
    B, H, T, S, D = 1, 2, 8, 8, 8
    q, k, v, mask = _inputs(B, H, H, T, S, D, seed=2, pad=((0, 5),))
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    out, m, l = flash_attention(*_torch(q, k, v, mask), with_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy()[0, :, :5], np.broadcast_to(v.mean(axis=2)[0][:, None], (H, 5, D)), **TOL)
    assert np.all(m.numpy().reshape(H, T)[:, :5] == np.float32(-1e30))
    assert np.all(l.numpy().reshape(H, T)[:, :5] == S)


def test_real_rows_match_attention_reference():
    """On rows with at least one attendable slot, the fused function is
    plain softmax attention (`_attention_reference`)."""
    B, H, Hkv, T, S, D = CASES["gqa"]
    q, k, v, mask = _inputs(B, H, Hkv, T, S, D, seed=3, pad=((0, 6), (1, 2)))
    ref = np.asarray(_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), True, D ** -0.5
    ))
    out = flash_attention_plain(*_torch(q, k, v, mask)).numpy()
    for b in range(B):
        real = mask[b].astype(bool)
        np.testing.assert_allclose(out[b][:, real], ref[b][:, real], **TOL)
