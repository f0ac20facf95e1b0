"""trlx_tpu_torch.ops.flash_attention on the CPU (its plain version)
against the JAX package's Pallas `flash_attention` (interpret mode) and
`_attention_reference`, including the (m, l) stats of `_flash_forward`,
also at the lengths where the CUDA forward changes route
(`forward_route`). fp32 inputs from numpy; atol = rtol = 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.flash_attention import (
    _attention_reference,
    _flash_forward,
    flash_attention as j_flash,
)

from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain, forward_route

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


def test_cross_attention_t_gt_s_matches_jax_kernel():
    """T5's cross-attention: not causal, no scale (sm_scale 1), more query
    rows than key slots (T > S, so the default offset S - T is negative and
    must play no part); batch row 1 has every slot masked."""
    B, H, T, S, D = 2, 2, 24, 16, 8
    q, k, v, mask = _inputs(B, H, H, T, S, D, seed=4, pad=((0, 5), (1, S)))
    ref_out, ref_m, ref_l = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), False, 1.0, 256, with_stats=True,
    )
    out, m, l = flash_attention(*_torch(q, k, v, mask), causal=False, sm_scale=1.0, with_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(ref_l), **TOL)
    # an explicit negative offset is ignored without causality, as the default is
    again = flash_attention(*_torch(q, k, v, mask), causal=False, sm_scale=1.0, q_offset=S - T)
    np.testing.assert_array_equal(again.numpy(), out.numpy())


def _assert_matches_flash_forward(q, k, v, mask, causal, scale, q_offset=None):
    """The port's forward (out, m, l) against the interpreted `_flash_forward`
    on the same inputs; returns the port's (out, m, l) as numpy."""
    ref = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        causal, scale, 256, with_stats=True, q_offset=q_offset,
    )
    got = flash_attention(*_torch(q, k, v, mask), causal=causal, sm_scale=scale, q_offset=q_offset, with_stats=True)
    for name, a, b in zip(("out", "m", "l"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    return [x.numpy() for x in got]


@pytest.mark.parametrize("T, S, route", [
    (16, 16, "short"), (16, 72, "short"), (16, 128, "short"), (16, 129, "long"),
    (72, 16, "short"), (72, 72, "short"), (72, 128, "short"), (72, 129, "long"),
    (128, 16, "short"), (128, 72, "short"), (128, 128, "short"), (128, 129, "long"),
    (129, 16, "long"), (129, 72, "long"), (129, 128, "long"), (129, 129, "long"),
    (1, 1, "short"),
    (32, 128, "short"),  # the rollout prefill over its 128-slot cache
    (64, 64, "short"),  # GPT-2's train steps
    (65, 32, "short"),  # T5's cross-attention
    (200, 200, "long"),
    (1024, 1024, "long"),
])
def test_forward_route(T, S, route):
    """The CUDA forward takes the short kernel while T and S are both at
    most 128, and the long route past that."""
    assert forward_route(T, S) == route


@pytest.mark.parametrize("n", [128, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_route_edges_match_jax_kernel(n, causal):
    """T = S = 128 (the short route's largest shape) and 129 (the long
    route's smallest) at a narrow head width: batch row 0 left-padded by
    40 slots, so its first 40 causal rows are fully masked."""
    B, H, D = 2, 2, 8
    q, k, v, mask = _inputs(B, H, H, n, n, D, seed=n, pad=((0, 40),))
    _, m, _ = _assert_matches_flash_forward(q, k, v, mask, causal, D ** -0.5)
    if causal:
        assert np.all(m.reshape(B, H, n)[0, :, :40] == np.float32(-1e30))


def test_gqa_within_short_route_matches_jax_kernel():
    """A GQA group of 3 query heads a kv head at T = S = 100 (inside the
    short route), left padding in both batch rows."""
    q, k, v, mask = _inputs(2, 6, 2, 100, 100, 8, seed=5, pad=((0, 17), (1, 60)))
    _assert_matches_flash_forward(q, k, v, mask, True, 8 ** -0.5)


def test_causal_t_gt_s_fully_masked_rows_match_jax_kernel():
    """T = 80 queries over S = 48 slots, causal at the default offset
    S - T = -32: the first 32 rows attend no slot by causality alone (no
    padding), so they average V uniformly over all S slots, with m = -1e30
    and l = S."""
    B, H, T, S, D = 2, 2, 80, 48, 8
    q, k, v, mask = _inputs(B, H, H, T, S, D, seed=6, pad=((1, 9),))
    out, m, l = _assert_matches_flash_forward(q, k, v, mask, True, D ** -0.5)
    m, l = m.reshape(B, H, T), l.reshape(B, H, T)
    assert np.all(m[:, :, :32] == np.float32(-1e30)) and np.all(l[:, :, :32] == S)
    np.testing.assert_allclose(out[0, :, :32], np.broadcast_to(v.mean(axis=2)[0][:, None], (H, 32, D)), **TOL)
    # batch row 1's left padding masks 9 slots more: its first 32 + 9 rows
    assert np.all(m[1, :, :41] == np.float32(-1e30)) and np.all(m[1, :, 41:] > -1e29)


def test_left_padding_fully_masks_early_rows_with_stats():
    """The teacher-forced layout at the experience pass's length (T = S =
    72): left padding of 30 and 72 slots (batch row 1 wholly padded) makes
    the first 30 and all 72 rows fully masked; out, m and l against the
    interpreted kernel, and m = -1e30, l = S on exactly those rows."""
    B, H, T, D = 2, 2, 72, 8
    q, k, v, mask = _inputs(B, H, H, T, T, D, seed=7, pad=((0, 30), (1, T)))
    _, m, l = _assert_matches_flash_forward(q, k, v, mask, True, D ** -0.5)
    m, l = m.reshape(B, H, T), l.reshape(B, H, T)
    assert np.all(m[0, :, :30] == np.float32(-1e30)) and np.all(m[0, :, 30:] > -1e29)
    assert np.all(m[1] == np.float32(-1e30)) and np.all(l[1] == T) and np.all(l[0, :, :30] == T)
