"""The backward of trlx_tpu_torch's fused attention on the CPU (its plain
version, `flash_attention_backward_plain`, behind the autograd Function)
against the JAX package's Pallas backward (interpret mode): the raw
`_flash_backward` on shared residuals, and `jax.grad` through
`flash_attention` against `torch.autograd.grad` through the port's, also
at the lengths where the CUDA backward changes route (`backward_route`).

fp32 inputs from numpy. Tolerance atol = rtol = 1e-4: the gradients are
sums over up to S terms of O(1) products, taken in a different order by
the two frameworks (the Pallas kernels sum chunk by chunk)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.flash_attention import _flash_backward, _flash_forward
from trlx_tpu.ops.flash_attention import flash_attention as j_flash

from trlx_tpu_torch.ops.flash_attention import backward_route, flash_attention, flash_attention_backward_plain

TOL = dict(atol=1e-4, rtol=1e-4)

# name: (B, H, Hkv, T, S, D, q_offset, left pads per batch row)
CASES = {
    "square": (2, 2, 2, 16, 16, 8, None, (5, 0)),
    "gqa-rep3": (2, 6, 2, 16, 16, 8, None, (0, 7)),
    "t-lt-s": (2, 2, 2, 8, 24, 8, None, (3, 20)),  # row 1: every query fully masked
    "prefill-offset": (2, 2, 2, 8, 24, 8, 4, (2, 0)),
    "fully-padded-row": (2, 4, 2, 8, 8, 8, None, (8, 1)),
}


def _inputs(B, H, Hkv, T, S, D, q_offset, pads, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    g = rng.normal(size=(B, H, T, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    for b, n in enumerate(pads):
        mask[b, :n] = 0  # left padding
    if q_offset is not None:
        mask[:, q_offset + T:] = 0  # a prefill: cache slots not yet written
    return q, k, v, g, mask


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_flash_backward(case, causal):
    """`flash_attention_backward_plain` against `_flash_backward` on the
    same forward residuals (out, m, l)."""
    B, H, Hkv, T, S, D, off, pads = CASES[case]
    q, k, v, g, mask = _inputs(B, H, Hkv, T, S, D, off, pads)
    scale = D ** -0.5
    jq, jk, jv, jg, jm = map(jnp.asarray, (q, k, v, g, mask))
    o, m, l = _flash_forward(jq, jk, jv, jm, causal, scale, 256, with_stats=True, q_offset=off)
    ref = _flash_backward(jq, jk, jv, jm, o, m, l, jg, causal, scale, 256, q_offset=off)
    got = flash_attention_backward_plain(
        *_t(q, k, v, mask, np.asarray(o), np.asarray(m), np.asarray(l), g),
        causal, scale, S - T if off is None else off,
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(case, causal):
    """torch.autograd through the port's `flash_attention` (the autograd
    Function) against jax.grad through the reference's custom_vjp."""
    B, H, Hkv, T, S, D, off, pads = CASES[case]
    q, k, v, g, mask = _inputs(B, H, Hkv, T, S, D, off, pads, seed=1)

    def j_loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, jnp.asarray(mask), causal, None, 256, off) * jnp.asarray(g))

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(mask), causal=causal, q_offset=off)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_fully_masked_rows_reach_dv_only():
    """A fully masked query row has uniform p = 1/l over every slot,
    causal-future slots included: its output gradient lands in dv at all
    S slots and nowhere in dq or dk."""
    B, H, Hkv, T, S, D = 1, 2, 2, 8, 8, 8
    q, k, v, g, mask = _inputs(B, H, Hkv, T, S, D, None, (S,))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(mask))
    dq, dk, dv = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    assert torch.all(dq == 0) and torch.all(dk == 0)
    np.testing.assert_allclose(
        dv.numpy(), np.broadcast_to(g.sum(axis=2, keepdims=True) / S, dv.shape), **TOL
    )


def test_grad_flows_only_through_the_function_when_required():
    """Without grad, the forward is the plain path (no autograd graph);
    with grad, the output carries the Function's backward."""
    q, k, v, _, mask = _inputs(1, 2, 2, 4, 4, 8, None, (0,))
    tq, tk, tv = _t(q, k, v)
    assert flash_attention(tq, tk, tv, torch.from_numpy(mask)).grad_fn is None
    out = flash_attention(tq.requires_grad_(True), tk, tv, torch.from_numpy(mask))
    assert type(out.grad_fn).__name__ == "_FlashAttentionFnBackward"


@pytest.mark.parametrize("path", ["raw", "autograd"])
def test_cross_attention_t_gt_s_backward_matches_jax(path):
    """T5's cross-attention backward: not causal, sm_scale 1, T = 24 query
    rows over S = 16 slots (a negative default offset, ignored), batch row
    1 wholly masked. `raw`: the plain backward against `_flash_backward`
    on the same residuals; `autograd`: torch.autograd against jax.grad."""
    B, H, T, S, D = 2, 2, 24, 16, 8
    q, k, v, g, mask = _inputs(B, H, H, T, S, D, None, (5, S), seed=2)
    jq, jk, jv, jg, jm = map(jnp.asarray, (q, k, v, g, mask))
    if path == "raw":
        o, m, l = _flash_forward(jq, jk, jv, jm, False, 1.0, 256, with_stats=True)
        ref = _flash_backward(jq, jk, jv, jm, o, m, l, jg, False, 1.0, 256)
        got = flash_attention_backward_plain(
            *_t(q, k, v, mask, np.asarray(o), np.asarray(m), np.asarray(l), g), False, 1.0, 0,
        )
    else:
        ref = jax.grad(lambda a, b, c: jnp.sum(j_flash(a, b, c, jm, False, 1.0) * jg), argnums=(0, 1, 2))(jq, jk, jv)
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
        out = flash_attention(tq, tk, tv, torch.from_numpy(mask), causal=False, sm_scale=1.0)
        got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("T", [1, 64, 65, 128, 129])
@pytest.mark.parametrize("S", [1, 64, 65, 128, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_route_edges_match_jax_grad(T, S, causal):
    """dq, dk and dv at the lengths where the CUDA backward changes route
    (the fused kernel up to 128 queries and keys, the long route at 129):
    GQA with 3 query heads a kv head, an explicit q_offset one slot before
    right alignment (with T >= S the first query row sees no slot), batch
    row 0 left-padded and batch row 1 wholly masked (its rows average V
    uniformly and give no dq or dk), torch.autograd against jax.grad
    through the reference's custom_vjp, at the file's tolerance."""
    B, H, Hkv, D = 2, 3, 1, 16
    off = S - T - 1
    q, k, v, g, mask = _inputs(B, H, Hkv, T, S, D, None, (S // 3, S), seed=T * 1000 + S)
    jm = jnp.asarray(mask)

    def j_loss(a, b, c):
        return jnp.sum(j_flash(a, b, c, jm, causal, None, 256, off) * jnp.asarray(g))

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(mask), causal=causal, q_offset=off)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("T, S, route", [
    (1, 1, "fused"),
    (64, 64, "fused"),  # GPT-2's train shape
    (65, 32, "fused"),  # T5's cross-attention
    (128, 128, "fused"),
    (128, 16, "fused"),
    (129, 129, "long"),
    (16, 129, "long"),
    (512, 512, "long"),
])
def test_backward_route(T, S, route):
    """The CUDA backward takes the fused kernel while T and S are both at
    most 128, and the long route's pair past that."""
    assert backward_route(T, S) == route
