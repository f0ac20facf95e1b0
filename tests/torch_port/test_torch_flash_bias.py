"""The bias-carrying fused attention of trlx_tpu_torch (T5's relative
position bias) on the CPU, where its plain versions run behind the
autograd Function, against the JAX package's `flash_attention_bias`
(Pallas in interpret mode) and its XLA math.

fp32 inputs from numpy. Tolerances: the forward within atol 5e-5 and the
gradients (dq, dk, dv and the batch-summed dbias) within 1e-4: sums over
up to S terms of O(1) products taken in another order by each framework
(the Pallas kernels sum chunk by chunk, dbias batch by batch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.flash_attention import NEG_INF as J_NEG_INF
from trlx_tpu.ops.flash_attention import _flash_bias_backward, _flash_bias_forward
from trlx_tpu.ops.flash_attention import flash_attention_bias as j_flash_bias

from trlx_tpu_torch.ops import _build
from trlx_tpu_torch.ops import flash_attention as fa
from trlx_tpu_torch.ops.flash_attention import (
    FUSED_BIAS_BWD_MAX_LEN,
    SHORT_BIAS_FWD_MAX_LEN,
    bias_backward_route,
    bias_forward_route,
    flash_attention_bias,
    flash_attention_bias_backward_plain,
    flash_attention_bias_plain,
)
from trlx_tpu_torch.tools import bwd_stages

FWD_TOL = dict(atol=5e-5, rtol=0)
GRAD_TOL = dict(atol=1e-4, rtol=0)


def _inputs(B, H, T, S, D, seed, fully_masked_row=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, H, S, D)).astype(np.float32)
    v = rng.normal(size=(B, H, S, D)).astype(np.float32)
    bias = rng.normal(size=(H, T, S)).astype(np.float32)
    g = rng.normal(size=(B, H, T, D)).astype(np.float32)
    mask = (rng.random((B, S)) > 0.2).astype(np.int32)
    mask[:, :4] = 1
    if fully_masked_row:
        mask[-1] = 0
    return q, k, v, bias, g, mask


def _xla_reference(q, k, v, mask, bias, causal):
    """The reference's XLA math (f32 scores, top-left causality)."""
    T, S = q.shape[2], k.shape[2]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) + bias[None]
    if causal:
        s = jnp.where(jnp.arange(T)[:, None] >= jnp.arange(S)[None, :], s, J_NEG_INF)
    s = jnp.where(mask[:, None, None, :] > 0, s, J_NEG_INF)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


def _grads(fn_j, fn_t, q, k, v, bias, g):
    """(jax grads, torch grads) of sum(out * g) in q, k, v and the bias."""
    ref = jax.grad(lambda *a: jnp.sum(fn_j(*a) * jnp.asarray(g)), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))
    tq, tk, tv, tb = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias))
    out = fn_t(tq, tk, tv, tb)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv, tb))
    return out, ref, got


@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_autograd_match_jax_pallas(causal):
    """Values and all four gradients against jax.grad through the
    reference's custom_vjp (interpret-mode Pallas), at the reference test's
    shape B2 H3 T=S=128 D16."""
    q, k, v, bias, g, mask = _inputs(2, 3, 128, 128, 16, seed=0)
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    out, ref, got = _grads(
        lambda a, b, c, d: j_flash_bias(a, b, c, jmask, d, causal=causal),
        lambda a, b, c, d: flash_attention_bias(a, b, c, tmask, d, causal=causal),
        q, k, v, bias, g,
    )
    j_out = j_flash_bias(*map(jnp.asarray, (q, k, v)), jmask, jnp.asarray(bias), causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_stats_and_plain_backward_match_jax(causal):
    """m and l against `_flash_bias_forward(with_stats=True)`, and the plain
    backward against `_flash_bias_backward` on the same residuals; the
    last batch row has every key masked (a uniform average over all S)."""
    q, k, v, bias, g, mask = _inputs(2, 3, 128, 128, 16, seed=1, fully_masked_row=True)
    jq, jk, jv, jb, jg, jm = map(jnp.asarray, (q, k, v, bias, g, mask))
    o, m, l = _flash_bias_forward(jq, jk, jv, jm, jb, causal, 1.0, 128, with_stats=True)
    out, tm, tl = flash_attention_bias(*map(torch.from_numpy, (q, k, v, mask, bias)), causal=causal,
                                       with_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(o), **FWD_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(l), rtol=1e-5, atol=1e-5)
    ref = _flash_bias_backward(jq, jk, jv, jm, jb, o, m, l, jg, causal, 1.0, 128)
    got = flash_attention_bias_backward_plain(
        *map(torch.from_numpy, (q, k, v, mask, bias, np.array(o), np.array(m), np.array(l), g)),
        causal, 1.0,
    )
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_matches_jax_xla_math(causal):
    """A ragged T = S = 40 (no multiple of the kernels' tiles) with a
    scale: the forward and all four gradients against jax.grad through the
    reference's XLA math."""
    q, k, v, bias, g, mask = _inputs(3, 2, 40, 40, 8, seed=2)
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    scale = 0.5
    out, ref, got = _grads(
        lambda a, b, c, d: _xla_reference(a * scale, b, c, jmask, d, causal),
        lambda a, b, c, d: flash_attention_bias(a, b, c, tmask, d, causal=causal, sm_scale=scale),
        q, k, v, bias, g,
    )
    j_out = _xla_reference(jnp.asarray(q) * scale, jnp.asarray(k), jnp.asarray(v), jmask,
                           jnp.asarray(bias), causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


def test_grad_flows_through_the_function_only_when_required():
    """Without grad the forward is the plain path; a bias that requires grad
    alone is enough to route through the autograd Function."""
    q, k, v, bias, _, mask = _inputs(1, 2, 8, 8, 8, seed=3)
    tq, tk, tv, tb, tm = map(torch.from_numpy, (q, k, v, bias, mask))
    assert flash_attention_bias(tq, tk, tv, tm, tb).grad_fn is None
    out = flash_attention_bias(tq, tk, tv, tm, tb.requires_grad_(True))
    assert type(out.grad_fn).__name__ == "_FlashBiasAttentionFnBackward"


def test_gqa_is_refused():
    q = torch.zeros(1, 4, 8, 8)
    kv = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention_bias(q, kv, kv, None, torch.zeros(4, 8, 8))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 16, 65, FUSED_BIAS_BWD_MAX_LEN, FUSED_BIAS_BWD_MAX_LEN + 1])
def test_route_edges_match_jax_pallas(T, causal):
    """Values and all four gradients at the lengths where the CUDA backward
    changes route (the fused kernel up to 128, the long route at 129),
    with the last batch row wholly masked (its rows average V uniformly and
    give no dq, dk or dbias), against jax.grad through the reference's
    custom_vjp. Interpret-mode Pallas takes each of these shapes (its
    blocks shrink to a divisor of T)."""
    q, k, v, bias, g, mask = _inputs(2, 3, T, T, 16, seed=10 + T, fully_masked_row=True)
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    out, ref, got = _grads(
        lambda a, b, c, d: j_flash_bias(a, b, c, jmask, d, causal=causal),
        lambda a, b, c, d: flash_attention_bias(a, b, c, tmask, d, causal=causal),
        q, k, v, bias, g,
    )
    j_out = j_flash_bias(*map(jnp.asarray, (q, k, v)), jmask, jnp.asarray(bias), causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("T, S, causal, route", [
    (1, 1, True, "fused"),
    (32, 32, False, "fused"),  # T5's encoder
    (65, 65, True, "fused"),  # T5's decoder
    (128, 128, True, "fused"),
    (128, 16, False, "fused"),
    (129, 129, True, "long"),
    (16, 129, False, "long"),
    (512, 512, False, "long"),
])
def test_bias_backward_route(T, S, causal, route):
    """The CUDA bias backward takes the fused kernel while T and S are both
    at most 128, and the long route past that."""
    assert bias_backward_route(T, S, causal) == route


def test_bias_backward_route_refuses_causal_t_ne_s():
    """Neither CUDA route takes a causal call with T != S (the bias kernels'
    causal rule is top-left)."""
    with pytest.raises(ValueError, match="T == S"):
        bias_backward_route(20, 40, True)
    with pytest.raises(ValueError, match="T == S"):
        bias_backward_route(200, 100, True)


@pytest.mark.parametrize("T, S, route", [
    (1, 1, "short"),
    (32, 32, "short"),  # T5's encoder
    (65, 65, "short"),  # T5's decoder
    (SHORT_BIAS_FWD_MAX_LEN, SHORT_BIAS_FWD_MAX_LEN, "short"),
    (SHORT_BIAS_FWD_MAX_LEN + 1, SHORT_BIAS_FWD_MAX_LEN + 1, "long"),
    (128, 16, "short"),
    (16, 128, "short"),
    (100, 127, "short"),
    (128, 129, "long"),
    (129, 1, "long"),
    (1, 129, "long"),
])
def test_bias_forward_route(T, S, route):
    """The CUDA bias forward takes the short kernel (one CTA per batch row
    and head) while T and S are both at most 128, and the long route past
    that."""
    assert bias_forward_route(T, S) == route


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("requires_grad", [False, True])
def test_cpu_path_is_the_plain_version_and_launches_no_kernel(causal, requires_grad):
    """On CPU tensors the bias forward is `flash_attention_bias_plain`, bit
    for bit, with and without the autograd Function, and no launch counter
    of kernel 4 moves."""
    q, k, v, bias, _, mask = _inputs(2, 3, 65, 65, 16, seed=20, fully_masked_row=True)
    tq, tk, tv, tb, tm = map(torch.from_numpy, (q, k, v, bias, mask))
    counters = (fa.flash_attention_bias, fa.flash_attention_bias_fwd_short, fa.flash_attention_bias_fwd_long)
    before = [fn.launches for fn in counters]
    for fn in counters:
        fn.launches = 0
    try:
        out, m, l = flash_attention_bias(tq, tk, tv, tm, tb.requires_grad_(requires_grad), causal=causal,
                                         with_stats=True)
        assert [fn.launches for fn in counters] == [0, 0, 0]
    finally:
        for fn, n in zip(counters, before):
            fn.launches = n
    ref = flash_attention_bias_plain(tq, tk, tv, tm, tb.detach(), causal, 1.0, with_stats=True)
    for got, want in zip((out, m, l), ref):
        assert torch.equal(got.detach(), want)


BIAS_FWD_STAGES = bwd_stages.KERNELS["bias_fwd"]


@pytest.mark.parametrize("marker", [anchor for _, anchor, *_ in BIAS_FWD_STAGES["stages"]]
                         + [old for patches in BIAS_FWD_STAGES["extra"].values() for old, _ in patches]
                         + [BIAS_FWD_STAGES["bounds"]])
def test_bias_fwd_stage_markers_appear_once(marker):
    """Each text the `bias_fwd` stage cut (`tools/bwd_stages.py`) cuts at or
    patches appears exactly once in `csrc/flash_bias_fwd.cu`, so no cut can
    silently cut nothing or cut twice."""
    assert (_build.CSRC / "flash_bias_fwd.cu").read_text().count(marker) == 1


@pytest.mark.parametrize("kind", sorted(bwd_stages.KERNELS))
def test_stage_tool_builds_every_variant_source(kind):
    """`variants` makes every cut, extra and unbounded variant of each
    kernel the stage tool knows from the current source (it raises on an
    anchor that is not found exactly once), and each cut differs from the
    whole kernel."""
    kernel = bwd_stages.KERNELS[kind]
    src = (_build.CSRC / kernel["source"]).read_text()
    out = bwd_stages.variants(src, kernel)
    names = [name for name, *_ in kernel["stages"]] + list(kernel["extra"]) + ["whole"]
    if kernel["bounds"] is not None:
        names.append("whole_unbounded_registers")
    assert sorted(out) == sorted(names)
    assert out["whole"] == src
    assert all(out[name] != src for name in out if name != "whole")
