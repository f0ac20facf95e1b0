"""trlx_tpu_torch's PPO numerics (ops/ppo.py, ops/common.py) against the
goldens captured from the original torch trlx (tests/golden/*.npz, with
test_golden.py's tolerances) and against the JAX package's functions on
random numpy inputs (fp32; atol/rtol 1e-5: the same elementwise math,
reductions summed in another order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import common as jc
from trlx_tpu.ops.ppo import gae_advantages_and_returns as j_gae
from trlx_tpu.ops.ppo import ppo_loss as j_ppo_loss

from trlx_tpu_torch.ops.common import (
    chunked_logprobs,
    logprobs_of_labels,
    running_moments_init,
    running_moments_update,
    whiten,
)
from trlx_tpu_torch.ops.ppo import gae_advantages_and_returns, ppo_loss

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(__file__)), "golden")
TOL = dict(atol=1e-5, rtol=1e-5)
STAT_KEYS = (
    "losses/total_loss", "losses/policy_loss", "losses/value_loss",
    "values/mean", "values/min", "values/max", "values/std", "values/values_error",
    "values/values_mape_error", "values/clipfrac",
    "old_values/mean", "old_values/min", "old_values/max", "old_values/std",
    "returns/mean", "returns/min", "returns/max", "returns/std",
    "policy/approx_kl", "policy/clipfrac", "ratio", "padding_percentage",
)


def _g(name):
    return np.load(os.path.join(GOLDEN, name))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_whiten_matches_golden():
    g = _g("whiten.npz")
    np.testing.assert_allclose(whiten(_t(g["xs"])).numpy(), g["shifted"], **TOL)
    np.testing.assert_allclose(whiten(_t(g["xs"]), shift_mean=False).numpy(), g["unshifted"], **TOL)


def test_logprobs_of_labels_matches_golden():
    g = _g("logprobs.npz")
    got = logprobs_of_labels(_t(g["logits"])[:, :-1], _t(g["labels"])[:, 1:])
    np.testing.assert_allclose(got.numpy(), g["out"], **TOL)


def test_running_moments_match_golden():
    g = _g("running_moments.npz")
    state = running_moments_init()
    for i, batch in enumerate(g["batches"]):
        state, mean, std = running_moments_update(state, _t(batch))
        np.testing.assert_allclose(float(mean), g["batch_means"][i], rtol=1e-5)
        np.testing.assert_allclose(float(std), g["batch_stds"][i], rtol=1e-5)
        np.testing.assert_allclose(float(state.mean), g["running_means"][i], rtol=1e-5)
        np.testing.assert_allclose(float(state.std), g["running_stds"][i], rtol=1e-5)


@pytest.mark.parametrize("whitening", [True, False])
def test_gae_matches_golden(whitening):
    g = _g("ppo.npz")
    adv, ret = gae_advantages_and_returns(
        _t(g["values"]), _t(g["rewards"]), gamma=0.99, lam=0.95, use_whitening=whitening
    )
    suffix = "" if whitening else "_nw"
    np.testing.assert_allclose(adv.numpy(), g["advantages" + suffix], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), g["returns" + suffix], rtol=1e-4, atol=1e-5)


def test_ppo_loss_matches_golden():
    g = _g("ppo.npz")
    loss, stats = ppo_loss(
        _t(g["logprobs"]), _t(g["new_values"]), _t(g["old_logprobs"]), _t(g["values"]),
        _t(g["advantages"]), _t(g["returns"]), _t(g["mask"]),
        cliprange=0.2, cliprange_value=0.2, vf_coef=1.0,
    )
    np.testing.assert_allclose(float(loss), float(g["loss"]), rtol=1e-5)
    for key in STAT_KEYS:
        np.testing.assert_allclose(
            float(stats[key]), float(g["stat_" + key.replace("/", "__")]), rtol=1e-4, atol=1e-6, err_msg=key
        )


def _ppo_inputs(seed, B=5, N=9):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    mask = (rng.random((B, N)) > 0.25).astype(np.float32)
    mask[0] = 0  # an empty row
    return dict(
        logprobs=f(B, N) * 0.3 - 2, values=f(B, N), old_logprobs=f(B, N) * 0.3 - 2,
        old_values=f(B, N), advantages=f(B, N), returns=f(B, N), mask=mask,
        is_weight=(0.8 + 0.4 * rng.random((B, N))).astype(np.float32),
    )


@pytest.mark.parametrize("variant", ["plain", "is_weight", "norm_n"])
def test_ppo_loss_matches_jax(variant):
    x = _ppo_inputs(1)
    kw = dict(cliprange=0.2, cliprange_value=0.3, vf_coef=0.7)
    args = [x[k] for k in ("logprobs", "values", "old_logprobs", "old_values", "advantages", "returns", "mask")]
    extra_j, extra_t = {}, {}
    if variant == "is_weight":
        extra_j["is_weight"], extra_t["is_weight"] = jnp.asarray(x["is_weight"]), _t(x["is_weight"])
    if variant == "norm_n":
        extra_j["norm_n"], extra_t["norm_n"] = jnp.float32(17.0), torch.tensor(17.0)
    j_loss, j_stats = j_ppo_loss(*map(jnp.asarray, args), **kw, **extra_j)
    loss, stats = ppo_loss(*map(_t, args), **kw, **extra_t)
    assert set(stats) == set(j_stats) == set(STAT_KEYS)
    np.testing.assert_allclose(float(loss), float(j_loss), **TOL)
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(stats[key]), float(j_stats[key]), err_msg=key, **TOL)


def test_ppo_loss_gradients_match_jax():
    """d loss / d (logprobs, values): the surrogate's clipping and the
    detached is_weight route gradients identically."""
    import jax

    x = _ppo_inputs(2)
    kw = dict(cliprange=0.2, cliprange_value=0.2, vf_coef=1.0)
    rest = [x[k] for k in ("old_logprobs", "old_values", "advantages", "returns", "mask")]

    def j_fn(lp, v):
        return j_ppo_loss(lp, v, *map(jnp.asarray, rest), **kw, is_weight=jnp.asarray(x["is_weight"]))[0]

    j_glp, j_gv = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(x["logprobs"]), jnp.asarray(x["values"]))
    lp, v = _t(x["logprobs"]).requires_grad_(True), _t(x["values"]).requires_grad_(True)
    loss, _ = ppo_loss(lp, v, *map(_t, rest), **kw, is_weight=_t(x["is_weight"]))
    glp, gv = torch.autograd.grad(loss, (lp, v))
    np.testing.assert_allclose(glp.numpy(), np.asarray(j_glp), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(j_gv), **TOL)


@pytest.mark.parametrize("whitening", [True, False])
def test_gae_matches_jax(whitening):
    rng = np.random.default_rng(3)
    values = rng.normal(size=(4, 11)).astype(np.float32)
    rewards = rng.normal(size=(4, 11)).astype(np.float32)
    j_adv, j_ret = j_gae(jnp.asarray(values), jnp.asarray(rewards), 0.97, 0.9, use_whitening=whitening)
    adv, ret = gae_advantages_and_returns(_t(values), _t(rewards), 0.97, 0.9, use_whitening=whitening)
    assert not adv.requires_grad
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), **TOL)
    np.testing.assert_allclose(ret.numpy(), np.asarray(j_ret), **TOL)


@pytest.mark.parametrize("shift_mean", [True, False])
def test_whiten_matches_jax(shift_mean):
    xs = np.random.default_rng(4).normal(3.0, 2.0, size=(6, 13)).astype(np.float32)
    np.testing.assert_allclose(
        whiten(_t(xs), shift_mean=shift_mean).numpy(),
        np.asarray(jc.whiten(jnp.asarray(xs), shift_mean=shift_mean)), **TOL,
    )


def test_logprobs_of_labels_matches_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 7, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, size=(3, 7))
    np.testing.assert_allclose(
        logprobs_of_labels(_t(logits), _t(labels)).numpy(),
        np.asarray(jc.logprobs_of_labels(jnp.asarray(logits), jnp.asarray(labels))), **TOL,
    )


def test_running_moments_match_jax():
    rng = np.random.default_rng(6)
    j_state, state = jc.running_moments_init(), running_moments_init()
    for n in (8, 3, 16):
        xs = rng.normal(1.0, 2.0, size=(n,)).astype(np.float32)
        j_state, j_mean, j_std = jc.running_moments_update(j_state, jnp.asarray(xs))
        state, mean, std = running_moments_update(state, _t(xs))
        for got, ref in ((mean, j_mean), (std, j_std), (state.mean, j_state.mean),
                         (state.var, j_state.var), (state.std, j_state.std), (state.count, j_state.count)):
            np.testing.assert_allclose(float(got), float(ref), **TOL)


@pytest.mark.parametrize("n_chunks", [1, 3, 4])
def test_chunked_logprobs_match_unchunked(n_chunks):
    """Chunked-from-hidden logprobs (checkpointed per chunk) equal the
    whole-logits path in value and in gradient, also when the chunk size
    does not divide the sequence."""
    rng = np.random.default_rng(7)
    hidden = _t(rng.normal(size=(2, 10, 6)).astype(np.float32)).requires_grad_(True)
    w = _t(rng.normal(size=(6, 30)).astype(np.float32)).requires_grad_(True)
    labels = _t(rng.integers(0, 30, size=(2, 10)))

    def project(h):
        return h @ w

    ref = logprobs_of_labels(project(hidden), labels)
    ref_grads = torch.autograd.grad(ref.sum(), (hidden, w))
    got = chunked_logprobs(project, hidden, labels, n_chunks)
    grads = torch.autograd.grad(got.sum(), (hidden, w))
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), **TOL)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
