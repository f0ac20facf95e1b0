"""trlx_tpu_torch's model against the JAX package on the same weights.

The weights come from the reference's own init (converted with
models/convert.py); inputs from numpy. Both sides run an fp32 config on
the CPU: the reference's Pallas flash kernel in interpret mode, the
port's flash wrapper on its plain version (its CPU path).
Tolerance: atol 1e-4 on logits/values (fp32; the two frameworks sum
matmuls in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.transformer import TransformerLM as JLM
from trlx_tpu.models.wrappers import CausalLMWithValueHead as JPolicy
from trlx_tpu.ops.common import logprobs_of_labels as j_logprobs
from trlx_tpu.ops.common import masked_mean as j_masked_mean

from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead
from trlx_tpu_torch.ops.common import logprobs_of_labels, masked_mean

ATOL = 1e-4
TINY = dict(vocab_size=300, hidden_size=64, n_layer=3, n_head=4, n_positions=128)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, B=3, T=12, vocab=300):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[0, :4] = 0  # left padding
    mask[1, :1] = 0
    return ids, mask


def _policies(impl, kw=TINY, branch_at=None, seed=0):
    jcfg = JConfig(dtype=jnp.float32, attention_impl=impl, **kw)
    branch_at = kw["n_layer"] - 2 if branch_at is None else branch_at
    jmodel = JPolicy(jcfg, branch_at=branch_at)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    cfg = TransformerConfig(dtype=torch.float32, attention_impl=impl, **kw)
    model = CausalLMWithValueHead(cfg, branch_at=branch_at, device="cpu")
    model.load_state_dict(params_from_jax(_np(jparams), cfg))
    return jmodel, jparams, model


def test_converter_round_trip():
    _, jparams, model = _policies("xla")
    sd = model.state_dict()
    base = _np(jparams["base"])
    np.testing.assert_array_equal(sd["base.embed.wte"].numpy(), base["embed"]["wte"])
    np.testing.assert_array_equal(
        sd["base.blocks.2.attn.q.kernel"].numpy(),
        base["blocks"]["attn"]["q"]["kernel"][2].reshape(64, -1),
    )
    np.testing.assert_array_equal(
        sd["base.blocks.1.attn.o.kernel"].numpy(),
        base["blocks"]["attn"]["o"]["kernel"][1].reshape(-1, 64),
    )
    np.testing.assert_array_equal(
        sd["v_head.fc_in.kernel"].numpy(), np.asarray(jparams["v_head"]["fc_in"]["kernel"])
    )
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert n_jax == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lm_logits_and_hidden_match(impl):
    jcfg = JConfig(dtype=jnp.float32, attention_impl=impl, **TINY)
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(3))
    cfg = TransformerConfig(dtype=torch.float32, attention_impl=impl, **TINY)
    lm = TransformerLM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(_np(jparams), cfg))
    ids, mask = _batch(1)
    ref = jlm(jparams, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = lm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        out["hidden_states"].numpy(), np.asarray(ref["hidden_states"]), atol=ATOL, rtol=0
    )


@pytest.mark.parametrize(
    "impl,kw",
    [("xla", TINY), ("pallas", TINY), ("pallas", dict(TINY, n_kv_head=2))],
    ids=["xla", "pallas", "pallas-gqa"],
)
def test_forward_train_matches(impl, kw):
    jmodel, jparams, model = _policies(impl, kw)
    ids, mask = _batch(2)
    ref_params = jmodel.make_ref_params(jparams)
    ref = jmodel.forward_train(jparams, ref_params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = model.forward_train(
            model.make_ref_params(), torch.from_numpy(ids), torch.from_numpy(mask)
        )
    for key in ("logits", "values", "ref_logits"):
        np.testing.assert_allclose(
            out[key].numpy(), np.asarray(ref[key]), atol=ATOL, rtol=0, err_msg=key
        )


def test_logprobs_of_labels_matches():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7))
    ref = np.asarray(j_logprobs(jnp.asarray(logits), jnp.asarray(labels)))
    got = logprobs_of_labels(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dim", [None, 1])
def test_masked_mean_matches(dim):
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(4, 9)).astype(np.float32)
    mask = (rng.random(size=(4, 9)) > 0.4).astype(np.int32)
    mask[2] = 0  # an all-masked row divides by the 1e-8 floor
    ref = np.asarray(j_masked_mean(jnp.asarray(xs), jnp.asarray(mask), axis=dim))
    got = masked_mean(torch.from_numpy(xs), torch.from_numpy(mask), dim=dim)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_graft_entry_tiny_config_matches():
    """The flagship forward of __graft_entry__.entry() on its own tiny
    config: logits, values and ref_logits."""
    import __graft_entry__

    jcfg = __graft_entry__._tiny_transformer()
    fields = ("vocab_size", "hidden_size", "n_layer", "n_head", "n_positions")
    kw = {f: getattr(jcfg, f) for f in fields}
    jmodel, jparams, model = _policies("xla", kw, branch_at=jcfg.n_layer - 2)
    fn, (ids, mask) = __graft_entry__.entry()
    ids = np.random.default_rng(5).integers(0, kw["vocab_size"], size=ids.shape).astype(np.int32)
    mask = mask.copy()
    mask[1, :7] = 0
    ref = jmodel.forward_train(
        jparams, jmodel.make_ref_params(jparams), jnp.asarray(ids), jnp.asarray(mask)
    )
    with torch.no_grad():
        out = model.forward_train(
            model.make_ref_params(), torch.from_numpy(ids), torch.from_numpy(mask)
        )
    for key in ("logits", "values", "ref_logits"):
        np.testing.assert_allclose(
            out[key].numpy(), np.asarray(ref[key]), atol=ATOL, rtol=0, err_msg=key
        )


def test_init_params_distributions():
    """The port's own init (no JAX) follows the reference's distributions."""
    cfg = TransformerConfig(dtype=torch.float32, **dict(TINY, hidden_size=128, vocab_size=2000))
    model = CausalLMWithValueHead(cfg, branch_at=1, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert abs(sd["base.embed.wte"].std().item() - 0.02) < 1e-3
    assert abs(sd["base.embed.wpe"].std().item() - 0.01) < 1e-3
    assert abs(sd["base.blocks.0.attn.o.kernel"].std().item() - 0.02 / np.sqrt(6)) < 1e-3
    assert torch.all(sd["base.blocks.0.ln_1.scale"] == 1)
    assert torch.all(sd["base.blocks.0.mlp.fc_in.bias"] == 0)
    k = sd["v_head.fc_in.kernel"]
    assert k.abs().max().item() <= 1 / np.sqrt(128) and k.min().item() < 0 < k.max().item()
    again = CausalLMWithValueHead(cfg, branch_at=1, device="cpu")
    again.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[n], p) for n, p in again.state_dict().items())
