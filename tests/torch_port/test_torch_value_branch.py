"""The value branch (`method.num_value_layers_unfrozen`) against the JAX
package, on the CPU in fp32 from the same weights:

- module level: `CausalLMWithValueHead(cfg, branch_at=2,
  value_branch_at=1)`'s `forward` values, and `forward_train`'s values,
  logits and reference logits, to 1e-5; the gradients of a value loss in
  `v_branch`, `v_head` and the trunk below the fork, to 1e-5;
- trainer level: `train()` with num_value_layers_unfrozen=1 at
  num_layers_unfrozen 1 (both forks at layer 1) and -1 (a full frozen
  reference) against `trlx_tpu.train` (its per-step loop): the last
  cycle's store, the loss stream, and `v_branch` trainable at both;
- reload: `save_pretrained` -> `model_path=dir` restores the trained
  `v_branch` bit for bit over the fresh copy of the base weights."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.wrappers import CausalLMWithValueHead as JPolicy

import trlx_tpu_torch
from tests.torch_port import ppo_parity
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.transformer import TransformerConfig
from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead
from trlx_tpu_torch.utils.loading import get_trainer

TINY = dict(vocab_size=32, hidden_size=16, n_layer=3, n_head=2, n_positions=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jmodel = JPolicy(JConfig(dtype=jnp.float32, **TINY), branch_at=2, value_branch_at=1)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    model = CausalLMWithValueHead(cfg, branch_at=2, value_branch_at=1, device="cpu")
    model.load_state_dict(params_from_jax(_np(jparams), cfg))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 32, size=(2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[0, :3] = 0  # left padding
    return jmodel, jparams, model, ids, mask


def test_value_branch_params_are_a_copy_of_the_top_blocks(models):
    _, jparams, model, _, _ = models
    assert len(model.v_branch.blocks) == 2
    assert set(model.state_dict()) == set(params_from_jax(_np(jparams), model.cfg))
    fresh = CausalLMWithValueHead(model.cfg, value_branch_at=1, device="cpu").init_params(torch.Generator().manual_seed(0))
    for i, block in enumerate(fresh.v_branch.blocks):
        for (n, p), q in zip(block.named_parameters(), fresh.base.blocks[1 + i].parameters()):
            assert torch.equal(p, q), n
            assert p.data_ptr() != q.data_ptr()  # a copy, not the trunk's storage
    assert torch.equal(fresh.v_branch.ln_f.scale, fresh.base.ln_f.scale)


def test_value_branch_forward_matches_reference(models):
    jmodel, jparams, model, ids, mask = models
    want = jmodel.forward(jparams, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.as_tensor(ids).long(), torch.as_tensor(mask))
    np.testing.assert_allclose(got["values"].numpy(), np.asarray(want["values"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-5, rtol=0)

    jref = jmodel.make_ref_params(jparams)
    want = jmodel.forward_train(jparams, jref, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model.forward_train(model.make_ref_params(), torch.as_tensor(ids).long(), torch.as_tensor(mask))
    for key in ("values", "logits", "ref_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0, err_msg=key)
    # the values read the branch, the logits the trunk: moving the
    # branch's final norm moves the values alone
    moved = copy.deepcopy(model)
    with torch.no_grad():
        moved.v_branch.ln_f.bias += 0.5
        out = moved.forward_train(moved.make_ref_params(), torch.as_tensor(ids).long(), torch.as_tensor(mask))
    assert torch.equal(out["logits"], got["logits"]) and torch.equal(out["ref_logits"], got["ref_logits"])
    assert not torch.allclose(out["values"], got["values"])


def test_value_branch_gradients_match_reference(models):
    jmodel, jparams, model, ids, mask = models

    def jloss(p):
        return (jmodel.forward(p, jnp.asarray(ids), jnp.asarray(mask))["values"] ** 2).mean()

    jgrads = params_from_jax(_np(jax.grad(jloss)(jparams)), model.cfg)
    model.zero_grad(set_to_none=True)
    (model(torch.as_tensor(ids).long(), torch.as_tensor(mask))["values"] ** 2).mean().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    branch = [n for n in grads if n.startswith(("v_branch.", "v_head."))]
    assert len(branch) == 2 * 16 + 2 + 4
    # the trunk below the fork gets the value loss too (the capture is not
    # detached); the policy's own top block and final norm get none
    below = [n for n in grads if n.startswith(("base.blocks.0.", "base.embed."))]
    for n in branch + below:
        np.testing.assert_allclose(grads[n].numpy(), jgrads[n], atol=1e-5, rtol=0, err_msg=n)
    assert float(grads["v_branch.blocks.0.attn.q.kernel"].abs().sum()) > 0
    assert grads["base.ln_f.scale"] is None or not grads["base.ln_f.scale"].any()


@pytest.fixture(scope="module", params=[1, -1], ids=["hydra_k1", "full_copy"])
def trained(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"vb{request.param}")
    jconfig = ppo_parity.config(tmp, model=dict(num_layers_unfrozen=request.param),
                                method=dict(num_value_layers_unfrozen=1))
    ref, init, j_stats = ppo_parity.run_reference(jconfig)
    ours = ppo_parity.run_port(jconfig, init)
    return request.param, jconfig, ref, j_stats, ours


def test_value_branch_train_matches_reference(trained):
    k, _, ref, j_stats, ours = trained
    assert ours.iter_count == ref.iter_count == 8
    assert ours.model.value_branch_at == ref.model.value_branch_at == 1
    assert (ours.model.branch_at is None) == (k == -1)
    ppo_parity.assert_store_matches(ours, ref)
    want, got = ppo_parity.losses(j_stats), ppo_parity.losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-5)
    trainable = {n for n, p in ours.model.named_parameters() if p.requires_grad}
    assert {n for n, _ in ours.model.v_branch.named_parameters(prefix="v_branch")} <= trainable
    # the trained branch against the reference's
    j_branch = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params), ours.model.cfg)
    for n, p in ours.model.v_branch.named_parameters(prefix="v_branch"):
        np.testing.assert_allclose(p.detach().numpy(), j_branch[n], atol=1e-4, rtol=0, err_msg=n)


def test_value_branch_reload_restores_the_saved_branch(tmp_path):
    config = TRLConfig.from_dict(ppo_parity.config(tmp_path, method=dict(num_value_layers_unfrozen=1)).to_dict())
    ours = trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, config=config,
                                device="cpu")
    ours.save_pretrained(str(tmp_path / "saved"))
    config = config.evolve(model=dict(model_path=str(tmp_path / "saved")))
    reloaded = get_trainer(config.train.trainer)(config=config, reward_fn=ppo_parity.reward_fn, device="cpu")
    saved = ours.model.state_dict()
    branch = {n: p for n, p in reloaded.model.state_dict().items() if n.startswith("v_branch.")}
    assert len(branch) == 16 + 2
    for n, p in branch.items():
        assert torch.equal(p, saved[n]), n
    # the trained branch moved away from the top block it was copied from,
    # which the reload copied afresh before the saved branch went over it
    assert not torch.equal(branch["v_branch.blocks.0.attn.q.kernel"], saved["base.blocks.1.attn.q.kernel"])
