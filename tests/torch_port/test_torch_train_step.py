"""trlx_tpu_torch's PPO train step against the JAX package's, from the same
weights (the reference trainer's own init, converted) and one shared
rollout store, on a tiny fp32 config on the CPU:

- `loss()` and its gradients against `jax.value_and_grad(trainer.loss)`;
- one inner epoch of optimizer steps against the reference's per-step
  `make_train_step` loop over the same loader order: the loss of every
  step, then every parameter.

Both freeze modes: num_layers_unfrozen=2 (the hydra reference branch; the
embeddings and the bottom block do not train and must stay bit-identical)
and -1 (everything trains, a full frozen reference copy).

Tolerances (fp32, sums in another order): loss and stats rtol 1e-5 /
atol 1e-6; gradients atol 1e-5 + rtol 1e-4. Parameters after the epoch:
AdamW moves an element by ~lr a step whatever its gradient's size, so an
element whose gradient is at the level of rounding noise can step either
way in either framework. Every element is held to that bound (4 steps x
lr), and all but one in a thousand of each tensor to atol 2e-6 at lr 1e-4,
a fiftieth of one step. The key projection's bias is held to the bound
alone: its gradient is zero in exact arithmetic (it shifts every score of
a query row by the same amount), so all of it steps on noise."""

import jax
import numpy as np
import pytest
import torch

from trlx_tpu.data import PPORolloutBatch as JBatch
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.utils.loading import get_trainer as j_get_trainer

from trlx_tpu_torch.data import PPORolloutBatch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import wrappers
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.utils.loading import get_trainer

ROWS, P, N, BATCH = 16, 6, 5, 8
LR = 1e-4


def _config(tmp_path, k, impl):
    return j_default_ppo_config().evolve(
        train=dict(batch_size=BATCH, total_steps=100, eval_interval=100, checkpoint_interval=100,
                   seq_length=P + N, epochs=1, tracker=None, compute_dtype="float32",
                   checkpoint_dir=str(tmp_path / "ckpts"), seed=21),
        model=dict(model_path="random", num_layers_unfrozen=k, model_extra_configs={
            "transformer": dict(hidden_size=64, n_layer=3, n_head=4, n_positions=64, attention_impl=impl)
        }),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=LR, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-2)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=40, eta_min=1e-5)),
        method=dict(num_rollouts=ROWS, chunk_size=8, ppo_epochs=1,
                    gen_kwargs=dict(max_new_tokens=N, do_sample=False)),
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trainers(tmp_path, k, impl, monkeypatch):
    """The reference trainer and the port's, on the reference's weights."""
    jconfig = _config(tmp_path, k, impl)
    ref = j_get_trainer(jconfig.train.trainer)(config=jconfig, reward_fn=lambda **kw: [0.0])
    config = TRLConfig.from_dict(jconfig.to_dict())
    init = _np(ref.params)
    monkeypatch.setattr(
        wrappers.CausalLMWithValueHead, "init_params",
        lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self,
    )
    ours = get_trainer(config.train.trainer)(config=config, reward_fn=lambda **kw: [0.0], device="cpu")
    return ref, ours


def _rollouts(seed=0):
    rng = np.random.default_rng(seed)
    query = rng.integers(0, 256, size=(ROWS, P)).astype(np.int32)
    query[:4, :2] = 257  # left padding (pad = eos = 257)
    response = rng.integers(0, 256, size=(ROWS, N)).astype(np.int32)
    lengths = rng.integers(1, N + 1, size=ROWS)
    mask = (np.arange(N)[None, :] < lengths[:, None]).astype(np.float32)
    response = np.where(mask > 0, response, 257).astype(np.int32)
    return dict(
        query_tensors=query, response_tensors=response,
        logprobs=(rng.normal(size=(ROWS, N)) * 0.2 - 5.5).astype(np.float32) * mask,
        values=rng.normal(size=(ROWS, N)).astype(np.float32) * mask,
        rewards=rng.normal(size=(ROWS, N)).astype(np.float32) * mask,
        response_mask=mask,
    )


def _torch_batch(rows):
    return PPORolloutBatch(**{k: torch.from_numpy(np.array(v)) for k, v in rows.items()})


CASES = [(2, "pallas"), (-1, "xla")]


@pytest.mark.parametrize("k,impl", CASES, ids=["hydra-pallas", "all-xla"])
def test_loss_and_grads_match_jax(tmp_path, monkeypatch, k, impl):
    ref, ours = _trainers(tmp_path, k, impl, monkeypatch)
    rows = _rollouts()
    device_batch = ref.place_batch(JBatch(**rows))
    with ref.mesh:
        (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(ref.params, device_batch)
    loss, stats = ours.loss(_torch_batch(rows))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5, atol=1e-6)
    assert set(stats) == set(j_stats)
    for key in stats:
        np.testing.assert_allclose(stats[key].item(), float(j_stats[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    want = params_from_jax(_np(j_grads), ours.model.cfg)
    trained = {n: p for n, p in ours.model.named_parameters() if p.requires_grad}
    assert trained and all(p.grad is not None for p in trained.values())
    for name, p in trained.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
    frozen = {n for n, p in ours.model.named_parameters() if not p.requires_grad}
    if k == 2:  # embeddings and block 0 (below branch_at = 1) do not train
        assert frozen == {n for n in trained.keys() | frozen
                          if n.startswith(("base.embed.", "base.blocks.0."))}
    else:
        assert not frozen


@pytest.mark.parametrize("k,impl", CASES, ids=["hydra-pallas", "all-xla"])
def test_inner_epoch_matches_jax_per_step_loop(tmp_path, monkeypatch, k, impl):
    ref, ours = _trainers(tmp_path, k, impl, monkeypatch)
    start = {n: p.detach().clone() for n, p in ours.model.named_parameters()}
    rows = _rollouts(seed=1)
    ref.store.push(JBatch(**rows))
    ours.store.push(_torch_batch(rows))
    seed = ours.config.train.seed
    step = ref.make_train_step()
    j_losses, losses = [], []
    it = 0
    for _ in range(2):  # two inner epochs of two steps, a fresh loader each
        j_loader = ref.store.create_loader(BATCH, shuffle=True, drop_last=True, seed=seed + it)
        loader = ours.store.create_loader(BATCH, shuffle=True, drop_last=True, seed=seed + it)
        for j_batch, batch in zip(j_loader, loader):
            np.testing.assert_array_equal(batch.query_tensors.numpy(), np.asarray(j_batch.query_tensors))
            with ref.mesh:
                ref.params, ref.opt_state, j_loss, _ = step(ref.params, ref.opt_state, ref.place_batch(j_batch))
            j_losses.append(float(j_loss))
            losses.append(ours.train_step(batch)[0])
            it += 1
    assert it == 4
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5, atol=1e-6)
    assert [float(ours.schedule(i)) for i in range(4)] == pytest.approx(
        [float(ref.schedule(i)) for i in range(4)], rel=1e-6
    )
    want = params_from_jax(_np(ref.params), ours.model.cfg)
    for name, p in ours.model.named_parameters():
        if p.requires_grad:
            assert not torch.equal(p.detach(), start[name]), f"{name} did not move"
            diff = (p.detach() - want[name]).abs()
            assert diff.max().item() <= 4 * LR, name
            if not name.endswith("attn.k.bias"):
                assert (diff > 2e-6).float().mean().item() <= 1e-3, name
        else:  # frozen: bit-identical to the start, as the reference's masked update leaves it
            assert torch.equal(p.detach(), start[name]), name
            np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy())
