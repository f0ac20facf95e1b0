"""Shared harness of the PPO `train()` parity tests: the tiny fp32
config of `test_torch_trainer.py`, a reference run that captures its
init and its logged stats, a port run from the same (converted) init,
and the comparisons at the slice's tolerances (tokens, masks and
cursors exactly; stored logprobs, values and rewards atol 1e-4; the
loss stream rtol 1e-4)."""

import jax
import numpy as np
import pytest

import trlx_tpu
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.trainer.ppo import TPUPPOTrainer as JPPOTrainer

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import wrappers
from trlx_tpu_torch.models.convert import params_from_jax

PROMPTS = ["hello world", "the cat", "a b", "xyz", "what is", "I am", "go", "ok",
           "one", "two three", "four", "five six seven", "eight", "nine", "ten", "eleven"]


def reward_fn(samples, prompts, outputs, **kw):
    return [0.25 * len(set(o)) - 0.05 * len(o) for o in outputs]


def config(tmp_path, fused_inner_loop=False, **sections):
    """Two cycles of 16 greedy rollouts, 4 steps each (2 epochs x 2
    minibatches of 8), on a 2-layer GPT-2 of width 32; `sections` evolve
    it further."""
    base = j_default_ppo_config().evolve(
        train=dict(batch_size=8, total_steps=8, eval_interval=100, checkpoint_interval=100,
                   seq_length=12, epochs=4, tracker=None, compute_dtype="float32",
                   fused_inner_loop=fused_inner_loop, checkpoint_dir=str(tmp_path / "ckpts"), seed=5),
        model=dict(model_path="random", num_layers_unfrozen=1, model_extra_configs={
            "transformer": dict(hidden_size=32, n_layer=2, n_head=2, n_positions=64)
        }),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)),
        method=dict(num_rollouts=16, chunk_size=8, ppo_epochs=2, target=0.01, horizon=100,
                    init_kl_coef=0.05, gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
    )
    return base.evolve(**sections) if sections else base


def run_reference(jconfig, **train_kw):
    """`trlx_tpu.train` on `jconfig`: (trainer, its init as numpy, its
    logged stats as (step, dict))."""
    init, stats = {}, []
    setup = JPPOTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPPOTrainer, "setup_model", capture_setup)
        mp.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: stats.append((step, dict(st))))
        # the checkpoint writes are not under comparison here
        # (test_torch_resume.py compares them)
        mp.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
        ref = trlx_tpu.train(reward_fn=reward_fn, prompts=PROMPTS, config=jconfig, **train_kw)
    return ref, init, stats


def run_port(jconfig, init, **train_kw):
    """`trlx_tpu_torch.train` on the same config from the reference's
    init, on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wrappers.CausalLMWithValueHead, "init_params",
                   lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self)
        return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS,
                                    config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu", **train_kw)


def assert_store_matches(ours, ref):
    """The last cycle's stored rollouts: tokens and masks exactly,
    logprobs, values and rewards to atol 1e-4."""
    j_hist = jax.tree_util.tree_map(np.asarray, ref.store.history)
    hist = ours.store.history
    for name in ("query_tensors", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(getattr(hist, name).numpy(), getattr(j_hist, name), err_msg=name)
    for name in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(getattr(hist, name).numpy(), getattr(j_hist, name),
                                   atol=1e-4, rtol=0, err_msg=name)


def losses(stream):
    """(step, total loss) of every logged train record."""
    return [(step, float(s["losses/total_loss"])) for step, s in stream if "losses/total_loss" in s]
