"""`trlx_tpu_torch.train` against `trlx_tpu.train`: the whole online PPO
loop (evaluate, rollout, experience, ppo_epochs x minibatch steps, the
next rollout) on a tiny fp32 config on the CPU, from the same weights
(the reference trainer's own init, converted), with greedy decoding and a
deterministic reward, for two cycles. The reference runs its per-step
loop (train.fused_inner_loop off: its fused scan disagrees with it on
this tree, ROADMAP queue 3).

Compared: the stored rollouts of the last cycle (tokens and masks
exactly; logprobs, values and rewards atol 1e-4, fp32 after a cycle of
training whose updates differ in the last bits), the per-step loss stream
(rtol 1e-4, atol 1e-5), the adaptive KL controller's value and the eval
rewards."""

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


def _config(tmp_path):
    return j_default_ppo_config().evolve(
        train=dict(batch_size=8, total_steps=8, eval_interval=100, checkpoint_interval=100,
                   seq_length=12, epochs=4, tracker=None, compute_dtype="float32",
                   fused_inner_loop=False, checkpoint_dir=str(tmp_path / "ckpts"), seed=5),
        model=dict(model_path="random", num_layers_unfrozen=1, model_extra_configs={
            "transformer": dict(hidden_size=32, n_layer=2, n_head=2, n_positions=64)
        }),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)),
        method=dict(num_rollouts=16, chunk_size=8, ppo_epochs=2, target=0.01, horizon=100,
                    init_kl_coef=0.05, gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
    )


def test_train_matches_reference(tmp_path, monkeypatch):
    jconfig = _config(tmp_path)
    init, j_stats = {}, []
    setup = JPPOTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    monkeypatch.setattr(JPPOTrainer, "setup_model", capture_setup)
    monkeypatch.setattr(JBaseTrainer, "_tracker_log",
                        lambda self, stats, step: j_stats.append((step, dict(stats))))
    # the checkpoint writes are not under comparison (the port's are
    # ROADMAP queue 4)
    monkeypatch.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
    ref = trlx_tpu.train(reward_fn=reward_fn, prompts=PROMPTS, config=jconfig)

    monkeypatch.setattr(
        wrappers.CausalLMWithValueHead, "init_params",
        lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self,
    )
    ours = trlx_tpu_torch.train(
        reward_fn=reward_fn, prompts=PROMPTS, config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu"
    )
    assert ours.iter_count == ref.iter_count == 8

    j_hist = jax.tree_util.tree_map(np.asarray, ref.store.history)
    hist = ours.store.history
    for name in ("query_tensors", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(getattr(hist, name).numpy(), getattr(j_hist, name), err_msg=name)
    for name in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(getattr(hist, name).numpy(), getattr(j_hist, name),
                                   atol=1e-4, rtol=0, err_msg=name)

    def losses(stream):
        return [(step, s["losses/total_loss"]) for step, s in stream if "losses/total_loss" in s]

    want, got = losses(j_stats), losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in got], [float(v) for _, v in want], rtol=1e-4, atol=1e-5)
    assert ours.kl_ctl.value == pytest.approx(ref.kl_ctl.value, rel=1e-5)
    assert ours.kl_ctl.value != jconfig.method.init_kl_coef  # the controller moved

    def evals(stream):
        return [float(s["reward/mean"]) for _, s in stream if "reward/mean" in s]

    assert len(evals(ours.stats_history)) == 2  # before the first cycle and at the end
    np.testing.assert_allclose(evals(ours.stats_history), evals(j_stats), rtol=1e-6)


def test_train_through_engine_matches_reference(tmp_path, monkeypatch):
    """The same loop with rollouts through the decode engine (4 slots, 8-token
    pages, speculative decoding with k = 2 off the hydra reference, whose
    trunk KV the pool shares), against the reference's engine. The
    reference must really run its engine: its rollout stats carry the
    engine ledger."""
    jconfig = _config(tmp_path).evolve(method=dict(gen_engine=dict(
        enabled=True, slots=4, page_size=8, spec_decode=True, draft_k=2)))
    init, j_stats = {}, []
    setup = JPPOTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    monkeypatch.setattr(JPPOTrainer, "setup_model", capture_setup)
    monkeypatch.setattr(JBaseTrainer, "_tracker_log",
                        lambda self, stats, step: j_stats.append((step, dict(stats))))
    monkeypatch.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
    ref = trlx_tpu.train(reward_fn=reward_fn, prompts=PROMPTS, config=jconfig)
    engine_keys = ("rollout/engine_refills", "rollout/engine_decode_steps", "rollout/engine_occupancy",
                   "rollout/engine_reclaimed_pages", "rollout/spec_accept_rate")
    j_rollouts = [s for _, s in j_stats if "rollout/engine_refills" in s]
    assert j_rollouts, "the reference fell back to its static sampler"

    monkeypatch.setattr(
        wrappers.CausalLMWithValueHead, "init_params",
        lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self,
    )
    ours = trlx_tpu_torch.train(
        reward_fn=reward_fn, prompts=PROMPTS, config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu"
    )
    assert ours.iter_count == ref.iter_count == 8
    j_hist = jax.tree_util.tree_map(np.asarray, ref.store.history)
    hist = ours.store.history
    for name in ("query_tensors", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(getattr(hist, name).numpy(), getattr(j_hist, name), err_msg=name)
    for name in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(getattr(hist, name).numpy(), getattr(j_hist, name),
                                   atol=1e-4, rtol=0, err_msg=name)
    rollouts = [s for _, s in ours.stats_history if "rollout/engine_refills" in s]
    assert len(rollouts) == len(j_rollouts)
    for got, want in zip(rollouts, j_rollouts):
        for key in engine_keys:
            assert got[key] == pytest.approx(float(want[key]), rel=1e-6), key


def _seq2seq_config(tmp_path, num_layers_unfrozen):
    """The tiny T5 of the reference's seq2seq PPO test (tests/test_trainers.py)
    in the causal case's loop: two cycles of 16 rollouts, greedy."""
    return _config(tmp_path).evolve(
        model=dict(model_path="random", model_arch_type="seq2seq", num_layers_unfrozen=num_layers_unfrozen,
                   model_extra_configs={"seq2seq": dict(
                       d_model=16, n_layer=2, n_head=2, d_kv=8, d_ff=32, relative_attention_num_buckets=8)}),
    )


@pytest.mark.parametrize("num_layers_unfrozen", [1, -1])
def test_seq2seq_train_matches_reference(tmp_path, monkeypatch, num_layers_unfrozen):
    """seq2seq PPO (`model_arch_type="seq2seq"`) through `train()` against
    the reference's, from the same T5 weights: the hydra branch over the
    top decoder block (k = 1) and the full frozen copy (k = -1). Also the
    freeze set against the reference's `make_seq2seq_freeze_mask`."""
    jconfig = _seq2seq_config(tmp_path, num_layers_unfrozen)
    init, j_stats = {}, []
    setup = JPPOTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    monkeypatch.setattr(JPPOTrainer, "setup_model", capture_setup)
    monkeypatch.setattr(JBaseTrainer, "_tracker_log",
                        lambda self, stats, step: j_stats.append((step, dict(stats))))
    monkeypatch.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
    ref = trlx_tpu.train(reward_fn=reward_fn, prompts=PROMPTS, config=jconfig)

    monkeypatch.setattr(
        wrappers.Seq2SeqLMWithValueHead, "init_params",
        lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self,
    )
    ours = trlx_tpu_torch.train(
        reward_fn=reward_fn, prompts=PROMPTS, config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu"
    )
    assert ours.iter_count == ref.iter_count == 8
    assert (ours.model.branch_at is None) == (num_layers_unfrozen == -1)

    j_hist = jax.tree_util.tree_map(np.asarray, ref.store.history)
    hist = ours.store.history
    assert hist.response_tensors.shape[1] == 5  # the decoder start token + 4 new tokens
    for name in ("query_tensors", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(getattr(hist, name).numpy(), getattr(j_hist, name), err_msg=name)
    for name in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(getattr(hist, name).numpy(), getattr(j_hist, name),
                                   atol=1e-4, rtol=0, err_msg=name)

    def losses(stream):
        return [(step, s["losses/total_loss"]) for step, s in stream if "losses/total_loss" in s]

    want, got = losses(j_stats), losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in got], [float(v) for _, v in want], rtol=1e-4, atol=1e-5)

    mask = ref.make_seq2seq_freeze_mask(ref.params)
    if mask is None:
        frozen_ref = set()
    else:
        full = jax.tree_util.tree_map(lambda m, p: np.broadcast_to(m, np.shape(p)), mask, init)
        frozen_ref = {n for n, m in params_from_jax(full, ours.model.cfg).items() if not m.any()}
    frozen = {n for n, p in ours.model.named_parameters() if not p.requires_grad}
    assert frozen == frozen_ref
    assert bool(frozen) == (num_layers_unfrozen == 1)
    if frozen:
        assert {"base.encoder.rel_bias", "base.decoder.rel_bias", "base.shared.wte"} <= frozen
