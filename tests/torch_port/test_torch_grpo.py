"""trlx_tpu_torch's GRPO against the JAX package's, on the CPU (2 layers,
width 32, the byte tokenizer, fp32):

- `group_relative_advantages` on the reference's goldens and on several
  random groups (1e-6), degenerate groups exactly 0, partial groups raise;
- `grpo_loss` with `is_weight` and `norm_n` each None or given: the loss
  and every stat to rtol 1e-5, the gradient against `jax.grad` to 1e-5;
  zero at identity and the clip bound;
- the configs: the same validation errors, the same default config;
- the rollout store with GRPO batches (push over two chunks, gathers,
  `export_history`) and with PPO batches as before;
- the prompt tiling and cursor, and `_score_and_assemble` on one injected
  chunk (tokens and masks exactly, logprobs, reference logprobs and
  advantages to 1e-5, the `grpo/*` stats);
- `trlx_tpu_torch.train` against `trlx_tpu.train` on the same injected
  samples (sampled decoding cannot match across `jax.random` and
  `torch.Generator`, and a greedy group has zero advantage), two cycles,
  with and without stop sequences: the loss and `grpo/*` streams to rtol
  1e-4, the stores to 1e-4, the final weights, the reference frozen;
- the decode engine against the static sampler, greedy, token for token;
  the prefetch (`overlap_rollouts`) against the run without it;
- `save_pretrained` -> `model_path=dir` bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.data.default_configs import default_grpo_config as j_default_grpo_config
from trlx_tpu.data.method_configs import GRPOConfig as JGRPOConfig
from trlx_tpu.ops.grpo import group_relative_advantages as j_group_relative_advantages
from trlx_tpu.ops.grpo import grpo_loss as j_grpo_loss
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer import grpo as j_grpo
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.utils import Clock as JClock
from trlx_tpu.utils.loading import get_trainer as j_get_trainer

import trlx_tpu_torch
from trlx_tpu_torch.data import GRPORolloutBatch, PPORolloutBatch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_grpo_config, default_sft_config
from trlx_tpu_torch.data.method_configs import GRPOConfig
from trlx_tpu_torch.models import wrappers
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.ops.grpo import group_relative_advantages, grpo_loss
from trlx_tpu_torch.pipeline import epoch_shuffle_order
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.trainer import base as trainer_base
from trlx_tpu_torch.trainer import grpo
from trlx_tpu_torch.utils import Clock
from trlx_tpu_torch.utils.loading import get_trainer

# -- ops ------------------------------------------------------------------

ADVANTAGE_CASES = {  # name: (rewards, group_size); the first three are tests/test_grpo.py's goldens
    "golden_one_group": ([1.0, 2.0, 3.0, 6.0], 4),
    "independent_groups": ([1.0, 2.0, 10.0, 20.0], 2),
    "degenerate_first_group": ([5.0, 5.0, 5.0, 5.0, 1.0, 2.0, 3.0, 6.0], 4),
    "random_groups": (np.random.default_rng(3).normal(0, 2, 24).tolist(), 8),
    "ties_and_negatives": ([-1.0, -1.0, 2.0, 2.0, 0.5, 0.5, 0.5, 0.5, 3.0, -3.0, 0.0, 1e-3], 4),
}


@pytest.mark.parametrize("case", sorted(ADVANTAGE_CASES))
def test_group_relative_advantages_match_reference(case):
    rewards, gs = ADVANTAGE_CASES[case]
    r = np.asarray(rewards, np.float32)
    got = group_relative_advantages(torch.from_numpy(r), gs).numpy()
    want = np.asarray(j_group_relative_advantages(jnp.asarray(r), gs))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    g = r.reshape(-1, gs)
    degenerate = g.std(axis=1) <= 1e-6
    assert np.all(np.isfinite(got))
    assert np.all(got.reshape(-1, gs)[degenerate] == 0.0)  # exactly zero, not 0/eps
    np.testing.assert_allclose(got.reshape(-1, gs)[~degenerate].sum(axis=1), 0.0, atol=1e-5)
    if case == "independent_groups":
        np.testing.assert_allclose(got, [-1.0, 1.0, -1.0, 1.0], rtol=1e-4)


@pytest.mark.parametrize("n, gs", [(6, 4), (3, 2), (10, 8)])
def test_group_relative_advantages_reject_partial_groups(n, gs):
    with pytest.raises(ValueError, match="not a multiple") as ours:
        group_relative_advantages(torch.zeros(n), gs)
    with pytest.raises(ValueError) as ref:
        j_group_relative_advantages(jnp.zeros(n), gs)
    assert str(ours.value) == str(ref.value)


def _loss_inputs(seed, B=4, N=5):
    rng = np.random.default_rng(seed)
    lp = rng.normal(-2.0, 0.3, (B, N)).astype(np.float32)
    old = (lp + rng.normal(0, 0.2, (B, N))).astype(np.float32)  # some ratios past the clip
    ref = (lp + rng.normal(0, 0.1, (B, N))).astype(np.float32)
    adv = rng.normal(0, 1, B).astype(np.float32)
    mask = (rng.random((B, N)) < 0.8).astype(np.float32)
    mask[:, 0] = 1
    w = rng.uniform(0.7, 1.3, (B, N)).astype(np.float32)
    return lp, old, ref, adv, mask, w


@pytest.mark.parametrize("with_weight", [False, True])
@pytest.mark.parametrize("with_norm", [False, True])
def test_grpo_loss_and_grad_match_reference(with_weight, with_norm):
    lp, old, ref, adv, mask, w = _loss_inputs(1)
    kw = dict(cliprange=0.2, kl_coef=0.3)
    norm = np.float32(mask.sum() / 2) if with_norm else None
    lp_t = torch.from_numpy(lp).requires_grad_(True)
    loss, stats = grpo_loss(lp_t, torch.from_numpy(old), torch.from_numpy(ref), torch.from_numpy(adv),
                            torch.from_numpy(mask), is_weight=torch.from_numpy(w) if with_weight else None,
                            norm_n=None if norm is None else torch.tensor(norm), **kw)
    loss.backward()

    def j_loss(x):
        return j_grpo_loss(x, jnp.asarray(old), jnp.asarray(ref), jnp.asarray(adv), jnp.asarray(mask),
                           is_weight=jnp.asarray(w) if with_weight else None,
                           norm_n=None if norm is None else jnp.asarray(norm), **kw)

    (j_val, j_stats), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(lp))
    assert set(stats) == set(j_stats)
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    for k in j_stats:
        np.testing.assert_allclose(stats[k].item(), float(j_stats[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(lp_t.grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-5)
    assert float(stats["policy/clipfrac"]) > 0  # the clip is exercised


def test_grpo_loss_zero_at_identity_and_clip_bound():
    lp, _, _, _, mask, _ = _loss_inputs(2)
    t = torch.from_numpy(lp)
    loss, stats = grpo_loss(t, t, t, torch.zeros(len(lp)), torch.from_numpy(mask), cliprange=0.2, kl_coef=0.1)
    assert float(loss) == 0.0 and float(stats["losses/kl_loss"]) == 0.0 and float(stats["policy/clipfrac"]) == 0.0
    # a ratio of e past 1 + 0.2 with a positive advantage: the clipped branch wins, -1.2
    one = torch.tensor([[-2.0]])
    loss, stats = grpo_loss(one, one - 1.0, one - 1.0, torch.tensor([1.0]), torch.ones(1, 1), cliprange=0.2,
                            kl_coef=0.0)
    np.testing.assert_allclose(float(loss), -1.2, rtol=1e-6)
    assert float(stats["policy/clipfrac"]) == 1.0


@pytest.mark.parametrize("kw", [dict(group_size=1), dict(group_size=3, chunk_size=8),
                                dict(group_size=4, chunk_size=8, num_rollouts=12)])
def test_grpo_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as ours:
        GRPOConfig(name="g", **kw)
    with pytest.raises(ValueError) as ref:
        JGRPOConfig(name="g", **kw)
    assert str(ours.value) == str(ref.value)


def test_default_grpo_config_matches_reference():
    got, want = default_grpo_config().to_dict(), j_default_grpo_config().to_dict()
    assert got == want
    assert "vf_coef" not in got["method"] and got["train"]["trainer"] == "TPUGRPOTrainer"


# -- the store -------------------------------------------------------------


def _grpo_chunk(seed, B=4, P=3, N=5):
    g = torch.Generator().manual_seed(seed)
    return GRPORolloutBatch(
        query_tensors=torch.randint(0, 256, (B, P), generator=g),
        response_tensors=torch.randint(0, 256, (B, N), generator=g),
        logprobs=-torch.rand(B, N, generator=g),
        ref_logprobs=-torch.rand(B, N, generator=g),
        advantages=torch.randn(B, generator=g),
        response_mask=(torch.rand(B, N, generator=g) < 0.7).float(),
    )


def test_store_holds_grpo_batches(tmp_path):
    """Two GRPO chunks pushed: every field concatenated (the None fields
    stay None), the loader's gathers in `epoch_shuffle_order`, and the
    export with reference logprobs and advantages and no values."""
    store = PPORolloutStorage(pad_token_id=257)
    a, b = _grpo_chunk(0), _grpo_chunk(1)
    store.push(a)
    store.push(b)
    assert len(store) == 8
    for name in ("query_tensors", "response_tensors", "logprobs", "ref_logprobs", "advantages", "response_mask"):
        assert torch.equal(getattr(store.history, name), torch.cat([getattr(a, name), getattr(b, name)])), name
    assert store.history.is_weight is None and store.history.norm_n is None
    for seed in (0, 5):
        batches = list(store.create_loader(3, shuffle=True, drop_last=True, seed=seed))
        order = epoch_shuffle_order(8, seed)
        assert len(batches) == 2
        for i, batch in enumerate(batches):
            rows = torch.as_tensor(order[3 * i:3 * i + 3])
            assert isinstance(batch, GRPORolloutBatch)
            assert torch.equal(batch.advantages, store.history.advantages[rows])
            assert torch.equal(batch.ref_logprobs, store.history.ref_logprobs[rows])
    assert torch.equal(store[5].logprobs, b.logprobs[1])
    store.export_history(str(tmp_path), trainer_base.load_tokenizer(default_grpo_config().evolve(
        tokenizer=dict(tokenizer_path="byte")).tokenizer))
    (fname,) = os.listdir(tmp_path)
    with open(tmp_path / fname) as f:
        rows = json.load(f)
    assert len(rows) == 8
    assert set(rows[0]) == {"query_tensor", "response_tensor", "logprobs", "ref_logprobs", "advantages",
                            "query", "response"}
    np.testing.assert_allclose(rows[6]["ref_logprobs"], b.ref_logprobs[2].numpy(), rtol=1e-7)
    assert rows[6]["advantages"] == pytest.approx(float(b.advantages[2]))


def test_store_holds_ppo_batches_as_before():
    def chunk(seed, B=3):
        g = torch.Generator().manual_seed(seed)
        return PPORolloutBatch(*(torch.randn(B, 4, generator=g) for _ in range(6)))

    store = PPORolloutStorage()
    a, b = chunk(0), chunk(1)
    store.push(a)
    store.push(b)
    for name in ("query_tensors", "response_tensors", "logprobs", "values", "rewards", "response_mask"):
        assert torch.equal(getattr(store.history, name), torch.cat([getattr(a, name), getattr(b, name)])), name
    assert store.history.advantages is None and store.history.returns is None
    with pytest.raises(TypeError, match="cannot push a GRPORolloutBatch"):
        store.push(_grpo_chunk(2))


# -- the trainer -------------------------------------------------------------

PROMPTS = ["hello world", "the cat", "a b", "xyz", "what is", "I am", "go", "ok"]
GROUP, CHUNK, NEW, SEQ = 4, 8, 6, 12
EOS = PAD = 257


def reward_fn(samples, prompts, outputs, **kw):
    return [0.25 * len(set(o)) - 0.05 * len(o) for o in outputs]


def _config(tmp_path, **method):
    return j_default_grpo_config().evolve(
        train=dict(batch_size=8, total_steps=8, eval_interval=6, checkpoint_interval=100, seq_length=SEQ,
                   epochs=4, tracker=None, compute_dtype="float32", fused_inner_loop=False,
                   checkpoint_dir=str(tmp_path / "ckpts"), seed=3),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={
            "transformer": dict(vocab_size=258, hidden_size=32, n_layer=2, n_head=2, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)),
        method=dict(dict(num_rollouts=2 * CHUNK, chunk_size=CHUNK, group_size=GROUP, grpo_epochs=2, kl_coef=0.05,
                         gen_kwargs=dict(max_new_tokens=NEW, top_k=0, top_p=1.0, do_sample=True)), **method),
    )


def script(call: int, B: int):
    """The responses of sampler call `call`: letters a-d, about half the
    rows ending on EOS somewhere (then padding, masked out), and the first
    group's rows all equal to its first (a degenerate group)."""
    rng = np.random.default_rng(100 + call)
    resp = rng.integers(97, 101, size=(B, NEW))
    mask = np.ones((B, NEW), np.int32)
    ends = rng.integers(1, NEW + 1, size=B)
    for i in np.flatnonzero(rng.random(B) < 0.5):
        resp[i, ends[i] - 1] = EOS
        resp[i, ends[i]:] = PAD
        mask[i, ends[i]:] = 0
    resp[:GROUP], mask[:GROUP] = resp[0], mask[0]
    return resp, mask


def scripted_generate(calls: list, port: bool):
    """A `generate` that returns the prompt rows and `script`'s responses
    in each package's own output layout."""

    def gen(self, input_ids, attention_mask=None, settings=None, **kw):
        ids = np.asarray(input_ids)
        pmask = np.ones_like(ids) if attention_mask is None else np.asarray(attention_mask)
        resp, mask = script(len(calls), len(ids))
        calls.append(len(ids))
        seq = np.concatenate([ids, resp], axis=1)
        if port:
            return {"sequences": torch.as_tensor(seq, dtype=torch.long),
                    "response_ids": torch.as_tensor(resp, dtype=torch.long),
                    "response_mask": torch.as_tensor(mask, dtype=torch.int32),
                    "prompt_mask": torch.as_tensor(pmask, dtype=torch.int32)}
        return {"sequences": jnp.asarray(seq, jnp.int32), "response_ids": jnp.asarray(resp, jnp.int32),
                "response_mask": jnp.asarray(mask, jnp.int32), "prompt_mask": jnp.asarray(pmask, jnp.int32)}

    return gen


def _load_init(init):
    return lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self


def test_prompt_tiling_and_score_and_assemble_match_reference(tmp_path):
    """Both trainers from the same weights pull three chunks (tiling and
    cursor exactly), then score and assemble the same injected chunk."""
    jconfig = _config(tmp_path)
    stats, j_stats = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        ref = j_get_trainer("TPUGRPOTrainer")(config=jconfig, reward_fn=reward_fn)
        init = jax.tree_util.tree_map(np.asarray, ref.params)
        mp.setattr(wrappers.CausalLM, "init_params", _load_init(init))
        ours = get_trainer("TPUGRPOTrainer")(config=TRLConfig.from_dict(jconfig.to_dict()), reward_fn=reward_fn,
                                             device="cpu")
    P = SEQ - NEW
    ref.add_prompt_pipeline(JPromptPipeline(PROMPTS, P, ref.tokenizer))
    ours.add_prompt_pipeline(PromptPipeline(PROMPTS, P, ours.tokenizer))
    for i in range(3):
        batch, j_batch = ours._next_prompt_batch(), ref._next_prompt_batch()
        np.testing.assert_array_equal(batch.input_ids.numpy(), np.asarray(j_batch.input_ids))
        np.testing.assert_array_equal(batch.attention_mask.numpy(), np.asarray(j_batch.attention_mask))
        ids = batch.input_ids.numpy()
        assert ids.shape == (CHUNK, P)
        for g in range(0, CHUNK, GROUP):  # a group's rows share one prompt
            assert (ids[g:g + GROUP] == ids[g]).all()
        assert ours._prompt_batches_consumed == ref._prompt_batches_consumed == i + 1
    resp, mask = script(0, CHUNK)
    got, rows = ours._score_and_assemble(batch, scripted_generate([], True)(ours, batch.input_ids,
                                                                            batch.attention_mask),
                                         stats, 0, Clock())
    want, j_rows = ref._score_and_assemble(j_batch, scripted_generate([], False)(ref, j_batch.input_ids,
                                                                               j_batch.attention_mask),
                                           j_stats, 0, JClock())
    want = jax.tree_util.tree_map(np.asarray, want)
    assert rows == j_rows == CHUNK
    for name in ("query_tensors", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.response_tensors.numpy(), resp)
    for name in ("logprobs", "ref_logprobs", "advantages"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.logprobs.numpy(), got.ref_logprobs.numpy())  # policy == reference at init
    assert (got.advantages[:GROUP] == 0).all()  # the degenerate group
    for k in ("grpo/group_reward_std", "grpo/zero_adv_groups", "rollout_scores/mean", "rollout_scores/std",
              "policy/sqrt_kl", "rollout/real_tokens", "rollout/truncation_rate"):
        np.testing.assert_allclose(float(stats[k]), float(j_stats[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert stats["grpo/zero_adv_groups"] == 0.5


@pytest.fixture(scope="module", params=["plain", "stop_sequences"])
def train_runs(request, tmp_path_factory):
    """`trlx_tpu.train` and `trlx_tpu_torch.train` on the same config and
    the same injected samples, two cycles of two chunks: (reference
    trainer, its init as numpy, its logged stats, the port's trainer)."""
    stops = ["c"] if request.param == "stop_sequences" else None
    jconfig = _config(tmp_path_factory.mktemp(request.param))
    init, j_stats = {}, []
    setup = j_grpo.TPUGRPOTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_grpo.TPUGRPOTrainer, "setup_model", capture_setup)
        mp.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: j_stats.append((step, dict(st))))
        mp.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
        mp.setattr(JBaseTrainer, "generate", scripted_generate([], False))
        ref = trlx_tpu.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:4], config=jconfig,
                             stop_sequences=stops)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wrappers.CausalLM, "init_params", _load_init(init))
        mp.setattr(trainer_base.TPUBaseTrainer, "generate", scripted_generate([], True))
        ours = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:4],
                                    config=TRLConfig.from_dict(jconfig.to_dict()), stop_sequences=stops,
                                    device="cpu")
    return ref, init, j_stats, ours


def _stream(history, key):
    return [(step, float(s[key])) for step, s in history if key in s]


@pytest.mark.parametrize("key", ["losses/total_loss", "losses/policy_loss", "losses/kl_loss", "policy/approx_kl",
                                 "advantages/mean", "grpo/group_reward_std", "grpo/zero_adv_groups",
                                 "rollout_scores/mean", "policy/sqrt_kl"])
def test_train_streams_match_reference(train_runs, key):
    ref, _, j_stats, ours = train_runs
    assert isinstance(ours, grpo.TPUGRPOTrainer)
    assert ours.iter_count == ref.iter_count == 8
    want, got = _stream(j_stats, key), _stream(ours.stats_history, key)
    assert want and [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-6)


def test_train_store_and_cursor_match_reference(train_runs):
    ref, _, _, ours = train_runs
    j_hist = jax.tree_util.tree_map(np.asarray, ref.store.history)
    hist = ours.store.history
    assert len(ours.store) == 2 * CHUNK
    for name in ("query_tensors", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(getattr(hist, name).numpy(), getattr(j_hist, name), err_msg=name)
    for name in ("logprobs", "ref_logprobs", "advantages"):
        np.testing.assert_allclose(getattr(hist, name).numpy(), getattr(j_hist, name), atol=1e-4, rtol=0,
                                   err_msg=name)
    assert ours._prompt_batches_consumed == ref._prompt_batches_consumed
    real = hist.response_mask.bool()
    if ours.stop_sequences:  # every output was cut before its first "c" and re-tokenised
        assert not (hist.response_tensors[real] == ord("c")).any()
        assert real.sum() < real.numel() - 8
    else:
        assert (hist.response_tensors[real] == ord("c")).any()


def test_train_weights_match_reference_and_reference_stays_frozen(train_runs):
    """The final weights to 1e-5; the frozen reference bit for bit the
    initial policy, apart from the policy's tensors and out of AdamW."""
    ref, init, _, ours = train_runs
    start = params_from_jax(init, ours.model.cfg)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params), ours.model.cfg)
    for name, p in ours.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    moved = [n for n, p in ours.model.named_parameters() if not torch.equal(p.detach(), start[n])]
    assert moved
    for name, p in ours.ref_params.named_parameters():
        assert not p.requires_grad and torch.equal(p, start["base." + name]), name
    assert all(p.data_ptr() != q.data_ptr() for p in ours.ref_params.parameters() for q in ours.model.parameters())
    assert {id(p) for g in ours.optimizer.param_groups for p in g["params"]}.isdisjoint(
        {id(p) for p in ours.ref_params.parameters()})


def test_engine_matches_static_sampler_greedy(tmp_path):
    """Greedy GRPO with the decode engine on and off: the stores token for
    token and the loss streams equal."""
    runs = []
    for engine in ({}, {"enabled": True, "slots": 4, "page_size": 4}):
        config = TRLConfig.from_dict(_config(tmp_path, gen_engine=engine, gen_kwargs=dict(
            max_new_tokens=NEW, do_sample=False)).to_dict()).evolve(train=dict(total_steps=4))
        runs.append(trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, config=config, device="cpu"))
    static, engine = runs
    assert engine._decode_impl().startswith("engine") and static._decode_impl() == "static"
    for name in ("query_tensors", "response_tensors", "response_mask", "logprobs", "ref_logprobs", "advantages"):
        assert torch.equal(getattr(engine.store.history, name), getattr(static.store.history, name)), name
    assert _stream(engine.stats_history, "losses/total_loss") == _stream(static.stats_history, "losses/total_loss")
    assert any("rollout/engine_decode_steps" in s for _, s in engine.stats_history)


def test_overlap_rollouts_prefetch(tmp_path, monkeypatch):
    """`method.overlap_rollouts` under `fused_inner_loop` through the shared
    core: the second cycle's first chunk is generated before the first
    cycle's steps and scored after them. On the same injected samples the
    stores and the loss stream equal the run without it, bit for bit."""
    prefetched = []
    hook = trainer_base.TPUOnlineTrainer.pre_optimization_hook

    def spy(self, will_continue):
        hook(self, will_continue)
        prefetched.append((self.iter_count, self._prefetched_gen is not None))

    monkeypatch.setattr(trainer_base.TPUOnlineTrainer, "pre_optimization_hook", spy)
    runs = []
    for overlap in (False, True):
        monkeypatch.setattr(trainer_base.TPUBaseTrainer, "generate", scripted_generate([], True))
        config = TRLConfig.from_dict(_config(tmp_path, overlap_rollouts=overlap).to_dict()).evolve(
            train=dict(fused_inner_loop=True))
        runs.append(trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, config=config, device="cpu"))
    plain, overlap = runs
    assert prefetched == [(0, False), (4, False), (0, True), (4, False)]  # one prefetch, before cycle 1's steps
    for name in ("query_tensors", "response_tensors", "logprobs", "ref_logprobs", "advantages"):
        assert torch.equal(getattr(overlap.store.history, name), getattr(plain.store.history, name)), name
    assert _stream(overlap.stats_history, "losses/total_loss") == _stream(plain.stats_history, "losses/total_loss")
    assert overlap._prompt_batches_consumed == plain._prompt_batches_consumed == 4


def test_save_pretrained_round_trip(tmp_path):
    config = TRLConfig.from_dict(_config(tmp_path).to_dict()).evolve(train=dict(total_steps=2))
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, config=config, device="cpu")
    directory = str(tmp_path / "saved")
    trainer.save_pretrained(directory)
    assert not os.path.exists(os.path.join(directory, "aux_weights.pt"))  # the base alone
    sft = default_sft_config().evolve(train=dict(compute_dtype="float32", checkpoint_dir=str(tmp_path / "sft")),
                                      tokenizer=dict(tokenizer_path="byte"), model=config.to_dict()["model"])
    for cfg in (config, sft):  # into GRPO, and into another causal trainer
        reloaded = get_trainer(cfg.train.trainer)(config=cfg.evolve(model=dict(model_path=directory)), device="cpu")
        want = trainer.model.base.state_dict()
        got = reloaded.model.base.state_dict()
        assert set(got) == set(want)
        for k, t in want.items():
            assert torch.equal(got[k], t), k
    # the reloaded GRPO trainer's reference is rebuilt from the loaded weights
    grpo_reloaded = get_trainer("TPUGRPOTrainer")(config=config.evolve(model=dict(model_path=directory)),
                                                  device="cpu")
    for k, t in grpo_reloaded.ref_params.state_dict().items():
        assert torch.equal(t, trainer.model.base.state_dict()[k]), k


@pytest.mark.parametrize("name", ["TPUGRPOTrainer", "AccelerateGRPOTrainer", "tpugrpotrainer"])
def test_registry_and_seq2seq(tmp_path, name):
    assert get_trainer(name) is grpo.TPUGRPOTrainer
    config = TRLConfig.from_dict(_config(tmp_path).to_dict()).evolve(model=dict(
        model_arch_type="seq2seq", model_extra_configs={"seq2seq": dict(d_model=16, n_layer=1, n_head=2, d_kv=8,
                                                                         d_ff=32, vocab_size=258)}))
    with pytest.raises(NotImplementedError, match="seq2seq GRPO is not implemented"):
        get_trainer(name)(config=config, device="cpu")
