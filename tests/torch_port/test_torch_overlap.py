"""The cross-cycle rollout prefetch (`method.overlap_rollouts`) and the
deferred rollout stats, on the CPU:

- `train()` with `fused_inner_loop` and `overlap_rollouts` on, against
  `trlx_tpu.train` on the same config (its fused block, its prefetch):
  the last cycle's store, whose first chunk is the prefetched one (tokens
  and masks exactly, floats atol 1e-4), each block's mean loss (rtol
  1e-4; the reference logs one record a block), the evaluations at the
  block boundaries, the KL coefficient each cycle collected at, the
  prompt cursor and no prefetch left in flight;
- on the same run, spies on the weights: the prefetched chunk was
  generated with the pre-block weights and scored with the updated ones,
  and the last cycle (will_continue false) prefetched nothing;
- no prefetch with `fused_inner_loop` off; the live cursor advances with
  a prefetch and `_abandon_prefetch` rewinds it; an exception inside
  learn() leaves it rewound; a run through the decode engine with
  speculative decoding prefetches through the engine;
- `DeferredStats`: stage and flush order, host floats, an idempotent
  flush."""

import numpy as np
import pytest
import torch

import trlx_tpu_torch
from tests.torch_port import ppo_parity
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.trainer.base import TPUBaseTrainer, TPUOnlineTrainer
from trlx_tpu_torch.trainer.ppo import TPUPPOTrainer
from trlx_tpu_torch.utils import to_scalar
from trlx_tpu_torch.utils.loading import get_pipeline, get_trainer
from trlx_tpu_torch.utils.trackers import DeferredStats

BLOCK = 4  # optimizer steps a cycle: 2 epochs x 2 minibatches


def _overlap_config(tmp_path, fused=True, **method):
    # eval_interval = one block: the reference's block-quantised evals fall
    # on the steps where the port's per-step loop evaluates
    return ppo_parity.config(tmp_path, fused_inner_loop=fused, train=dict(eval_interval=BLOCK),
                             method=dict(overlap_rollouts=True, **method))


def _weights(trainer) -> torch.Tensor:
    return torch.cat([p.detach().flatten() for p in trainer.model.parameters()]).clone()


@pytest.fixture
def spies(monkeypatch):
    """Events of a port run in order: ("gen", iter_count, weights,
    in_hook, sequences) for each rollout chunk generated, ("hook",
    will_continue), ("exp", iter_count, weights, tokens) for each
    experience pass and ("step", iter_count, prefetch in flight)."""
    events, in_hook = [], []
    pull, hook = TPUOnlineTrainer._pull_and_generate, TPUOnlineTrainer.pre_optimization_hook
    exp, step = TPUPPOTrainer.experience_forward, TPUBaseTrainer.train_step

    def spy_pull(self):
        out = pull(self)
        events.append(("gen", self.iter_count, _weights(self), bool(in_hook), out[1]["sequences"].clone()))
        return out

    def spy_hook(self, will_continue):
        events.append(("hook", will_continue))
        in_hook.append(True)
        try:
            return hook(self, will_continue)
        finally:
            in_hook.pop()

    def spy_exp(self, tokens, *args):
        events.append(("exp", self.iter_count, _weights(self), tokens.clone()))
        return exp(self, tokens, *args)

    def spy_step(self, batch):
        events.append(("step", self.iter_count, self._prefetched_gen is not None))
        return step(self, batch)

    monkeypatch.setattr(TPUOnlineTrainer, "_pull_and_generate", spy_pull)
    monkeypatch.setattr(TPUOnlineTrainer, "pre_optimization_hook", spy_hook)
    monkeypatch.setattr(TPUPPOTrainer, "experience_forward", spy_exp)
    monkeypatch.setattr(TPUBaseTrainer, "train_step", spy_step)
    return events


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    jconfig = _overlap_config(tmp_path_factory.mktemp("overlap"))
    ref, init, j_stats = ppo_parity.run_reference(jconfig)
    return jconfig, ref, init, j_stats


def test_overlap_train_matches_reference_and_prefetch_semantics(reference, spies):
    jconfig, ref, init, j_stats = reference
    ours = ppo_parity.run_port(jconfig, init)
    assert ours.iter_count == ref.iter_count == 8
    assert ours._prefetched_gen is None and ref._prefetched_gen is None
    # two chunks a cycle, two cycles, the second cycle's first chunk the
    # prefetched one: every pulled chunk trained
    assert ours._prompt_batches_consumed == ref._prompt_batches_consumed == 4
    ppo_parity.assert_store_matches(ours, ref)

    want, got = ppo_parity.losses(j_stats), ppo_parity.losses(ours.stats_history)
    assert [s for s, _ in want] == [BLOCK, 2 * BLOCK]  # one record a fused block
    assert [s for s, _ in got] == list(range(1, 2 * BLOCK + 1))
    block_means = [np.mean([v for _, v in got[i:i + BLOCK]]) for i in range(0, len(got), BLOCK)]
    np.testing.assert_allclose(block_means, [v for _, v in want], rtol=1e-4)
    # the KL coefficient each cycle's rollouts were collected at (the
    # reference runs its fused block's callbacks after the last block too,
    # the port its per-step loop's, which end at total_steps: only the
    # coefficient left after the run differs)
    def kl_at_collection(stream):
        return [(step, float(s["kl_ctl_value"])) for step, s in stream if "kl_ctl_value" in s]

    got_kl, want_kl = kl_at_collection(ours.stats_history), kl_at_collection(j_stats)
    assert [s for s, _ in got_kl] == [s for s, _ in want_kl] == [0, BLOCK]
    np.testing.assert_allclose([v for _, v in got_kl], [v for _, v in want_kl], rtol=1e-5)
    assert got_kl[1][1] != got_kl[0][1]  # the controller moved

    def evals(stream):
        return [(step, float(s["reward/mean"])) for step, s in stream if "reward/mean" in s]

    assert [s for s, _ in evals(ours.stats_history)] == [s for s, _ in evals(j_stats)] == [0, BLOCK, 2 * BLOCK]
    np.testing.assert_allclose([v for _, v in evals(ours.stats_history)], [v for _, v in evals(j_stats)], rtol=1e-6)

    # the prefetch: one hook a cycle, the first continuing, the last not
    events = spies
    assert [e[1] for e in events if e[0] == "hook"] == [True, False]
    gens = [e for e in events if e[0] == "gen"]
    prefetched = [e for e in gens if e[3]]
    assert len(gens) == 4 and len(prefetched) == 1
    _, it, pre_block, _, prefetched_seqs = prefetched[0]
    # generated before the block's first step, with the weights the first
    # cycle's rollouts were generated with
    first_step = next(i for i, e in enumerate(events) if e[0] == "step")
    assert next(i for i, e in enumerate(events) if e is prefetched[0]) < first_step and it == 0
    assert torch.equal(pre_block, gens[0][2])
    # in flight during the first cycle's steps, gone in the second's
    assert [e[2] for e in events if e[0] == "step"] == [True] * BLOCK + [False] * BLOCK
    # scored after the block, on its own tokens, with the updated weights
    scored = [e for e in events if e[0] == "exp" and e[1] == BLOCK]
    assert len(scored) == 2
    assert torch.equal(scored[0][3], prefetched_seqs)
    assert not torch.equal(scored[0][2], pre_block)
    assert not torch.equal(scored[0][2], _weights(ours))  # the second cycle trained on
    assert torch.equal(scored[0][2], scored[1][2])


def test_no_prefetch_without_fused_inner_loop(tmp_path, spies):
    config = TRLConfig.from_dict(_overlap_config(tmp_path, fused=False).to_dict())
    ours = trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, config=config,
                                device="cpu")
    assert ours.iter_count == 8 and ours._prompt_batches_consumed == 4
    assert not [e for e in spies if e[0] == "hook"]
    assert not [e for e in spies if e[0] == "gen" and e[3]]
    assert not any(e[2] for e in spies if e[0] == "step")


def _hand_built(tmp_path):
    """A port PPO trainer wired to the prompt pipeline by hand (the api
    path minus learn())."""
    config = TRLConfig.from_dict(_overlap_config(tmp_path).to_dict())
    trainer = get_trainer(config.train.trainer)(config=config, reward_fn=ppo_parity.reward_fn, device="cpu")
    max_prompt_length = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    pipeline = get_pipeline(config.train.pipeline)
    trainer.add_prompt_pipeline(pipeline(ppo_parity.PROMPTS, max_prompt_length, trainer.tokenizer))
    return trainer


def test_prefetch_cursor_and_abandon(tmp_path):
    trainer = _hand_built(tmp_path)
    trainer.make_experience(8)
    assert trainer._prompt_batches_consumed == 1

    trainer.pre_optimization_hook(will_continue=True)
    assert trainer._prefetched_gen is not None
    assert trainer._prompt_batches_consumed == 2  # the live cursor advanced
    assert trainer._prefetch_cursor_start == 1

    trainer._abandon_prefetch()
    assert trainer._prefetched_gen is None and trainer._prefetch_cursor_start is None
    assert trainer._prompt_batches_consumed == 1

    # the final block (will_continue false) prefetches nothing
    trainer.pre_optimization_hook(will_continue=False)
    assert trainer._prefetched_gen is None and trainer._prompt_batches_consumed == 1


def test_exception_in_learn_rewinds_the_prefetch(tmp_path, monkeypatch):
    seen = []
    step = TPUBaseTrainer.train_step

    def failing_step(self, batch):
        seen.append(self)
        if self.iter_count == 2:
            raise RuntimeError("injected")
        return step(self, batch)

    monkeypatch.setattr(TPUBaseTrainer, "train_step", failing_step)
    config = TRLConfig.from_dict(_overlap_config(tmp_path).to_dict())
    with pytest.raises(RuntimeError, match="injected"):
        trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, config=config, device="cpu")
    trainer = seen[-1]
    # the first cycle's two chunks trained; the prefetched third did not
    assert trainer._prefetched_gen is None
    assert trainer._prompt_batches_consumed == 2


def test_overlap_through_the_engine_with_spec_decode(tmp_path, monkeypatch, spies):
    calls = []
    engine_generate = TPUBaseTrainer._engine_generate

    def counted(self, *args, **kwargs):
        calls.append(self._active_phase)
        return engine_generate(self, *args, **kwargs)

    monkeypatch.setattr(TPUBaseTrainer, "_engine_generate", counted)
    config = TRLConfig.from_dict(_overlap_config(tmp_path, gen_engine=dict(
        enabled=True, slots=4, page_size=8, spec_decode=True, draft_k=2)).to_dict())
    ours = trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, config=config,
                                device="cpu")
    assert ours.iter_count == 8 and ours._prompt_batches_consumed == 4 and ours._prefetched_gen is None
    # four rollout chunks (the prefetched one among them) and three evals,
    # all through the engine
    assert calls.count("generate") == 4 and calls.count("eval") == 3
    assert len([e for e in spies if e[0] == "gen" and e[3]]) == 1
    losses = ppo_parity.losses(ours.stats_history)
    assert len(losses) == 8 and all(np.isfinite(v) for _, v in losses)
    assert [s for s, st in ours.stats_history if "rollout/spec_accept_rate" in st] == [0, BLOCK]


def test_deferred_stats_order_and_idempotent_flush():
    deferred = DeferredStats()
    assert deferred.flush() == []
    first = {"a": torch.tensor(0.1), "b": 2.5, "c": torch.tensor([3.25]).sum()}
    second = {"a": torch.tensor(1.0 / 3.0, dtype=torch.float64), "d": 7}
    deferred.stage(first, step=3, meta=0.05)
    deferred.stage(second, step=4)
    deferred.stage({"e": 1.0}, step=4, meta="no tensors")
    out = deferred.flush()
    assert [(step, meta) for _, step, meta in out] == [(3, 0.05), (4, None), (4, "no tensors")]
    assert [list(stats) for stats, _, _ in out] == [["a", "b", "c"], ["a", "d"], ["e"]]
    # every value a host float equal to what an eager read gives
    for (stats, _, _), staged in zip(out, (first, second, {"e": 1.0})):
        for k, v in stats.items():
            assert type(v) is float and v == to_scalar(staged[k]), k
    assert deferred.flush() == []
