"""Checkpoint, resume and preemption in `trlx_tpu_torch`, on the CPU.

- Against the JAX package (`trlx_tpu.train`, tiny fp32 greedy PPO of
  `ppo_parity.py`, converted init): each run is killed by a SIGTERM sent
  from the reward function at the same call, then resumed with
  `resume_from_checkpoint="auto"`, in both packages. Three kills, those
  of `tests/test_fault_tolerance.py`: in the second cycle's rollout, in
  the scoring of a prefetched chunk (`overlap_rollouts`, the cursor
  rewinds past it) and in the first rollout (abandoned, checkpoint_0).
  The two preemption checkpoints' `state.json` agree exactly on the
  counters and cursors and to 1e-4 on the KL controller and the reward
  normalisation; the resumed runs' stores and loss streams agree at
  `ppo_parity.py`'s tolerances, and so do the final checkpoints.
- Against itself: PPO (sampled), SFT, ILQL, GRPO, RFT and DPO killed mid-run and
  resumed equal the same run uninterrupted, on one CPU thread: the
  weights, the AdamW moments and steps bit for bit, the counters, the
  cursors, the sampler's generator and the minibatch order exactly.
  Relaunching a completed run calls the reward function zero times.
- The layout: the JAX package's `scripts/verify_ckpt.py`, unedited,
  reports a port checkpoint healthy; `load` refuses another architecture
  and a corrupt pinned checkpoint; the tracker's `metrics.jsonl` is
  monotonic across the restart with no repeated loss step.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.trainer.ppo import TPUPPOTrainer as JPPOTrainer

import trlx_tpu_torch
from tests.torch_port import ppo_parity
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ilql_config, default_sft_config
from trlx_tpu_torch.data.default_configs import default_dpo_config, default_grpo_config
from trlx_tpu_torch.models import wrappers
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.utils.checkpointing import CheckpointCorruptError, CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXACT_KEYS = ("iter_count", "nth_evaluation", "total_steps", "config_total_steps", "prompt_batches_consumed",
              "prompt_stream")
CLOSE_KEYS = ("kl_ctl_value", "mean_kl", "ref_mean", "ref_std")


def killing_reward(at: int, calls: dict):
    """ppo_parity's reward, sending this process a SIGTERM at call `at`."""
    def reward(samples, prompts, outputs, **kw):
        calls["n"] = calls.get("n", 0) + 1
        if calls["n"] == at:
            os.kill(os.getpid(), signal.SIGTERM)
        return ppo_parity.reward_fn(samples, prompts, outputs)

    return reward


def jax_train(jconfig, reward, stats=None, init=None):
    """`trlx_tpu.train` with its checkpoints written, capturing the logged
    stats and, on a fresh run, the init."""
    stats = [] if stats is None else stats
    setup = JPPOTrainer.setup_model

    def capture_setup(self):
        setup(self)
        if init is not None:
            init.update(jax.tree_util.tree_map(np.asarray, self.params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPPOTrainer, "setup_model", capture_setup)
        mp.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: stats.append((step, dict(st))))
        trainer = trlx_tpu.train(reward_fn=reward, prompts=ppo_parity.PROMPTS, config=jconfig)
    return trainer, stats


def port_train(config, reward, init=None, device="cpu"):
    """`trlx_tpu_torch.train` on the CPU, from the reference's init when
    given (a resumed run's weights then come from its checkpoint)."""
    with pytest.MonkeyPatch.context() as mp:
        if init is not None:
            mp.setattr(wrappers.CausalLMWithValueHead, "init_params",
                       lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self)
        return trlx_tpu_torch.train(reward_fn=reward, prompts=ppo_parity.PROMPTS, config=config, device=device)


def state_json(checkpoint_dir, step=None):
    mgr = CheckpointManager(checkpoint_dir)
    path = mgr.latest_committed() if step is None else dict(mgr.step_checkpoints())[step]
    with open(os.path.join(path, "state.json")) as f:
        return os.path.basename(path), json.load(f)


def assert_state_json_matches(ours, ref, close_keys=CLOSE_KEYS):
    (our_name, ours), (ref_name, ref) = ours, ref
    assert our_name == ref_name
    for key in EXACT_KEYS:
        assert ours[key] == ref[key], key
    for key in close_keys:
        if ref[key] is None:
            assert ours[key] is None, key
        else:
            np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=1e-4, err_msg=key)
    for key in ("mean", "var", "std", "count"):
        np.testing.assert_allclose(ours["running_moments"][key], ref["running_moments"][key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)


# (kill at reward call, the reference's loop, method overrides, the step the
# preemption checkpoint holds, the resumed run's first logged loss step)
KILLS = {
    # calls 1-2: the first rollout, 3: the first evaluation, 4: the second
    # cycle's first chunk
    "second_rollout": (4, False, {}, 4),
    # call 4 scores the chunk prefetched before cycle 1's block
    "mid_prefetch": (4, True, {"overlap_rollouts": True}, 4),
    # call 1: the first rollout is abandoned, checkpoint_0
    "first_rollout": (1, False, {}, 0),
}


@pytest.mark.parametrize("kill", sorted(KILLS))
def test_kill_and_resume_matches_reference(tmp_path, kill):
    at, fused, method, killed_step = KILLS[kill]
    jconfig = ppo_parity.config(tmp_path / "jax", fused_inner_loop=fused, method=method)
    config = TRLConfig.from_dict(jconfig.evolve(train=dict(checkpoint_dir=str(tmp_path / "port"))).to_dict())

    init, j_calls, calls = {}, {}, {}
    ref, _ = jax_train(jconfig, killing_reward(at, j_calls), init=init)
    ours = port_train(config, killing_reward(at, calls), init)
    assert calls["n"] == j_calls["n"] == at
    assert ours.iter_count == ref.iter_count == killed_step
    assert ours._prefetched_gen is None
    ours_ckpt, ref_ckpt = state_json(config.train.checkpoint_dir), state_json(jconfig.train.checkpoint_dir)
    assert ours_ckpt[1]["iter_count"] == killed_step
    assert_state_json_matches(ours_ckpt, ref_ckpt)
    if kill == "mid_prefetch":
        # the prefetched chunk (pulled third) never trained: replayed
        assert ours_ckpt[1]["prompt_batches_consumed"] == 2

    def resumed(cfg):
        return cfg.evolve(train=dict(resume_from_checkpoint="auto"))

    ref, j_stats = jax_train(resumed(jconfig), ppo_parity.reward_fn)
    ours = port_train(resumed(config), ppo_parity.reward_fn, init)
    assert ours.iter_count == ref.iter_count == 8
    ppo_parity.assert_store_matches(ours, ref)
    want, got = ppo_parity.losses(j_stats), ppo_parity.losses(ours.stats_history)
    assert [s for s, _ in got] == list(range(killed_step + 1, 9))
    if fused:  # the reference logs one mean a fused block of 4 steps
        got = [(got[i + 3][0], np.mean([v for _, v in got[i:i + 4]])) for i in range(0, len(got), 4)]
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-5)
    # the reference's fused block runs both inner epochs' KL updates before
    # its step-8 checkpoint, the per-step loop commits it at step 8, before
    # the last inner epoch's update (as the reference's per-step loop does)
    final_keys = tuple(k for k in CLOSE_KEYS if not (fused and k in ("kl_ctl_value", "mean_kl")))
    assert_state_json_matches(state_json(config.train.checkpoint_dir, 8), state_json(jconfig.train.checkpoint_dir, 8),
                              final_keys)


# ---------------------------------------------------------------------------
# the port against itself: killed and resumed == uninterrupted
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def batches(monkeypatch):
    """(iter_count, the batch's tensors) of every train step, in order."""
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    seen, step = [], TPUBaseTrainer.train_step

    def spy(self, batch):
        seen.append((self.iter_count, [t.clone() for t in vars(batch).values() if isinstance(t, torch.Tensor)]))
        return step(self, batch)

    monkeypatch.setattr(TPUBaseTrainer, "train_step", spy)
    return seen


def _killer(at, calls, then=None):
    """A reward or metric function that counts its calls and sends a
    SIGTERM at call `at`; `then` computes its result."""
    def fn(samples, **kw):
        calls["n"] = calls.get("n", 0) + 1
        if calls["n"] == at:
            os.kill(os.getpid(), signal.SIGTERM)
        return then(samples, **kw)

    return fn


def _ppo(directory, **train):
    return TRLConfig.from_dict(ppo_parity.config(directory, train=dict(dict(checkpoint_dir=str(directory)), **train),
                                                 method=dict(gen_kwargs=dict(max_new_tokens=4, do_sample=True)))
                               .to_dict())


def _grpo(tmp_path, **train):
    return default_grpo_config().evolve(
        train=dict(dict(batch_size=8, total_steps=8, eval_interval=6, checkpoint_interval=100, seq_length=12,
                        epochs=4, tracker=None, compute_dtype="float32", checkpoint_dir=str(tmp_path), seed=3),
                   **train),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={
            "transformer": dict(vocab_size=258, hidden_size=32, n_layer=2, n_head=2, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)),
        method=dict(num_rollouts=16, chunk_size=8, group_size=4, grpo_epochs=2, kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=6, top_k=0, top_p=1.0, do_sample=True)))


SFT_SAMPLES = [("one", " two"), ("three", " four"), ("five", " six"), ("seven", " eight"), ("nine", " ten"),
               ("eleven", " twelve"), "thirteen", ("fourteen", " fifteen"), ("sixteen", " seventeen"), "eighteen",
               ("nineteen", " twenty"), "twenty-one"]
ILQL_SAMPLES = [("q", "good"), ("q", "bad"), ("p", "fine"), ("p", "meh"), ("r", "yes!"), ("r", "no"),
                ("s", "ok"), ("s", "nope")] * 2
ILQL_REWARDS = [1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 0.25, -0.25] * 2


def _offline(default, tmp_path, batch_size, **train):
    return default().evolve(
        train=dict(dict(batch_size=batch_size, total_steps=100, eval_interval=4, checkpoint_interval=100,
                        seq_length=12, epochs=3, tracker=None, compute_dtype="float32",
                        checkpoint_dir=str(tmp_path), seed=7), **train),
        model=dict(model_path="random", model_extra_configs={
            "transformer": dict(vocab_size=258, hidden_size=32, n_layer=2, n_head=2, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-2)),
        method=dict(gen_kwargs=dict(max_new_tokens=3, do_sample=True)))


def _metric(samples, **kw):
    return {"length": [float(len(s)) for s in samples]}


def _rft(directory):
    """Eight prompts, two sampled generations each an improve round, a
    round every second pass over the selected store."""
    return TRLConfig.from_dict(dict(
        train=dict(seq_length=12, epochs=10, total_steps=6, batch_size=8, checkpoint_interval=100, eval_interval=3,
                   pipeline="PromptPipeline", trainer="TPURFTTrainer", tracker=None, compute_dtype="float32",
                   checkpoint_dir=str(directory), seed=4),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={
            "transformer": dict(vocab_size=258, hidden_size=32, n_layer=2, n_head=2, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte", truncation_side="right"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=1000, eta_min=1e-3)),
        method=dict(name="rftconfig", n_generations_per_prompt=2, start_percentile=0.5, end_percentile=0.9,
                    n_improve_steps=2, gen_kwargs=dict(max_new_tokens=4, do_sample=True)),
    ))


DPO_TRIPLES = [(p, c, r) for p, c, r in zip(("the", "a b", "go", "ok", "hi", "q", "xy", "meh") * 2,
                                            ["aaaa", "ab", "b", "aaab"] * 4, ["zzzz", "zy", "zzz", "y"] * 4)]


# each algorithm: (config at a directory, train() kwargs with the function
# that kills (reward_fn or metric_fn) at call `at`, the call that kills,
# the step the preemption checkpoint holds)
ALGOS = {
    # reward calls 1-2: the first rollout, 3: the first evaluation, 4: the
    # second cycle's first chunk (sampled decoding)
    "ppo": (_ppo, lambda kill: dict(reward_fn=kill(ppo_parity.reward_fn), prompts=ppo_parity.PROMPTS), 4, 4),
    # checkpoints every cycle: the one at step 4, committed after the
    # cycle's last pass and its callback, is the one the kill resumes from
    "ppo_interval": (lambda d: _ppo(d, checkpoint_interval=4),
                     lambda kill: dict(reward_fn=kill(ppo_parity.reward_fn), prompts=ppo_parity.PROMPTS), 4, 4),
    # LoRA: the frozen base has no optimizer state, the adapter and the
    # value head do; the resumed run equals the uninterrupted one bit for bit
    "ppo_lora": (lambda d: _ppo(d).evolve(model=dict(peft_config={"peft_type": "LORA", "r": 4, "lora_alpha": 8})),
                 lambda kill: dict(reward_fn=kill(ppo_parity.reward_fn), prompts=ppo_parity.PROMPTS), 4, 4),
    "grpo": (_grpo, lambda kill: dict(reward_fn=kill(ppo_parity.reward_fn), prompts=ppo_parity.PROMPTS[:8]), 4, 4),
    # metric calls 1: the first evaluation, 2: step 4's, in the second
    # epoch of three batches (4 samples each): the kill lands mid-pass
    "sft": (lambda d: _offline(default_sft_config, d, 4),
            lambda kill: dict(samples=SFT_SAMPLES, metric_fn=kill(_metric)), 2, 4),
    # ILQL: four batches an epoch, the kill in step 3's evaluation (mid-pass,
    # before the pass-end target sync)
    # RFT: the kill in step 3's evaluation; the restored rounds and store
    "rft": (_rft, lambda kill: dict(reward_fn=kill(ppo_parity.reward_fn), prompts=["ab", "cd", "efg", "h", "ij",
                                                                                "kl", "mno", "p"]), 3, 3),
    # DPO: four batches of pairs an epoch, the kill in step 3's evaluation
    "dpo": (lambda d: _offline(default_dpo_config, d, 4, eval_interval=3),
            lambda kill: dict(samples=DPO_TRIPLES, metric_fn=kill(_metric)), 2, 3),
    "ilql": (lambda d: _offline(default_ilql_config, d, 4, epochs=2, eval_interval=3)
             .evolve(method=dict(steps_for_target_q_sync=2)),
             lambda kill: dict(samples=ILQL_SAMPLES, rewards=ILQL_REWARDS, metric_fn=kill(_metric)), 2, 3),
}


def _snapshot(trainer):
    opt = trainer.optimizer.state_dict()
    return {
        "model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
        "optimizer": {(i, k): v.clone() for i, st in opt["state"].items() for k, v in st.items()},
        "scheduler": trainer.scheduler.state_dict(),
        "generator": trainer.generator.get_state(),
        "host": (trainer.iter_count, trainer.nth_evaluation, getattr(trainer, "_prompt_batches_consumed", None),
                 float(getattr(getattr(trainer, "kl_ctl", None), "value", 0.0))),
    }


def _assert_snapshots_equal(got, want):
    assert got["host"] == want["host"]
    assert got["scheduler"] == want["scheduler"]
    assert torch.equal(got["generator"], want["generator"])
    for part in ("model", "optimizer"):
        assert got[part].keys() == want[part].keys(), part
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_killed_and_resumed_equals_uninterrupted(tmp_path, one_thread, batches, algo):
    make_config, task, at, killed_step = ALGOS[algo]

    def run(directory, kill_at=None, **train):
        calls = {}
        config = make_config(tmp_path / directory).evolve(train=train)
        trainer = trlx_tpu_torch.train(config=config, device="cpu",
                                       **task(lambda fn: _killer(kill_at, calls, fn)))
        return trainer, calls.get("n", 0)

    full, _ = run("full")
    full_batches, full_losses = list(batches), _losses(full)
    batches.clear()
    killed, n_calls = run("killed", kill_at=at)
    assert n_calls == at and killed.iter_count == killed_step < full.iter_count
    batches.clear()
    resumed, _ = run("killed", resume_from_checkpoint="auto")
    _assert_snapshots_equal(_snapshot(resumed), _snapshot(full))
    # the same minibatches, in the same order, from the restored step on
    want = [(i, b) for i, b in full_batches if i >= killed_step]
    assert [i for i, _ in batches] == [i for i, _ in want]
    for (_, got), (_, exp) in zip(batches, want):
        assert all(torch.equal(g, e) for g, e in zip(got, exp))
    assert _losses(resumed) == [x for x in full_losses if x[0] > killed_step]


def _losses(trainer):
    key = next(k for k in ("losses/total_loss", "losses/loss") if any(k in s for _, s in trainer.stats_history))
    return [(step, s[key]) for step, s in trainer.stats_history if key in s]


def test_relaunch_of_completed_run_and_tracker_log(tmp_path):
    """A killed PPO run resumed to its end: metrics.jsonl is monotonic
    with each loss step once; relaunching the completed run (the same
    command line, "auto") calls the reward function zero times; the
    environment variable takes precedence over the config."""
    config = _ppo(tmp_path / "ckpts").evolve(train=dict(checkpoint_interval=2, keep_last_n=2))
    calls = {}
    trlx_tpu_torch.train(reward_fn=_killer(4, calls, ppo_parity.reward_fn), prompts=ppo_parity.PROMPTS,
                         config=config, device="cpu")
    resumed = trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS,
                                   config=config.evolve(train=dict(resume_from_checkpoint="auto")), device="cpu")
    assert resumed.iter_count == 8
    with open(tmp_path / "ckpts" / "logs" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r["_step"] for r in records]
    assert steps == sorted(steps)
    loss_steps = [r["_step"] for r in records if "losses/total_loss" in r]
    assert loss_steps == list(range(1, 9))
    # keep_last_n=2 keeps two step checkpoints; best_checkpoint stays
    names = sorted(os.listdir(tmp_path / "ckpts"))
    assert [n for n in names if n.startswith("checkpoint_")] == ["checkpoint_6", "checkpoint_8"]
    assert "best_checkpoint" in names

    calls = {}
    again = trlx_tpu_torch.train(reward_fn=_killer(0, calls, ppo_parity.reward_fn), prompts=ppo_parity.PROMPTS,
                                 config=config.evolve(train=dict(resume_from_checkpoint="auto")), device="cpu")
    assert again.iter_count == 8 and calls.get("n", 0) == 0

    os.environ["TRLX_TPU_RESUME_FROM"] = str(tmp_path / "ckpts" / "checkpoint_8")
    try:
        pinned = trlx_tpu_torch.train(reward_fn=_killer(0, calls, ppo_parity.reward_fn),
                                      prompts=ppo_parity.PROMPTS, config=config, device="cpu")
    finally:
        del os.environ["TRLX_TPU_RESUME_FROM"]
    assert pinned.iter_count == 8 and calls.get("n", 0) == 0


def _load_verify_ckpt():
    import importlib.util

    spec = importlib.util.spec_from_file_location("verify_ckpt", os.path.join(REPO, "scripts", "verify_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flip(fp):
    with open(fp, "r+b") as f:
        f.seek(os.path.getsize(fp) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))


def test_checkpoint_layout_verify_ckpt_and_corruption(tmp_path, capsys):
    """An SFT run committing every step: the JAX package's verify_ckpt.py
    (unedited) reports each port checkpoint healthy; a bit flip in the
    newest one's state is quarantined by "auto", which resumes from the
    step before; a pinned corrupt checkpoint raises and stays in place;
    another architecture is refused before any state changes."""
    ckpts = tmp_path / "ckpts"
    config = _offline(default_sft_config, ckpts, 4, total_steps=2, checkpoint_interval=1, save_best=False)
    first = trlx_tpu_torch.train(samples=SFT_SAMPLES, config=config, device="cpu")
    assert first.iter_count == 2
    verify_ckpt = _load_verify_ckpt()
    for name in ("checkpoint_1", "checkpoint_2"):
        path = str(ckpts / name)
        assert sorted(os.listdir(path)) == ["COMMIT", "hf_model", "integrity.json", "state", "state.json",
                                            "topology.json"]
        assert sorted(os.listdir(os.path.join(path, "state"))) == ["model.pt", "optimizer.pt", "scheduler.pt"]
        assert verify_ckpt.check_one(path) == []
    assert verify_ckpt.main([str(ckpts)]) == 0
    assert "FAIL" not in capsys.readouterr().out

    _flip(str(ckpts / "checkpoint_2" / "state" / "model.pt"))
    pinned = str(ckpts / "checkpoint_2")
    with pytest.raises(CheckpointCorruptError):
        trlx_tpu_torch.train(samples=SFT_SAMPLES, device="cpu",
                             config=config.evolve(train=dict(total_steps=3, resume_from_checkpoint=pinned)))
    assert os.path.isdir(pinned)
    resumed = trlx_tpu_torch.train(samples=SFT_SAMPLES, device="cpu",
                                   config=config.evolve(train=dict(total_steps=3, resume_from_checkpoint="auto")))
    assert resumed.iter_count == 3
    names = os.listdir(ckpts)
    assert "checkpoint_2.corrupt" in names and "checkpoint_2" in names  # quarantined, then re-committed
    with open(ckpts / "logs" / "metrics.jsonl") as f:
        loss_steps = [r["_step"] for r in map(json.loads, f) if "losses/loss" in r]
    assert loss_steps == [1, 2, 2, 3]

    from trlx_tpu_torch.utils.loading import get_trainer

    other = _offline(default_sft_config, tmp_path / "other", 4).evolve(model=dict(model_extra_configs={
        "transformer": dict(vocab_size=258, hidden_size=16, n_layer=2, n_head=2, n_positions=64)}))
    trainer = get_trainer(other.train.trainer)(config=other, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    with pytest.raises(ValueError, match="ARCHITECTURE"):
        trainer.load(str(ckpts / "checkpoint_1"))
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())


def test_save_load_round_trip(tmp_path):
    """`save` then `load` into a fresh trainer: every tensor and the
    state.json scalars come back, as the trainer's own tensors."""
    config = _offline(default_sft_config, tmp_path / "ckpts", 4, total_steps=3)
    trainer = trlx_tpu_torch.train(samples=SFT_SAMPLES, config=config, device="cpu")
    trainer.best_reward, trainer.nth_evaluation = 1.5, 7
    trainer.save(str(tmp_path / "manual"))
    from trlx_tpu_torch.utils.loading import get_trainer

    fresh = get_trainer(config.train.trainer)(config=config, device="cpu")
    fresh.load(str(tmp_path / "manual"))
    want, got = _snapshot(trainer), _snapshot(fresh)
    _assert_snapshots_equal(got, want)
    assert (fresh.iter_count, fresh.best_reward, fresh.nth_evaluation) == (3, 1.5, 7)
    params = {p.data_ptr() for p in fresh.model.parameters()}
    assert all(t.data_ptr() in params for t in fresh.model.state_dict().values() if t.requires_grad)
    for st in fresh.optimizer.state.values():
        assert st["exp_avg"].device == fresh.device and st["step"].device.type == "cpu"
