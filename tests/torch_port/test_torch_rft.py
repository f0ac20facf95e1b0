"""trlx_tpu_torch's RFT against the JAX package's, on the CPU:

- `compute_thresholds` exactly, the all-equal-scores cases of the
  reference's own test included;
- one improve round from injected samples and scores: the decoded
  generations, the per-prompt pool, the selection, its logged stats and
  the wrap-padded store, exactly; and a reselection round (no sampling)
  at the next epoch's percentile;
- `trlx_tpu_torch.train(reward_fn=..., prompts=...)` with
  `train.trainer="TPURFTTrainer"` against `trlx_tpu.train` from the same
  weights, greedy: the loss stream to rtol 1e-4, the selection stats, and
  the greedy evaluations token for token."""

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.data.configs import TRLConfig as JTRLConfig
from trlx_tpu.trainer import rft as j_rft
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.utils.loading import get_trainer as j_get_trainer

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import wrappers
from trlx_tpu_torch.models.convert import lm_state_dict_from_jax
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer import base as trainer_base
from trlx_tpu_torch.trainer import rft
from trlx_tpu_torch.utils.loading import get_trainer

SCORES = [
    [[1.0, 1.0], [1.0, 1.0]],  # every score equal: keep everything
    [[1.0, 1.0, 1.0], [0.0, 2.0, 4.0]],  # a constant prompt beside a spread one
    [[0.0, 1.0, 2.0], [0.0, 2.0, 4.0]],
    [[0.3, -1.2, 5.0, 5.0, 0.3], [2.0], [-3.0, -3.0, 7.5, 0.0]],
]


@pytest.mark.parametrize("percentile", [0.0, 0.5, 0.9, 0.95, 1.0])
@pytest.mark.parametrize("case", range(len(SCORES)))
def test_compute_thresholds_matches_reference(case, percentile):
    got = rft.compute_thresholds(SCORES[case], percentile)
    np.testing.assert_array_equal(got, j_rft.compute_thresholds(SCORES[case], percentile))
    assert all(t <= max(s) for t, s in zip(got, SCORES[case]))  # each prompt's best survives


PROMPTS = ["ab", "cd", "efg", "h", "ij", "kl", "mno", "p"]


def reward_fn(samples, prompts, outputs, **kw):
    return [float(sum(c in "aeiou" for c in o)) - 0.1 * len(o) for o in outputs]


def _config(tmp_path, **method):
    return JTRLConfig.from_dict(dict(
        train=dict(seq_length=12, epochs=10, total_steps=6, batch_size=8, checkpoint_interval=100, eval_interval=3,
                   pipeline="PromptPipeline", trainer="TPURFTTrainer", tracker=None, compute_dtype="float32",
                   checkpoint_dir=str(tmp_path / "ckpts"), seed=4),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={
            "transformer": dict(vocab_size=258, hidden_size=32, n_layer=2, n_head=2, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte", truncation_side="right"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=1000, eta_min=1e-3)),
        method=dict(dict(name="rftconfig", n_generations_per_prompt=2, start_percentile=0.5, end_percentile=0.9,
                         n_improve_steps=2, gen_kwargs=dict(max_new_tokens=4, do_sample=False)), **method),
    ))


def test_improve_round_matches_reference(tmp_path, monkeypatch):
    """Both trainers sample the same injected tokens (three generations of
    each of the eight prompts, some ending on EOS), score them with the
    same reward, then select; at epoch 1 they reselect without sampling."""
    jconfig = _config(tmp_path, n_generations_per_prompt=3)
    rng = np.random.default_rng(0)
    P, N = 12 - 4, 4
    # left-padded prompts then 4 sampled letters; every other row ends on EOS
    pipeline = PromptPipeline(PROMPTS, P, trainer_base.load_tokenizer(TRLConfig.from_dict(jconfig.to_dict()).tokenizer))
    batch = pipeline.collate([pipeline[i] for i in range(len(PROMPTS))])
    draws = [rng.integers(97, 103, size=(len(PROMPTS), N)) for _ in range(3)]
    for d in draws:
        d[::2, -1] = 257  # the byte tokenizer's EOS
    outputs = [np.concatenate([batch.input_ids.numpy(), d], axis=1) for d in draws]

    def fake_generate(calls):
        def gen(self, input_ids, attention_mask=None, **kw):
            out = outputs[len(calls) % 3]
            calls.append(1)
            return {"sequences": torch.from_numpy(out) if isinstance(self, trainer_base.TPUBaseTrainer) else out}
        return gen

    j_stats, stats = [], []
    monkeypatch.setattr(JBaseTrainer, "generate", fake_generate([]))
    monkeypatch.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: j_stats.append((step, dict(st))))
    monkeypatch.setattr(trainer_base.TPUBaseTrainer, "generate", fake_generate([]))
    ref = j_get_trainer("TPURFTTrainer")(config=jconfig, reward_fn=reward_fn)
    ours = get_trainer("TPURFTTrainer")(config=TRLConfig.from_dict(jconfig.to_dict()), reward_fn=reward_fn,
                                        device="cpu")
    monkeypatch.setattr(trainer_base.TPUBaseTrainer, "_log_stats", lambda self, st, step: stats.append((step, st)))
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline

    ref.add_prompt_pipeline(JPromptPipeline(PROMPTS, P, ref.tokenizer))
    ours.add_prompt_pipeline(pipeline)
    for epoch in (0, 1):
        ref.epoch_count = ours.epoch_count = epoch
        ref.make_experience()
        ours.make_experience()
        assert dict(ours.generations_per_prompt) == dict(ref.generations_per_prompt)
        assert len(ours.store) == len(ref.store) and len(ours.store) % 8 == 0
        got = ours.store.collate([ours.store[i] for i in range(len(ours.store))])
        want = ref.store.collate([ref.store[i] for i in range(len(ref.store))])
        for name in ("input_ids", "attention_mask", "labels"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert sum(len(v) for v in ours.generations_per_prompt.values()) == 3 * len(PROMPTS)
    assert [(s, {k: float(v) for k, v in st.items()}) for s, st in stats] == [
        (s, {k: float(v) for k, v in st.items()}) for s, st in j_stats]
    assert stats[0][1]["percentile"] == 0.5 and stats[1][1]["percentile"] == pytest.approx(0.7)


def test_train_rft_matches_reference(tmp_path, monkeypatch):
    jconfig = _config(tmp_path)
    init, j_stats, j_evals, evals = {}, [], [], []
    setup = j_rft.TPURFTTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    def capture(cls, store):
        generate_eval = cls.generate_eval

        def recorded(self, *args, **kwargs):
            out = generate_eval(self, *args, **kwargs)
            store.append(np.asarray(out["sequences"]))
            return out

        monkeypatch.setattr(cls, "generate_eval", recorded)

    monkeypatch.setattr(j_rft.TPURFTTrainer, "setup_model", capture_setup)
    monkeypatch.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: j_stats.append((step, dict(st))))
    monkeypatch.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
    capture(JBaseTrainer, j_evals)
    ref = trlx_tpu.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS, config=jconfig)

    monkeypatch.setattr(wrappers.CausalLM, "init_params",
                        lambda self, gen: self.base.load_state_dict(lm_state_dict_from_jax(init["base"], self.cfg))
                        and self)
    capture(trainer_base.TPUBaseTrainer, evals)
    ours = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS,
                                config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu")
    assert isinstance(ours, rft.TPURFTTrainer)
    assert ours.iter_count == ref.iter_count == 6

    def stream(history, key):
        return [(step, float(s[key])) for step, s in history if key in s]

    want, got = stream(j_stats, "losses/loss"), stream(ours.stats_history, "losses/loss")
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 7))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=0)
    for key in ("len_samples_selected", "percentile", "scores_mean"):
        assert stream(ours.stats_history, key) == pytest.approx(stream(j_stats, key), rel=1e-9), key
    assert len(evals) == len(j_evals) == 3
    for a, b in zip(evals, j_evals):
        np.testing.assert_array_equal(a, b)


def test_rft_registry_and_seq2seq(tmp_path):
    assert get_trainer("AccelerateRFTTrainer") is rft.TPURFTTrainer
    assert get_trainer("TPURFTTrainer") is rft.TPURFTTrainer
    config = TRLConfig.from_dict(_config(tmp_path).to_dict()).evolve(model=dict(
        model_arch_type="seq2seq", model_extra_configs={"seq2seq": dict(d_model=16, n_layer=1, n_head=2, d_kv=8,
                                                                         d_ff=32, vocab_size=258)}))
    with pytest.raises(NotImplementedError, match="seq2seq RFT"):
        get_trainer("TPURFTTrainer")(config=config, device="cpu")
