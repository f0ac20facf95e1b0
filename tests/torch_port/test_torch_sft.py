"""trlx_tpu_torch's SFT slice against the JAX package's, on the CPU:

- `tokenize_dialogue` and `DialogStore` exactly (ids, labels, masks) for
  strings, (prompt, output) pairs and multi-turn dialogues, both
  truncation sides, and the store loader's shuffled order at several
  seeds (with the short last batch);
- `sft_loss` and `sft_loss_from_hidden` within 1e-6;
- `trlx_tpu_torch.train(samples=...)` against `trlx_tpu.train(samples=...)`
  from the same weights (the reference trainer's own init, converted), on
  a tiny fp32 config, the reference's per-step loop (its fused scan
  disagrees with it, ROADMAP queue 3 caveat 1): the loss stream to rtol
  1e-4, the final parameters to the AdamW tolerance of ROADMAP queue 3
  item 4 (every element within steps x lr, all but one in a thousand to
  2e-6), and the greedy eval samples token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.pipeline.offline_pipeline import DialogStore as JDialogStore
from trlx_tpu.pipeline.offline_pipeline import tokenize_dialogue as j_tokenize_dialogue
from trlx_tpu.trainer import sft as j_sft
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.utils.tokenizers import ByteTokenizer as JByteTokenizer

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.models import lora, wrappers
from trlx_tpu_torch.models.convert import lm_state_dict_from_jax
from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, tokenize_dialogue
from trlx_tpu_torch.trainer import base as trainer_base
from trlx_tpu_torch.trainer.sft import sft_loss, sft_loss_from_hidden
from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

DIALOGUES = [
    "hello world",
    "",
    ("the cat", " sat on the mat"),
    ("q:", " a", " q2:", " b"),
    ("prompt", " done<|eos|>"),  # already ends with EOS: nothing appended
    ("a long prompt that will not fit", " and its output"),
    ("x", " an output longer than the whole budget"),
    ("", " output first"),
]


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("max_length", [4, 9, 16, 64])
def test_tokenize_dialogue_and_store_match_reference(side, max_length):
    tok, jtok = ByteTokenizer(truncation_side=side), JByteTokenizer(truncation_side=side)
    dialogs, jdialogs = [], []
    for d in DIALOGUES:
        got, want = tokenize_dialogue(d, tok, max_length), j_tokenize_dialogue(d, jtok, max_length)
        assert [(m.is_output, m.tokens) for m in got] == [(m.is_output, m.tokens) for m in want], d
        dialogs.append(got)
        jdialogs.append(want)
    store, jstore = DialogStore(dialogs, tok, max_length), JDialogStore(jdialogs, jtok, max_length)
    assert len(store) == len(jstore) == len(DIALOGUES)
    batch, jbatch = store.collate([store[i] for i in range(len(store))]), jstore.collate(list(jstore.history))
    for name in ("input_ids", "attention_mask", "labels"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), getattr(jbatch, name), err_msg=name)
    assert batch.input_ids.shape == (len(DIALOGUES), max_length)


@pytest.mark.parametrize("seed", [0, 1, 1005])
def test_store_loader_order_matches_reference(seed):
    """The shuffled loader's batches, the short last one included (11
    dialogues in batches of 4), for the first and a second epoch of one
    loader."""
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    samples = [(chr(97 + i), "xyz"[: 1 + i % 3]) for i in range(11)]
    store = DialogStore([tokenize_dialogue(s, tok, 8) for s in samples], tok, 8)
    jstore = JDialogStore([j_tokenize_dialogue(s, jtok, 8) for s in samples], jtok, 8)
    loader, jloader = store.create_loader(4, shuffle=True, seed=seed), jstore.create_loader(4, shuffle=True, seed=seed)
    for _ in range(2):
        got, want = list(loader), list(jloader)
        assert [len(b.input_ids) for b in got] == [len(b.input_ids) for b in want] == [4, 4, 3]
        for b, jb in zip(got, want):
            for name in ("input_ids", "attention_mask", "labels"):
                np.testing.assert_array_equal(getattr(b, name).numpy(), getattr(jb, name))


def _loss_inputs(seed=0, B=3, T=7, V=11, E=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, V, size=(B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 0.4] = -100
    labels[2] = -100  # a row with no counted token
    hidden = rng.normal(size=(B, T, E)).astype(np.float32)
    wte = rng.normal(size=(V, E)).astype(np.float32)
    return labels, hidden, wte


def test_sft_loss_matches_reference():
    labels, hidden, wte = _loss_inputs()
    logits = hidden @ wte.T
    loss, stats = sft_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    j_loss, j_stats = j_sft.sft_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-6, rtol=0)
    assert set(stats) == set(j_stats)
    for key in stats:
        np.testing.assert_allclose(stats[key].item(), float(j_stats[key]), atol=1e-6, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_sft_loss_from_hidden_matches_reference(n_chunks):
    labels, hidden, wte = _loss_inputs(seed=1)
    w = torch.from_numpy(wte)
    loss, stats = sft_loss_from_hidden(torch.from_numpy(hidden), lambda h: h @ w.t(), torch.from_numpy(labels),
                                       n_chunks)
    j_loss, _ = j_sft.sft_loss_from_hidden(jnp.asarray(hidden), lambda h: h @ jnp.asarray(wte).T,
                                           jnp.asarray(labels), n_chunks)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-6, rtol=0)
    full, _ = sft_loss(torch.from_numpy(hidden @ wte.T), torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), full.item(), atol=1e-6, rtol=0)
    assert stats["perplexity"].item() == pytest.approx(np.exp(loss.item()), rel=1e-6)


SAMPLES = [("the cat", " sat"), ("a dog", " ran far"), "hello there", ("x", " y", " z", " w"),
           ("one", " two"), ("three", " four five"), "six seven", ("eight", " nine"),
           ("ten", " eleven"), ("twelve", " thirteen"), ("fourteen", " fifteen"), "sixteen"] * 2
# 24 samples: an epoch is a batch of 16 and a short one of 8 (the
# reference's mesh of 8 CPU devices takes whole multiples of 8 rows)
LR, STEPS = 1e-4, 5


def _config(tmp_path):
    return j_default_sft_config().evolve(
        train=dict(batch_size=16, total_steps=STEPS, eval_interval=3, checkpoint_interval=100, seq_length=16,
                   epochs=10, tracker=None, compute_dtype="float32", fused_inner_loop=False,
                   checkpoint_dir=str(tmp_path / "ckpts"), seed=7),
        model=dict(model_path="random", model_extra_configs={
            "transformer": dict(hidden_size=32, n_layer=2, n_head=2, n_positions=64)
        }),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=LR, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-2)),
        method=dict(gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
    )


def _capture_evals(monkeypatch, cls, store):
    generate_eval = cls.generate_eval

    def recorded(self, *args, **kwargs):
        out = generate_eval(self, *args, **kwargs)
        store.append(np.asarray(out["sequences"]))
        return out

    monkeypatch.setattr(cls, "generate_eval", recorded)


def test_train_samples_matches_reference(tmp_path, monkeypatch):
    jconfig = _config(tmp_path)
    init, j_stats, j_evals, evals = {}, [], [], []
    setup = j_sft.TPUSFTTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    monkeypatch.setattr(j_sft.TPUSFTTrainer, "setup_model", capture_setup)
    monkeypatch.setattr(JBaseTrainer, "_tracker_log", lambda self, stats, step: j_stats.append((step, dict(stats))))
    monkeypatch.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
    _capture_evals(monkeypatch, JBaseTrainer, j_evals)
    ref = trlx_tpu.train(samples=SAMPLES, config=jconfig)

    monkeypatch.setattr(
        wrappers.CausalLM, "init_params",
        lambda self, gen: self.base.load_state_dict(lm_state_dict_from_jax(init["base"], self.cfg)) and self,
    )
    _capture_evals(monkeypatch, trainer_base.TPUBaseTrainer, evals)
    ours = trlx_tpu_torch.train(samples=SAMPLES, config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu")
    assert ours.iter_count == ref.iter_count == STEPS

    def losses(stream):
        return [(step, float(s["losses/loss"])) for step, s in stream if "losses/loss" in s]

    want, got = losses(j_stats), losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=0)
    perplexity = [s["perplexity"] for _, s in ours.stats_history if "perplexity" in s]
    np.testing.assert_allclose(perplexity, np.exp([v for _, v in got]), rtol=1e-6)

    # the evaluations: before the first step, at step 3, at the end
    assert len(evals) == len(j_evals) == 3
    for a, b in zip(evals, j_evals):
        np.testing.assert_array_equal(a, b)

    start = lm_state_dict_from_jax(init["base"], ours.model.cfg)
    want_params = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref.params["base"]), ours.model.cfg)
    for name, p in ours.model.base.named_parameters():
        assert not torch.equal(p.detach(), start[name]), f"{name} did not move"
        diff = (p.detach() - want_params[name]).abs()
        assert diff.max().item() <= STEPS * LR, name
        if not name.endswith("attn.k.bias"):
            assert (diff > 2e-6).float().mean().item() <= 1e-3, name


def test_default_sft_config_matches():
    assert default_sft_config().to_dict() == j_default_sft_config().to_dict()


def _tiny_sft_config(tmp_path, **train):
    return default_sft_config().evolve(
        train=dict(dict(batch_size=2, total_steps=2, seq_length=8, epochs=1, checkpoint_dir=str(tmp_path)), **train),
        model=dict(model_path="random", model_extra_configs={
            "transformer": dict(hidden_size=16, n_layer=1, n_head=2, n_positions=32)
        }),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(gen_kwargs=dict(max_new_tokens=2)),
    )


def test_sft_epochs_and_short_last_batch(tmp_path):
    """total_steps = min(epochs x full batches, train.total_steps); the
    short last batch of an epoch is a step of its own (5 samples in
    batches of 2: 2 + 2 + 1); the eval prompts default to BOS x
    batch_size."""
    trainer = trlx_tpu_torch.train(samples=["ab", "cd", "ef", "gh", "ij"],
                                   config=_tiny_sft_config(tmp_path, epochs=2, total_steps=100), device="cpu")
    assert trainer.total_steps == 4  # 2 epochs x 2 full batches
    assert trainer.iter_count == 4
    assert [len(b.input_ids) for b in trainer.create_train_dataloader()] == [2, 2, 1]
    assert [p["input_ids"] for p in trainer.eval_pipeline.prompts] == [[256], [256]]


def test_sft_knobs_that_raise(tmp_path):
    """Seq2seq SFT raises as in the reference, with a prompt-tuning adapter
    too (seq2seq takes LoRA only there); SFT with LoRA runs, training the
    adapter over a frozen base."""
    seq2seq = dict(model_arch_type="seq2seq", model_extra_configs={
        "seq2seq": dict(d_model=16, n_layer=1, n_head=2, d_kv=8, d_ff=32)})
    config = _tiny_sft_config(tmp_path).evolve(model=seq2seq)
    with pytest.raises(NotImplementedError, match="seq2seq SFT"):
        trlx_tpu_torch.train(samples=["ab"], config=config, device="cpu")
    config = _tiny_sft_config(tmp_path).evolve(model=dict(seq2seq, peft_config={"peft_type": "PROMPT_TUNING"}))
    with pytest.raises(NotImplementedError, match="seq2seq"):
        trlx_tpu_torch.train(samples=["ab"], config=config, device="cpu")
    config = _tiny_sft_config(tmp_path).evolve(model=dict(peft_config={"peft_type": "LORA"}))
    trainer = trlx_tpu_torch.train(samples=["ab", "cd", "ef", "gh"], config=config, device="cpu")
    assert trainer.iter_count == 2
    trained = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
    assert trained and all(n.startswith("lora.") for n in trained)
    assert not any(p.requires_grad for p in trainer.model.base.parameters())
    # the trainer's own random init drew A ~ N(0, 0.02) and B = 0, and both
    # trained: every B moved off zero (lr 1e-4 x 2 steps leaves A's std)
    pairs = dict(lora.pairs(trainer.model.lora))
    assert pairs and all(bool(pair.b.detach().ne(0).any()) for pair in pairs.values())
    a_std = float(torch.cat([pair.a.detach().flatten() for pair in pairs.values()]).std())
    assert 0.015 < a_std < 0.025, a_std
    with pytest.raises(ValueError, match="samples"):
        trlx_tpu_torch.train(config=_tiny_sft_config(tmp_path), device="cpu")


def test_randomwalks_copy_matches_reference():
    """The port's copy of the randomwalks task: the same graph, walks, eval
    prompts and metric values as the JAX example at seed 1002, and the
    same SFT gold corpus."""
    from examples.randomwalks import generate_random_walks as j_generate
    from examples.randomwalks.sft_randomwalks import optimal_walks as j_optimal_walks

    from trlx_tpu_torch.examples.randomwalks import generate_random_walks
    from trlx_tpu_torch.examples.sft_randomwalks import optimal_walks

    metric_fn, prompts, walks, adj = generate_random_walks(seed=1002)
    j_metric_fn, j_prompts, j_walks, j_adj = j_generate(seed=1002)
    np.testing.assert_array_equal(adj, j_adj)
    assert walks == j_walks and prompts == j_prompts
    assert optimal_walks(adj) == j_optimal_walks(j_adj)
    samples = walks[:50] + optimal_walks(adj) + ["ab", "zz", "", "b", "bxa"]
    assert metric_fn(samples) == j_metric_fn(samples)


def test_randomwalks_bc_warmup_matches_reference(tmp_path, monkeypatch):
    """The PPO runner's behaviour cloning (200 SFT steps over the 1000-walk
    corpus, batch 96 with a short last batch of 40 an epoch) through
    `trlx_tpu_torch.train` against the JAX example's, from the same
    weights in fp32 on the reference's per-step loop: the loss stream to
    rtol 1e-5 and every parameter within 1e-4 after all 200 steps (measured
    5.6e-7 and 2.3e-5 on one CPU device)."""
    from examples.randomwalks import ppo_randomwalks as j_example
    from trlx_tpu.data.configs import TRLConfig as JTRLConfig
    from trlx_tpu.data.method_configs import SFTConfig as JSFTConfig

    from trlx_tpu_torch.examples.randomwalks import generate_random_walks

    _, _, walks, _ = generate_random_walks(seed=1000)
    jconfig = JTRLConfig.from_dict(dict(
        j_example.default_config.to_dict(),
        method=JSFTConfig(name="sftconfig", gen_kwargs=dict(max_new_tokens=9)).to_dict(),
    )).evolve(train=dict(trainer="TPUSFTTrainer", total_steps=200, epochs=40, eval_interval=1000,
                         checkpoint_interval=1000, checkpoint_dir=str(tmp_path / "ckpts"),
                         compute_dtype="float32", fused_inner_loop=False))
    init, j_stats = {}, []
    setup = j_sft.TPUSFTTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    monkeypatch.setattr(j_sft.TPUSFTTrainer, "setup_model", capture_setup)
    monkeypatch.setattr(JBaseTrainer, "_tracker_log", lambda self, stats, step: j_stats.append((step, dict(stats))))
    monkeypatch.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
    samples = [(w[0], w[1:]) for w in walks]
    ref = trlx_tpu.train(samples=samples, config=jconfig)

    monkeypatch.setattr(
        wrappers.CausalLM, "init_params",
        lambda self, gen: self.base.load_state_dict(lm_state_dict_from_jax(init["base"], self.cfg)) and self,
    )
    ours = trlx_tpu_torch.train(samples=samples, config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu")
    want = [float(s["losses/loss"]) for _, s in j_stats if "losses/loss" in s]
    got = [s["losses/loss"] for _, s in ours.stats_history if "losses/loss" in s]
    assert len(got) == len(want) == ours.iter_count == 200
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    final = lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref.params["base"]), ours.model.cfg)
    for name, p in ours.model.base.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(), atol=1e-4, rtol=0, err_msg=name)
