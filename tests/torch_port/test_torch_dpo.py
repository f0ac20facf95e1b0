"""trlx_tpu_torch's DPO against the JAX package's, on the CPU (2 layers,
width 32, the byte tokenizer, fp32):

- `sequence_logprobs` and `dpo_loss`, with and without label smoothing:
  the loss and every stat to rtol 1e-5, the gradient against `jax.grad`,
  and no gradient into the reference;
- the configs: the same validation errors, the same default config;
- `DPOPairStorage`: collation exactly (ids, attention and response
  masks, one width for both sides), the loader order for two seeds
  exactly, the malformed triples raise the same errors;
- `trlx_tpu_torch.train(samples=triples)` against `trlx_tpu.train` from
  the same weights (the reference's per-step loop): the loss and `dpo/*`
  streams to rtol 1e-4, the greedy evaluations token for token, the
  reference bit for bit the initial policy;
- the port of `test_dpo_converges_on_separable_preferences`;
- `rewards` and seq2seq raise; `save_pretrained` -> `model_path=dir`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.data.default_configs import default_dpo_config as j_default_dpo_config
from trlx_tpu.data.method_configs import DPOConfig as JDPOConfig
from trlx_tpu.ops.dpo import dpo_loss as j_dpo_loss
from trlx_tpu.ops.dpo import sequence_logprobs as j_sequence_logprobs
from trlx_tpu.pipeline.dpo_pipeline import DPOPairStorage as JDPOPairStorage
from trlx_tpu.trainer import dpo as j_dpo
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.utils.tokenizers import ByteTokenizer as JByteTokenizer

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_dpo_config
from trlx_tpu_torch.data.method_configs import DPOConfig
from trlx_tpu_torch.models import wrappers
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.ops.dpo import dpo_loss, sequence_logprobs
from trlx_tpu_torch.pipeline.dpo_pipeline import DPOPairStorage
from trlx_tpu_torch.trainer import base as trainer_base
from trlx_tpu_torch.trainer import dpo
from trlx_tpu_torch.utils.loading import get_trainer
from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

DPO_STATS = ("losses/total_loss", "dpo/accuracy", "dpo/margin", "dpo/chosen_reward", "dpo/rejected_reward",
             "dpo/logprob_chosen", "dpo/logprob_rejected")


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1, 0.3])
def test_dpo_loss_and_grad_match_reference(label_smoothing):
    rng = np.random.default_rng(int(label_smoothing * 10))
    B, T, V = 6, 9, 13
    logits = rng.normal(0, 2, (2 * B, T, V)).astype(np.float32)
    ids = rng.integers(0, V, (2 * B, T))
    resp = (np.arange(T)[None] >= rng.integers(1, T - 2, (2 * B, 1))).astype(np.int32)
    ref_lp = rng.normal(-20, 3, 2 * B).astype(np.float32)

    logits_t = torch.from_numpy(logits).requires_grad_(True)
    ref_t = torch.from_numpy(ref_lp).requires_grad_(True)
    seq = sequence_logprobs(logits_t, torch.from_numpy(ids), torch.from_numpy(resp))
    loss, stats = dpo_loss(seq[:B], seq[B:], ref_t[:B], ref_t[B:], beta=0.5, label_smoothing=label_smoothing)
    loss.backward()

    def j_loss(x):
        s = j_sequence_logprobs(x, jnp.asarray(ids), jnp.asarray(resp))
        return j_dpo_loss(s[:B], s[B:], jnp.asarray(ref_lp[:B]), jnp.asarray(ref_lp[B:]), beta=0.5,
                          label_smoothing=label_smoothing)

    np.testing.assert_allclose(seq.detach().numpy(),
                               np.asarray(j_sequence_logprobs(jnp.asarray(logits), jnp.asarray(ids),
                                                              jnp.asarray(resp))), rtol=1e-5)
    (j_val, j_stats), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(logits))
    assert set(stats) == set(j_stats) == set(DPO_STATS)
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    for k in DPO_STATS:
        # the rewards difference summed logprobs near -20: an fp32 ulp there is 2e-6
        np.testing.assert_allclose(stats[k].item(), float(j_stats[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(logits_t.grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-6)
    assert ref_t.grad is None  # the reference enters detached


@pytest.mark.parametrize("kw", [dict(beta=0.0), dict(beta=-1.0), dict(label_smoothing=0.5),
                                dict(label_smoothing=-0.1)])
def test_dpo_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as ours:
        DPOConfig(name="d", **kw)
    with pytest.raises(ValueError) as ref:
        JDPOConfig(name="d", **kw)
    assert str(ours.value) == str(ref.value)


def test_default_dpo_config_matches_reference():
    got = default_dpo_config().to_dict()
    assert got == j_default_dpo_config().to_dict()
    assert got["train"]["trainer"] == "TPUDPOTrainer" and got["method"]["name"] == "dpoconfig"


PAIRS = [
    ("the", "aaaa", "zzzz"),
    ("a longer prompt", " yes", " no, not at all"),
    ("", "x", "yy"),
    ("q", "chosen<|eos|>", "rejected"),  # already ends with EOS: nothing appended
    ("twenty-one characters", " kept", " also kept, cut"),
    ("hi", " a", " b"),
    ("go", "ok", "no"),
]


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("max_length", [24, 30, 64])
def test_pair_storage_collation_matches_reference(side, max_length):
    store = DPOPairStorage(PAIRS, ByteTokenizer(truncation_side=side), max_length)
    jstore = JDPOPairStorage(PAIRS, JByteTokenizer(truncation_side=side), max_length)
    assert store.seq_width == jstore.seq_width and len(store) == len(jstore) == len(PAIRS)
    got, want = store.collate(list(store.history)), jstore.collate(list(jstore.history))
    for name in ("chosen_ids", "chosen_attention_mask", "chosen_response_mask", "rejected_ids",
                 "rejected_attention_mask", "rejected_response_mask"):
        x = getattr(got, name)
        assert x.dtype == torch.int32 and x.shape == (len(PAIRS), store.seq_width)
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert (got.chosen_response_mask.sum(1) > 0).all() and (got.rejected_response_mask.sum(1) > 0).all()


@pytest.mark.parametrize("seed", [0, 11])
def test_pair_storage_loader_order_matches_reference(seed):
    """Two epochs of one shuffled loader, the ragged tail dropped."""
    pairs = [(chr(97 + i), "a" * (1 + i % 3), "z" * (1 + i % 4)) for i in range(11)]
    store, jstore = DPOPairStorage(pairs, ByteTokenizer(), 16), JDPOPairStorage(pairs, JByteTokenizer(), 16)
    loader, jloader = store.create_loader(4, seed=seed), jstore.create_loader(4, seed=seed)
    for _ in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.chosen_ids.numpy(), np.asarray(b.chosen_ids))
            np.testing.assert_array_equal(a.rejected_response_mask.numpy(), np.asarray(b.rejected_response_mask))


@pytest.mark.parametrize("pairs, max_length", [
    ([("p", "c", "r"), ("p", "c")], 16),  # not a triple
    ([("p", "c", "r", "x")], 16),
    ([], 16),  # no pair at all
    ([("a prompt that fills the budget", "c", "r")], 8),  # the completion is cut to zero tokens
])
def test_pair_storage_rejects_malformed_samples(pairs, max_length):
    with pytest.raises(ValueError) as ours:
        DPOPairStorage(pairs, ByteTokenizer(), max_length)
    with pytest.raises(ValueError) as ref:
        JDPOPairStorage(pairs, JByteTokenizer(), max_length)
    assert str(ours.value) == str(ref.value)


# a separable preference set (tests/test_dpo.py): chosen completions are runs
# of one byte, rejected of another
SEPARABLE_PAIRS = [(p, "aaaa", "zzzz") for p in ("the", "a b", "go", "ok", "hi", "q", "xy", "meh")] * 2
MIXED_PAIRS = [(p, c, r) for p, c, r in zip(("the", "a b", "go", "ok", "hi", "q", "xy", "meh") * 2,
                                            ["aaaa", "ab", "b", "aaab"] * 4, ["zzzz", "zy", "zzz", "y"] * 4)]


def _config(tmp_path, **train):
    return j_default_dpo_config().evolve(
        train=dict(dict(batch_size=8, total_steps=6, eval_interval=3, checkpoint_interval=1000, seq_length=16,
                        epochs=100, tracker=None, compute_dtype="float32", fused_inner_loop=False,
                        checkpoint_dir=str(tmp_path / "ckpts"), seed=2), **train),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={
            "transformer": dict(vocab_size=258, hidden_size=32, n_layer=2, n_head=2, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(kwargs=dict(lr=5e-3)),
        scheduler=dict(kwargs=dict(eta_min=5e-3)),
        method=dict(beta=0.5, label_smoothing=0.1, gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
    )


def _capture_evals(mp, cls, store):
    generate_eval = cls.generate_eval

    def recorded(self, *args, **kwargs):
        out = generate_eval(self, *args, **kwargs)
        store.append(np.asarray(out["sequences"]))
        return out

    mp.setattr(cls, "generate_eval", recorded)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """`trlx_tpu.train` and `trlx_tpu_torch.train` on the same config and
    pairs from the same weights: (reference trainer, its init, its stats,
    its evaluations, the port's trainer, its evaluations)."""
    jconfig = _config(tmp_path_factory.mktemp("dpo"))
    init, j_stats, j_evals, evals = {}, [], [], []
    setup = j_dpo.TPUDPOTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_dpo.TPUDPOTrainer, "setup_model", capture_setup)
        mp.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: j_stats.append((step, dict(st))))
        mp.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
        _capture_evals(mp, JBaseTrainer, j_evals)
        ref = trlx_tpu.train(samples=MIXED_PAIRS, config=jconfig)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wrappers.CausalLM, "init_params",
                   lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self)
        _capture_evals(mp, trainer_base.TPUBaseTrainer, evals)
        ours = trlx_tpu_torch.train(samples=MIXED_PAIRS, config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu")
    return ref, init, j_stats, j_evals, ours, evals


@pytest.mark.parametrize("key", DPO_STATS)
def test_train_streams_match_reference(train_runs, key):
    ref, _, j_stats, _, ours, _ = train_runs
    assert isinstance(ours, dpo.TPUDPOTrainer)
    assert ours.iter_count == ref.iter_count == 6
    want = [(s, float(st[key])) for s, st in j_stats if key in st]
    got = [(s, float(st[key])) for s, st in ours.stats_history if key in st]
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 7))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-6)


def test_train_evals_match_and_reference_stays_frozen(train_runs):
    """The greedy evaluations (before the first step, at step 3, at the end)
    token for token; the port's reference bit for bit the initial policy
    while the policy moved."""
    _, init, _, j_evals, ours, evals = train_runs
    assert len(evals) == len(j_evals) == 3
    for a, b in zip(evals, j_evals):
        np.testing.assert_array_equal(a, b)
    start = params_from_jax(init, ours.model.cfg)
    for name, p in ours.ref_params.named_parameters():
        assert not p.requires_grad and torch.equal(p, start["base." + name]), name
    assert all(not torch.equal(p.detach(), start[n]) for n, p in ours.model.named_parameters())


def test_dpo_converges_on_separable_preferences(tmp_path):
    """tests/test_dpo.py's acceptance through the port: the final accuracy
    above 0.9, the margin grew, the reference bit for bit a fresh trainer's
    initial policy while the policy moved."""
    config = TRLConfig.from_dict(_config(tmp_path, total_steps=24, eval_interval=1000).to_dict()).evolve(
        method=dict(label_smoothing=0.0))
    trainer = trlx_tpu_torch.train(samples=SEPARABLE_PAIRS, config=config, device="cpu")
    assert trainer.iter_count == 24
    accs = [st["dpo/accuracy"] for _, st in trainer.stats_history if "dpo/accuracy" in st]
    margins = [st["dpo/margin"] for _, st in trainer.stats_history if "dpo/margin" in st]
    assert accs[-1] > 0.9 and margins[-1] > margins[0]
    fresh = get_trainer(config.train.trainer)(config=config, device="cpu")
    for (name, r), (_, p) in zip(trainer.ref_params.named_parameters(), fresh.model.base.named_parameters()):
        assert torch.equal(r, p), name
    assert any(not torch.equal(a, b) for a, b in zip(trainer.model.base.parameters(), trainer.ref_params.parameters()))


def test_save_pretrained_round_trip(tmp_path):
    config = TRLConfig.from_dict(_config(tmp_path, total_steps=2).to_dict())
    trainer = trlx_tpu_torch.train(samples=MIXED_PAIRS, config=config, device="cpu")
    directory = str(tmp_path / "saved")
    trainer.save_pretrained(directory)
    assert not os.path.exists(os.path.join(directory, "aux_weights.pt"))  # the base alone
    reloaded = get_trainer("TPUDPOTrainer")(config=config.evolve(model=dict(model_path=directory)), device="cpu")
    want = trainer.model.state_dict()
    for states in (reloaded.model.state_dict(), {"base." + k: v for k, v in reloaded.ref_params.state_dict().items()}):
        assert set(states) == set(want)
        for k, t in want.items():
            assert torch.equal(states[k], t), k


@pytest.mark.parametrize("name", ["TPUDPOTrainer", "AccelerateDPOTrainer"])
def test_registry_rewards_and_seq2seq(tmp_path, name):
    assert get_trainer(name) is dpo.TPUDPOTrainer
    config = TRLConfig.from_dict(_config(tmp_path).to_dict()).evolve(train=dict(trainer=name))
    with pytest.raises(ValueError, match="preference ordering"):
        trlx_tpu_torch.train(samples=MIXED_PAIRS, rewards=[1.0] * len(MIXED_PAIRS), config=config, device="cpu")
    config = config.evolve(model=dict(model_arch_type="seq2seq", model_extra_configs={"seq2seq": dict(
        d_model=16, n_layer=1, n_head=2, d_kv=8, d_ff=32, vocab_size=258)}))
    with pytest.raises(NotImplementedError, match="seq2seq DPO is not implemented"):
        get_trainer(name)(config=config, device="cpu")
