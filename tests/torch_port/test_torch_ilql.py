"""trlx_tpu_torch's offline ILQL against the JAX package's, on the CPU:

- `ilql_loss` and its stats (one and two Q heads) against
  `trlx_tpu.ops.ilql.ilql_loss`, fp32 atol 1e-5, and against the committed
  `tests/golden/ilql.npz`; `ilql_shape_logits` to 1e-5;
- `make_experience` / `make_experience_seq2seq`: ids, indices, dones and
  masks exactly, rewards to 1e-12; the stores' collation and shuffled
  loader order exactly, at three seeds;
- the ILQL wrappers' forward (causal and T5), 1e-5, and the Polyak sync;
- `trlx_tpu_torch.train(samples=..., rewards=...)` against
  `trlx_tpu.train` from the same weights (causal and seq2seq): the loss
  stream to rtol 1e-4, the target heads after the run to 1e-5, and the
  greedy beta-swept evaluations token for token;
- the processor contract: under `method.gen_engine.enabled` ILQL samples
  on the static sampler, `generate(beta=[0, 1])` raises TypeError, an
  undeclared kwarg raises; `save_pretrained` -> `model_path=dir`
  restores the heads bit for bit; the registry's aliases and
  `train(dataset=...)`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.data import ILQLBatch as JILQLBatch
from trlx_tpu.data import ILQLSeq2SeqBatch as JILQLSeq2SeqBatch
from trlx_tpu.data.default_configs import default_ilql_config as j_default_ilql_config
from trlx_tpu.models import seq2seq as jseq
from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.wrappers import CausalLMWithILQLHeads as JCausalILQL
from trlx_tpu.models.wrappers import Seq2SeqLMWithILQLHeads as JSeq2SeqILQL
from trlx_tpu.ops import ilql as j_ilql
from trlx_tpu.trainer import ilql as j_trainer
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.utils.tokenizers import ByteTokenizer as JByteTokenizer

import trlx_tpu_torch
from trlx_tpu_torch.data import ILQLBatch, ILQLSeq2SeqBatch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.models import seq2seq, wrappers
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.transformer import TransformerConfig
from trlx_tpu_torch.ops.ilql import ilql_loss, ilql_shape_logits
from trlx_tpu_torch.trainer import base as trainer_base
from trlx_tpu_torch.trainer import ilql
from trlx_tpu_torch.utils.loading import get_trainer
from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(__file__)), "golden", "ilql.npz")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _loss_inputs(seed, two_qs, seq2seq_batch=False, B=4, A=6, V=30):
    """Random logits, Q, target Q and V, and a batch whose rows end at
    different lengths (padded actions repeat the last index, as the stores
    pad them)."""
    rng = np.random.default_rng(seed)
    n = 2 if two_qs else 1
    S = A + 1
    lens = rng.integers(2, A + 1, size=B)
    actions = np.stack([np.minimum(np.arange(A), n_a - 1) for n_a in lens]).astype(np.int32)
    states = np.stack([np.minimum(np.arange(S), n_a) for n_a in lens]).astype(np.int32)
    dones = np.stack([(np.arange(S) < n_a).astype(np.int32) for n_a in lens])
    rewards = (rng.random((B, A)) > 0.7).astype(np.float32) * rng.normal(size=(B, A)).astype(np.float32)
    fields = dict(attention_mask=np.ones((B, A + 2), np.int32), rewards=rewards, states_ixs=states,
                  actions_ixs=actions, dones=dones)
    if seq2seq_batch:
        fields.update(input_ids=rng.integers(0, V, size=(B, 5)).astype(np.int32),
                      decoder_input_ids=rng.integers(0, V, size=(B, A + 1)).astype(np.int32))
        fields["attention_mask"] = np.ones((B, 5), np.int32)
    else:
        fields["input_ids"] = rng.integers(0, V, size=(B, A + 2)).astype(np.int32)
    tensors = dict(
        logits=(rng.normal(size=(B, A, V)) * 2).astype(np.float32),
        qs=[rng.normal(size=(B, A, V)).astype(np.float32) for _ in range(n)],
        tqs=[rng.normal(size=(B, A, V)).astype(np.float32) for _ in range(n)],
        vs=rng.normal(size=(B, S, 1)).astype(np.float32),
    )
    return fields, tensors


def _compare_loss(fields, tensors, two_qs, seq2seq_batch, **hp):
    jcls, cls = (JILQLSeq2SeqBatch, ILQLSeq2SeqBatch) if seq2seq_batch else (JILQLBatch, ILQLBatch)
    jbatch = jcls(**{k: jnp.asarray(v) for k, v in fields.items()})
    batch = cls(**{k: torch.from_numpy(v) for k, v in fields.items()})
    j_loss, j_stats = j_ilql.ilql_loss(
        jnp.asarray(tensors["logits"]), [jnp.asarray(q) for q in tensors["qs"]],
        [jnp.asarray(q) for q in tensors["tqs"]], jnp.asarray(tensors["vs"]), jbatch, two_qs=two_qs, **hp)
    loss, stats = ilql_loss(
        torch.from_numpy(tensors["logits"]), [torch.from_numpy(q) for q in tensors["qs"]],
        [torch.from_numpy(q) for q in tensors["tqs"]], torch.from_numpy(tensors["vs"]), batch, two_qs=two_qs, **hp)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5, rtol=0)
    assert set(stats) == set(j_stats)
    for key in stats:
        np.testing.assert_allclose(stats[key].item(), float(j_stats[key]), atol=1e-5, rtol=1e-6, err_msg=key)
    return loss, stats


HP = dict(tau=0.7, gamma=0.99, cql_scale=0.1, awac_scale=1.0, beta=0.5)


@pytest.mark.parametrize("seq2seq_batch", [False, True], ids=["causal", "seq2seq"])
@pytest.mark.parametrize("two_qs", [True, False], ids=["two_qs", "one_q"])
def test_ilql_loss_matches_reference(two_qs, seq2seq_batch):
    fields, tensors = _loss_inputs(3, two_qs, seq2seq_batch)
    _compare_loss(fields, tensors, two_qs, seq2seq_batch, **HP)


def test_ilql_loss_matches_golden():
    g = np.load(GOLDEN)
    batch = ILQLBatch(
        input_ids=torch.from_numpy(g["input_ids"]), attention_mask=torch.ones_like(torch.from_numpy(g["input_ids"])),
        rewards=torch.from_numpy(g["rewards"]), states_ixs=torch.from_numpy(g["states_ixs"]),
        actions_ixs=torch.from_numpy(g["actions_ixs"]), dones=torch.from_numpy(g["dones"]))
    loss, stats = ilql_loss(
        torch.from_numpy(g["logits"]), [torch.from_numpy(g["q0"]), torch.from_numpy(g["q1"])],
        [torch.from_numpy(g["tq0"]), torch.from_numpy(g["tq1"])], torch.from_numpy(g["vs"]), batch,
        two_qs=True, **HP)
    np.testing.assert_allclose(loss.item(), float(g["loss"]), rtol=1e-5)
    for key in ("losses/loss", "losses/loss_q", "losses/loss_v", "losses/loss_cql", "losses/loss_awac",
                "values/mean", "qvalues/0/mean", "qvalues/1/mean", "awac_weight/mean"):
        np.testing.assert_allclose(stats[key].item(), float(g["stat_" + key.replace("/", "__")]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_ilql_loss_gradients_skip_the_targets():
    """The loss reaches the online Q heads, V and the logits, and never the
    target Q values (the reference's stop_gradient)."""
    fields, tensors = _loss_inputs(4, True)
    batch = ILQLBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in
              (("logits", tensors["logits"]), ("q0", tensors["qs"][0]), ("tq0", tensors["tqs"][0]),
               ("vs", tensors["vs"]))}
    loss, _ = ilql_loss(leaves["logits"], [leaves["q0"], torch.from_numpy(tensors["qs"][1])],
                        [leaves["tq0"], torch.from_numpy(tensors["tqs"][1])], leaves["vs"], batch, two_qs=True, **HP)
    loss.backward()
    assert leaves["tq0"].grad is None
    for k in ("logits", "q0", "vs"):
        assert leaves[k].grad is not None and leaves[k].grad.abs().sum() > 0, k


@pytest.mark.parametrize("n_qs,beta,top_k", [(2, 1.0, 0), (1, 0.5, 0), (2, 100.0, 5)])
def test_ilql_shape_logits_matches_reference(n_qs, beta, top_k):
    rng = np.random.default_rng(n_qs)
    logits = rng.normal(size=(3, 40)).astype(np.float32)
    qs = [rng.normal(size=(3, 40)).astype(np.float32) for _ in range(n_qs)]
    vs = rng.normal(size=(3, 1)).astype(np.float32)
    want = j_ilql.ilql_shape_logits(jnp.asarray(logits), [jnp.asarray(q) for q in qs], jnp.asarray(vs), beta, top_k)
    got = ilql_shape_logits(torch.from_numpy(logits), [torch.from_numpy(q) for q in qs], torch.from_numpy(vs), beta,
                            top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


SAMPLES = [("q", "good"), ("q", "bad"), ("p", "fine"), ("p", "meh"), "a plain string",
           ("one", " two", " three", " four"), ("long", " and an output past the budget")]
REWARDS = [1.0, -1.0, 0.5, -0.5, 0.25, 2.0, -2.0]


@pytest.mark.parametrize("max_length", [12, 64])
def test_make_experience_matches_reference(max_length):
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    store = ilql.make_experience(SAMPLES, REWARDS, tok, max_length, verbose=False)
    jstore = j_trainer.make_experience(SAMPLES, REWARDS, jtok, max_length, verbose=False)
    for key in ("input_ids", "attention_mask", "states_ixs", "actions_ixs", "dones"):
        assert store.fields[key] == [list(map(int, x)) for x in jstore.fields[key]], key
    for got, want in zip(store.fields["rewards"], jstore.fields["rewards"]):
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert (store.seq_width, store.actions_width, store.states_width) == (
        jstore.seq_width, jstore.actions_width, jstore.states_width)


def test_make_experience_seq2seq_matches_reference():
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    pairs = [s for s in SAMPLES if not isinstance(s, str)]
    rewards = REWARDS[:len(pairs)]
    store = ilql.make_experience_seq2seq(pairs, rewards, tok, 16, verbose=False, decoder_start_token_id=257)
    jstore = j_trainer.make_experience_seq2seq(pairs, rewards, jtok, 16, verbose=False, decoder_start_token_id=257)
    for key in ("input_ids", "attention_mask", "decoder_input_ids", "states_ixs", "actions_ixs", "dones"):
        assert store.fields[key] == [list(map(int, x)) for x in jstore.fields[key]], key
    for got, want in zip(store.fields["rewards"], jstore.fields["rewards"]):
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert all(row[0] == 257 for row in store.fields["decoder_input_ids"])
    # a constant reward is left unscaled (std 0): every return is 0
    flat = ilql.make_experience(pairs, [1.0] * len(pairs), tok, 16, verbose=False)
    assert all(r[-1] == 0.0 for r in flat.fields["rewards"])


@pytest.mark.parametrize("seed", [0, 1, 1005])
@pytest.mark.parametrize("arch", ["causal", "seq2seq"])
def test_store_collate_and_loader_order_match_reference(seed, arch):
    """Two epochs of one shuffled, drop_last loader (21 samples in batches
    of 4): every batch's every field exactly."""
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    rng = np.random.default_rng(seed)
    samples = [("abcdefgh"[: 1 + i % 5], "xyzw"[: 1 + (i * 7) % 4]) for i in range(21)]
    rewards = rng.normal(size=21).tolist()
    if arch == "causal":
        store = ilql.make_experience(samples, rewards, tok, 16, verbose=False)
        jstore = j_trainer.make_experience(samples, rewards, jtok, 16, verbose=False)
    else:
        store = ilql.make_experience_seq2seq(samples, rewards, tok, 16, verbose=False, decoder_start_token_id=0)
        jstore = j_trainer.make_experience_seq2seq(samples, rewards, jtok, 16, verbose=False,
                                                   decoder_start_token_id=0)
    loader = store.create_loader(4, shuffle=True, drop_last=True, seed=seed)
    jloader = jstore.create_loader(4, shuffle=True, drop_last=True, seed=seed)
    for _ in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 5
        for b, jb in zip(got, want):
            for name in b.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(jb, name)),
                                              err_msg=name)
            assert b.rewards.dtype == torch.float32 and b.actions_ixs.dtype == torch.int32


TINY = dict(vocab_size=300, hidden_size=32, n_layer=2, n_head=2, n_positions=64)
TINY_T5 = dict(vocab_size=300, d_model=32, n_layer=2, n_decoder_layer=2, n_head=4, d_kv=8, d_ff=64,
               relative_attention_num_buckets=8)


def _ilql_batch(arch, seed=2):
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    samples = [("prompt" + "x" * int(rng.integers(0, 4)), " out" + "y" * int(rng.integers(0, 5)))
               for _ in range(3)]
    rewards = rng.normal(size=3).tolist()
    if arch == "causal":
        store = ilql.make_experience(samples, rewards, tok, 32, verbose=False)
    else:
        store = ilql.make_experience_seq2seq(samples, rewards, tok, 32, verbose=False, decoder_start_token_id=0)
    return store.collate([store[i] for i in range(3)])


@pytest.mark.parametrize("two_qs", [True, False], ids=["two_qs", "one_q"])
@pytest.mark.parametrize("arch", ["causal", "seq2seq"])
def test_ilql_wrapper_forward_matches_reference(arch, two_qs):
    """The gathered logits, Q, target Q and V heads and the loss they give,
    from the same (converted) weights, to 1e-5; then the Polyak sync."""
    batch = _ilql_batch(arch)
    if arch == "causal":
        jmodel = JCausalILQL(JConfig(dtype=jnp.float32, **TINY), two_qs=two_qs, alpha=0.3)
        cfg = TransformerConfig(dtype=torch.float32, **TINY)
        model = wrappers.CausalLMWithILQLHeads(cfg, two_qs=two_qs, alpha=0.3, device="cpu")
        args = ("input_ids", "attention_mask", "states_ixs", "actions_ixs")
    else:
        jmodel = JSeq2SeqILQL(jseq.Seq2SeqConfig(dtype=jnp.float32, **TINY_T5), two_qs=two_qs, alpha=0.3)
        cfg = seq2seq.Seq2SeqConfig(dtype=torch.float32, **TINY_T5)
        model = wrappers.Seq2SeqLMWithILQLHeads(cfg, two_qs=two_qs, alpha=0.3, device="cpu")
        args = ("input_ids", "attention_mask", "decoder_input_ids", "states_ixs", "actions_ixs")
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    # the online heads apart from their targets, as after some training
    jparams["heads"]["target_q_heads"] = jax.tree_util.tree_map(lambda x: x * 0.5 + 0.01,
                                                                jparams["heads"]["target_q_heads"])
    sd = params_from_jax(_np(jparams), cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    logits, (qs, tqs, vs) = model(*(getattr(batch, a) for a in args))
    jlogits, (jqs, jtqs, jvs) = jmodel.forward(jparams, *(jnp.asarray(getattr(batch, a).numpy()) for a in args))
    A = batch.actions_ixs.shape[1]
    assert logits.shape == (3, A, 300) and vs.shape == (3, A + 1, 1) and len(qs) == len(tqs) == (2 if two_qs else 1)
    for got, want in [(logits, jlogits), (vs, jvs), *zip(qs, jqs), *zip(tqs, jtqs)]:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert all(not t.requires_grad for t in tqs)
    assert {n for n, p in model.named_parameters() if not p.requires_grad} == {
        n for n in sd if n.startswith("heads.target_q_heads.")}

    jsynced = jmodel.sync_target(jparams)
    model.sync_target()
    for n, t in params_from_jax(_np(jsynced), cfg).items():
        if n.startswith("heads.target_q_heads."):
            np.testing.assert_allclose(model.state_dict()[n].numpy(), t.numpy(), atol=1e-7, rtol=0, err_msg=n)


def test_convert_reads_orbax_head_lists_in_index_order():
    """A head list that went through orbax comes back as {"0": .., "1": ..,
    "10": ..}: it is read by integer index, not by string order (the JAX
    loader's own handling, `trlx_tpu/trainer/ilql.py:177-184`)."""
    from trlx_tpu_torch.models.convert import ilql_heads_state_dict_from_jax

    def head(x):
        return {"fc_in": {"kernel": np.full((2, 3), x, np.float32), "bias": np.zeros(3, np.float32)},
                "fc_out": {"kernel": np.full((3, 4), x, np.float32), "bias": np.zeros(4, np.float32)}}

    heads = {"v_head": head(-1.0), "q_heads": [head(float(i)) for i in range(11)],
             "target_q_heads": {str(i): head(100.0 + i) for i in range(11)}}
    sd = ilql_heads_state_dict_from_jax(heads)
    for i in range(11):
        assert sd[f"heads.q_heads.{i}.fc_in.kernel"][0, 0].item() == i
        assert sd[f"heads.target_q_heads.{i}.fc_out.kernel"][0, 0].item() == 100 + i
    assert sd["heads.v_head.fc_in.kernel"][0, 0].item() == -1


def test_init_heads_start_targets_as_copies():
    model = wrappers.CausalLMWithILQLHeads(TransformerConfig(dtype=torch.float32, **TINY), device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    for q, t in zip(model.heads.q_heads, model.heads.target_q_heads):
        for (n, a), b in zip(q.named_parameters(), t.parameters()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), n


# -- train() against trlx_tpu.train ------------------------------------------

TRAIN_SAMPLES = [("q", "good"), ("q", "bad"), ("p", "fine"), ("p", "meh"), ("r", "yes!"), ("r", "no"),
                 ("s", "ok"), ("s", "nope")] * 2
TRAIN_REWARDS = [1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 0.25, -0.25] * 2
STEPS = 6


def _train_config(tmp_path, arch):
    """Two batches of 8 an epoch, 6 steps, the Polyak sync at every second
    step's epoch end (alpha 0.3), evaluations at 0, 3 and 6 sweeping beta
    over [0, 1] greedily."""
    config = j_default_ilql_config().evolve(
        train=dict(batch_size=8, total_steps=STEPS, eval_interval=3, checkpoint_interval=100, seq_length=12,
                   epochs=10, tracker=None, compute_dtype="float32", checkpoint_dir=str(tmp_path / "ckpts"),
                   seed=3),
        model=dict(model_path="random", model_extra_configs={"transformer": dict(TINY, vocab_size=258)}),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-2)),
        method=dict(alpha=0.3, steps_for_target_q_sync=2,
                    gen_kwargs=dict(max_new_tokens=4, top_k=10, beta=[0, 1], do_sample=False)),
    )
    if arch == "seq2seq":
        config = config.evolve(model=dict(model_arch_type="seq2seq", model_extra_configs={
            "seq2seq": dict(TINY_T5, vocab_size=258)}))
    return config


def _capture(monkeypatch, cls, store):
    generate_eval = cls.generate_eval

    def recorded(self, *args, **kwargs):
        out = generate_eval(self, *args, **kwargs)
        store.append((kwargs.get("beta"), np.asarray(out["sequences"])))
        return out

    monkeypatch.setattr(cls, "generate_eval", recorded)


def _run_pair(tmp_path, monkeypatch, arch, **train_kw):
    jconfig = _train_config(tmp_path, arch)
    init, j_stats, j_evals, evals = {}, [], [], []
    setup = j_trainer.TPUILQLTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(_np(self.params))

    monkeypatch.setattr(j_trainer.TPUILQLTrainer, "setup_model", capture_setup)
    monkeypatch.setattr(JBaseTrainer, "_tracker_log", lambda self, stats, step: j_stats.append((step, dict(stats))))
    monkeypatch.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
    _capture(monkeypatch, JBaseTrainer, j_evals)
    ref = trlx_tpu.train(samples=TRAIN_SAMPLES, rewards=TRAIN_REWARDS, config=jconfig)

    cls = wrappers.Seq2SeqLMWithILQLHeads if arch == "seq2seq" else wrappers.CausalLMWithILQLHeads
    monkeypatch.setattr(cls, "init_params", lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg))
                        and self)
    _capture(monkeypatch, trainer_base.TPUBaseTrainer, evals)
    ours = trlx_tpu_torch.train(samples=TRAIN_SAMPLES, rewards=TRAIN_REWARDS,
                                config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu", **train_kw)
    return ref, ours, init, j_stats, j_evals, evals


@pytest.mark.parametrize("arch", ["causal", "seq2seq"])
def test_train_rewards_matches_reference(tmp_path, monkeypatch, arch):
    ref, ours, init, j_stats, j_evals, evals = _run_pair(tmp_path, monkeypatch, arch)
    assert ours.iter_count == ref.iter_count == STEPS

    def losses(stream):
        return [(step, float(s["losses/loss"])) for step, s in stream if "losses/loss" in s]

    want, got = losses(j_stats), losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=0)
    keys = [k for _, s in j_stats for k in s if k.startswith(("losses/", "values/", "qvalues/", "awac_weight/"))]
    assert {k for _, s in ours.stats_history for k in s} >= set(keys)

    # three evaluations (steps 0, 3, 6), each sweeping beta over [0, 1]
    assert [b for b, _ in evals] == [b for b, _ in j_evals] == [0, 1] * 3
    for (_, a), (_, b) in zip(evals, j_evals):
        np.testing.assert_array_equal(a, b)

    # two syncs (after steps 2 and 4): the target heads and every online
    # tensor after the run
    want_sd = params_from_jax(_np(ref.params), ours.model.cfg)
    start = params_from_jax(init, ours.model.cfg)
    for name, p in ours.model.state_dict().items():
        if name.startswith("heads.target_q_heads."):
            assert not torch.equal(p, start[name]), name
            np.testing.assert_allclose(p.numpy(), want_sd[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
        elif name.startswith("heads."):
            assert not torch.equal(p, start[name]), name


def test_train_dataset_and_engine_take_the_static_sampler(tmp_path, monkeypatch):
    """`train(dataset=(samples, rewards))` selects ILQL as `rewards` does;
    with the decode engine enabled (ILQLConfig has no gen_engine section,
    so the engine config is forced on), every evaluation samples on the
    static sampler with the processor: the engine has no hook for it."""
    config = TRLConfig.from_dict(_train_config(tmp_path, "causal").to_dict()).evolve(
        train=dict(total_steps=2, eval_interval=100))
    engine_on = trainer_base.GenEngineConfig.from_dict({"enabled": True, "slots": 8})
    monkeypatch.setattr(trainer_base.GenEngineConfig, "from_dict", staticmethod(lambda section: engine_on))
    calls = []
    generate = trainer_base.generate

    def spy(*args, **kwargs):
        calls.append(kwargs.get("logits_processor"))
        return generate(*args, **kwargs)

    monkeypatch.setattr(trainer_base, "generate", spy)
    monkeypatch.setattr(trainer_base.TPUBaseTrainer, "_engine_generate",
                        lambda *a, **k: pytest.fail("the engine sampled under a logits processor"))
    trainer = trlx_tpu_torch.train(dataset=(TRAIN_SAMPLES, TRAIN_REWARDS), config=config, device="cpu")
    assert isinstance(trainer, ilql.TPUILQLTrainer) and trainer.iter_count == 2
    assert len(calls) == 4 and all(c is not None for c in calls)  # evals at 0 and 2, two betas each
    assert not trainer._engine_eligible()


def test_generate_kwarg_contract(tmp_path):
    config = TRLConfig.from_dict(_train_config(tmp_path, "causal").to_dict())
    trainer = get_trainer(config.train.trainer)(config=config, device="cpu")
    ids = torch.full((2, 4), 97, dtype=torch.int32)
    assert trainer.generate(ids, beta=1.0)["sequences"].shape == (2, 8)
    assert trainer.generate(ids, beta=np.float32(0.5))["sequences"].shape == (2, 8)
    with pytest.raises(TypeError, match="must be a scalar"):
        trainer.generate(ids, beta=[0, 1])
    with pytest.raises(TypeError, match="neither SamplerSettings nor"):
        trainer.generate(ids, gamma=0.5)
    # a trainer without a processor declares no beta
    sft = get_trainer("TPUSFTTrainer")(config=default_sft_config().evolve(
        train=dict(compute_dtype="float32", checkpoint_dir=str(tmp_path / "sft")), tokenizer=dict(tokenizer_path="byte"),
        model=dict(model_path="random", model_extra_configs={"transformer": dict(TINY, vocab_size=258)}),
        method=dict(gen_kwargs=dict(max_new_tokens=4))), device="cpu")
    with pytest.raises(TypeError, match="neither SamplerSettings nor"):
        sft.generate(ids, beta=1.0)


@pytest.mark.parametrize("arch", ["causal", "seq2seq"])
def test_save_pretrained_round_trips_the_heads(tmp_path, arch):
    """A trained ILQL model saved and reloaded through `model_path=dir`:
    every tensor, the heads and their targets included, bit for bit."""
    config = TRLConfig.from_dict(_train_config(tmp_path, arch).to_dict()).evolve(
        train=dict(total_steps=2, eval_interval=100))
    trainer = trlx_tpu_torch.train(samples=TRAIN_SAMPLES, rewards=TRAIN_REWARDS, config=config, device="cpu")
    trainer.model.sync_target(0.5)  # the targets apart from a fresh copy of the online heads
    directory = str(tmp_path / "saved")
    trainer.save_pretrained(directory)
    reloaded = get_trainer("TPUILQLTrainer")(config=config.evolve(model=dict(model_path=directory)), device="cpu")
    want = trainer.model.state_dict()
    got = reloaded.model.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert not torch.equal(got["heads.target_q_heads.0.fc_out.kernel"], got["heads.q_heads.0.fc_out.kernel"])


def test_registry_aliases():
    for name in ("TPUILQLTrainer", "AccelerateILQLTrainer", "NeMoILQLTrainer"):
        assert get_trainer(name) is ilql.TPUILQLTrainer
    # GRPO and DPO, which raised until the port reached them, resolve to
    # the port's classes under the reference's names and aliases
    from trlx_tpu_torch.trainer import dpo, grpo

    for name, cls in (("TPUGRPOTrainer", grpo.TPUGRPOTrainer), ("AccelerateGRPOTrainer", grpo.TPUGRPOTrainer),
                      ("TPUDPOTrainer", dpo.TPUDPOTrainer), ("AccelerateDPOTrainer", dpo.TPUDPOTrainer)):
        assert get_trainer(name) is cls
    with pytest.raises(ValueError, match="Unknown trainer"):
        get_trainer("TPUPPOTrainerX")
