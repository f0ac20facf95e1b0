"""The single-chip memory recipe in trlx_tpu_torch against trlx_tpu, on the
CPU: gradient accumulation, the remat policies, bf16 gradients, the fused
8-bit AdamW's NaN guard and resume, and the recipe's config files.

Tolerances:
- `train()` with train.minibatch_size = batch_size / 2 (two microbatches a
  step, gradients and stats summed in fp32 and averaged) for PPO, GRPO,
  SFT, ILQL, DPO and RFT, two steps each: the loss stream to rtol 1e-4
  (fp32), each from the other package's converted init.
- Every remat policy (T5: `save_attn`, whose recompute replays the bias
  kernel's outputs): loss and gradients equal to the no-remat pass to
  1e-6 (the recompute runs the same ops) and to the reference's
  `jax.checkpoint` pass at fp32 rounding: the loss (a signed sum over the
  logits) to atol 1e-3, the gradients to rtol 1e-5 with atol 5e-5
  (causal) and 5e-4 (T5, as test_torch_seq2seq.py).
- grads_dtype bfloat16 (one SGD step of lr 1 reads the gradient off the
  parameters; bf16 compute; the batch whole and in two microbatches,
  whose bf16 gradients both packages sum in fp32): the port rounds each
  parameter's fp32 gradient to bf16 once, the reference differentiates
  through a bf16 view of the parameters. Per tensor class, the relative
  error norm of the port's bf16 gradient from the reference's: block
  projection kernels
  within 2% (both are bf16 roundings of products whose fp32 sums differ
  in order), norm gains, biases and the tied embedding (fp32 use, or a sum
  of two uses, which the reference rounds in bf16) within 5%; the key
  projection's bias, whose exact gradient is zero, is left out.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.data.configs import TRLConfig as JTRLConfig
from trlx_tpu.models import seq2seq as jseq
from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.transformer import TransformerLM as JLM
from trlx_tpu.ops.adam8bit import Q8, fused_adamw_8bit_update
from trlx_tpu.ops.adam8bit import Adam8bitState
from trlx_tpu.ops.remat import resolve_remat as j_resolve_remat
from trlx_tpu.trainer import dpo as j_dpo
from trlx_tpu.trainer import grpo as j_grpo
from trlx_tpu.trainer import ilql as j_ilql
from trlx_tpu.trainer import rft as j_rft
from trlx_tpu.trainer import sft as j_sft
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.trainer.ppo import TPUPPOTrainer as JPPOTrainer

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import seq2seq, wrappers
from trlx_tpu_torch.models.convert import lm_state_dict_from_jax, params_from_jax
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from trlx_tpu_torch.ops import flash_attention as fa
from trlx_tpu_torch.ops.remat import resolve_remat
from trlx_tpu_torch.trainer import base as trainer_base
from tests.torch_port import ppo_parity
from tests.torch_port import test_torch_dpo as dpo_t
from tests.torch_port import test_torch_grpo as grpo_t
from tests.torch_port import test_torch_ilql as ilql_t
from tests.torch_port import test_torch_rft as rft_t
from tests.torch_port import test_torch_sft as sft_t

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POLICIES = ("none", "full", "save_nothing", "dots_saveable", "dots_with_no_batch_dims", "offload", "save_attn")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# train() under gradient accumulation, every trainer
# ---------------------------------------------------------------------------


def _load_all(init):
    return lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self


def _load_base(init):
    return lambda self, gen: self.base.load_state_dict(lm_state_dict_from_jax(init["base"], self.cfg)) and self


# batch 16 in two microbatches of 8 (the reference's 8 virtual devices take
# a microbatch of 8)
ACCUMULATION = dict(batch_size=16, minibatch_size=8)


def _case(name, tmp_path):
    """(reference config, reference trainer class, port model class, its
    init loader, train kwargs, generate patch or None, loss key)."""
    acc = ACCUMULATION
    if name == "ppo":
        cfg = ppo_parity.config(tmp_path, train=dict(acc, total_steps=2))
        return (cfg, JPPOTrainer, wrappers.CausalLMWithValueHead, _load_all,
                dict(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS), None, "losses/total_loss")
    if name == "grpo":
        cfg = grpo_t._config(tmp_path).evolve(train=dict(acc, total_steps=2))
        return (cfg, j_grpo.TPUGRPOTrainer, wrappers.CausalLM, _load_all,
                dict(reward_fn=grpo_t.reward_fn, prompts=grpo_t.PROMPTS, eval_prompts=grpo_t.PROMPTS[:4]),
                grpo_t.scripted_generate, "losses/total_loss")
    if name == "sft":
        cfg = sft_t._config(tmp_path).evolve(train=dict(acc, total_steps=2))
        # one whole batch an epoch: the reference reshapes every batch into microbatches
        return (cfg, j_sft.TPUSFTTrainer, wrappers.CausalLM, _load_base, dict(samples=sft_t.SAMPLES[:16]), None,
                "losses/loss")
    if name == "ilql":
        cfg = ilql_t._train_config(tmp_path, "causal").evolve(train=dict(acc, total_steps=2))
        return (cfg, j_ilql.TPUILQLTrainer, wrappers.CausalLMWithILQLHeads, _load_all,
                dict(samples=ilql_t.TRAIN_SAMPLES, rewards=ilql_t.TRAIN_REWARDS), None, "losses/loss")
    if name == "dpo":
        cfg = dpo_t._config(tmp_path, total_steps=2, **acc)
        return cfg, j_dpo.TPUDPOTrainer, wrappers.CausalLM, _load_all, dict(samples=dpo_t.MIXED_PAIRS), None, \
            "losses/total_loss"
    cfg = rft_t._config(tmp_path, start_percentile=0.0, end_percentile=0.0)
    cfg = JTRLConfig.from_dict(dict(cfg.to_dict(), train=dict(cfg.to_dict()["train"], total_steps=2, **acc)))
    return (cfg, j_rft.TPURFTTrainer, wrappers.CausalLM, _load_base,
            dict(reward_fn=rft_t.reward_fn, prompts=rft_t.PROMPTS, eval_prompts=rft_t.PROMPTS), None, "losses/loss")


def _run_pair(name, tmp_path):
    jconfig, j_cls, port_cls, loader, kw, gen_patch, key = _case(name, tmp_path)
    init, j_stats = {}, []
    setup = j_cls.setup_model

    def capture_setup(self):
        setup(self)
        init.update(_np(self.params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_cls, "setup_model", capture_setup)
        mp.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: j_stats.append((step, dict(st))))
        mp.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
        if gen_patch is not None:
            mp.setattr(JBaseTrainer, "generate", gen_patch([], False))
        ref = trlx_tpu.train(config=jconfig, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cls, "init_params", loader(init))
        if gen_patch is not None:
            mp.setattr(trainer_base.TPUBaseTrainer, "generate", gen_patch([], True))
        ours = trlx_tpu_torch.train(config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu", **kw)
    return ref, ours, j_stats, key


@pytest.mark.parametrize("name", ["ppo", "grpo", "sft", "ilql", "dpo", "rft"])
def test_minibatch_train_matches_reference(name, tmp_path):
    ref, ours, j_stats, key = _run_pair(name, tmp_path)
    assert ours.num_mb == 2 and ours.mb_size == 8
    want = [(s, float(st[key])) for s, st in j_stats if key in st]
    got = [(s, float(st[key])) for s, st in ours.stats_history if key in st]
    assert len(got) == 2 and [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=0)


def test_minibatch_must_divide_the_batch(tmp_path):
    with pytest.raises(ValueError, match="divisible by minibatch_size"):
        trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, device="cpu",
                             config=TRLConfig.from_dict(ppo_parity.config(
                                 tmp_path, train=dict(batch_size=8, minibatch_size=3)).to_dict()))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=300, hidden_size=64, n_layer=2, n_head=1, n_positions=64)


@pytest.fixture(scope="module")
def causal_pair():
    """The JAX model and its init, the port's model loaded from it, and the
    inputs: built once for the module's remat cases (each case sets its own
    policy and zeroes the gradients)."""
    return _causal_pair()


def _causal_pair():
    jlm = JLM(JConfig(dtype=jnp.float32, attention_impl="xla", **TINY))
    jparams = jlm.init(jax.random.PRNGKey(3))
    lm = TransformerLM(TransformerConfig(dtype=torch.float32, attention_impl="pallas", **TINY), device="cpu")
    lm.load_state_dict(params_from_jax(_np(jparams), lm.cfg))
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 258, size=(3, 10)).astype(np.int32)
    # no padding: a wholly masked query row averages V uniformly in the flash
    # kernel and takes the -1e9 softmax on the reference's XLA path
    mask = np.ones((3, 10), np.int32)
    w = rng.standard_normal((3, 10, 300)).astype(np.float32)
    return jlm, jparams, lm, ids, mask, w


def _port_loss_and_grads(lm, ids, mask, w, policy):
    lm.remat = resolve_remat(policy)
    lm.zero_grad(set_to_none=True)
    loss = (lm(torch.from_numpy(ids), torch.from_numpy(mask))["logits"] * torch.from_numpy(w)).sum()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in lm.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_no_remat_and_reference(policy, causal_pair):
    jlm, jparams, lm, ids, mask, w = causal_pair
    loss0, grads0 = _port_loss_and_grads(lm, ids, mask, w, "none")
    loss, grads = _port_loss_and_grads(lm, ids, mask, w, policy)
    assert loss == pytest.approx(loss0, rel=1e-6)
    for n, g in grads.items():
        torch.testing.assert_close(g, grads0[n], rtol=1e-6, atol=1e-7, msg=n)

    def j_loss(p):
        return jnp.sum(jlm(p, jnp.asarray(ids), jnp.asarray(mask), remat=j_resolve_remat(policy))["logits"] * w)

    jl, jg = jax.value_and_grad(j_loss)(jparams)
    # a signed sum over 9,000 logits: fp32 rounding of either side's logits
    assert loss == pytest.approx(float(jl), abs=1e-3)
    want = params_from_jax(_np(jg), lm.cfg)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=5e-5, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("policy", ["full", "save_attn"])
def test_remat_recomputes_attention_unless_saved(policy, monkeypatch, causal_pair):
    """`full` re-runs each block's attention in the backward (one more
    forward launch a block); `save_attn` keeps the kernel's out, m and l
    and re-runs none."""
    _, _, lm, ids, mask, w = causal_pair
    calls = []
    forward = fa._forward
    monkeypatch.setattr(fa, "_forward", lambda *a: calls.append(1) or forward(*a))
    _port_loss_and_grads(lm, ids, mask, w, policy)
    assert len(calls) == TINY["n_layer"] * (2 if policy == "full" else 1)


@pytest.mark.parametrize("policy", ["save_attn"])
def test_t5_remat_matches_no_remat_and_reference(policy):
    arch = dict(vocab_size=300, d_model=32, n_layer=2, n_decoder_layer=2, n_head=4, d_kv=8, d_ff=64,
                relative_attention_num_buckets=8, relative_attention_max_distance=20, decoder_start_token_id=257)
    jlm = jseq.T5LM(jseq.Seq2SeqConfig(dtype=jnp.float32, **arch))
    jparams = jlm.init(jax.random.PRNGKey(5))
    lm = seq2seq.T5LM(seq2seq.Seq2SeqConfig(dtype=torch.float32, attention_impl="pallas", **arch), device="cpu")
    lm.load_state_dict(params_from_jax(_np(jparams), lm.cfg))
    rng = np.random.default_rng(6)
    enc, dec = rng.integers(0, 256, size=(2, 7)), rng.integers(0, 256, size=(2, 5))
    enc_mask, dec_mask = np.ones((2, 7), np.int32), np.ones((2, 5), np.int32)
    enc_mask[0, :2] = 0
    w = rng.standard_normal((2, 5, 300)).astype(np.float32)

    def port(p):
        lm.remat = resolve_remat(p)
        lm.zero_grad(set_to_none=True)
        out = lm(*(torch.from_numpy(x) for x in (enc, enc_mask, dec, dec_mask)))
        loss = (out["logits"] * torch.from_numpy(w)).sum()
        loss.backward()
        return loss.item(), {n: q.grad.clone() for n, q in lm.named_parameters()}

    loss0, grads0 = port("none")
    loss, grads = port(policy)
    assert loss == pytest.approx(loss0, rel=1e-6)
    for n, g in grads.items():
        torch.testing.assert_close(g, grads0[n], rtol=1e-6, atol=1e-7, msg=n)

    def j_loss(p):
        out = jlm(p, jnp.asarray(enc), jnp.asarray(enc_mask), jnp.asarray(dec), jnp.asarray(dec_mask),
                  remat=j_resolve_remat(policy))
        return jnp.sum(out["logits"] * w)

    jl, jg = jax.value_and_grad(j_loss)(jparams)
    assert loss == pytest.approx(float(jl), abs=1e-3)
    want = params_from_jax(_np(jg), lm.cfg)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=5e-4, rtol=1e-5, err_msg=n)


def test_resolve_remat_names_and_error():
    assert resolve_remat("none") is False and resolve_remat("full") == "full" and resolve_remat(True) is True
    with pytest.raises(ValueError, match="remat_policy"):
        resolve_remat("everything")


# ---------------------------------------------------------------------------
# bf16 gradients beside fp32 masters
# ---------------------------------------------------------------------------


def _sgd_step_grads(tmp_path, minibatch_size=None):
    """One SFT step of SGD at lr 1 in each package under grads_dtype
    bfloat16 and bf16 compute, from the same init, the batch of 16 whole or
    in microbatches of `minibatch_size`: each package's gradient as (init -
    after)."""
    d = sft_t._config(tmp_path).evolve(
        train=dict(total_steps=1, eval_interval=100, compute_dtype="bfloat16", grads_dtype="bfloat16",
                   minibatch_size=minibatch_size)).to_dict()
    cfg = JTRLConfig.from_dict(dict(d, optimizer=dict(name="sgd", kwargs=dict(lr=1.0)),
                                    scheduler=dict(name="constant", kwargs={})))
    init, j_stats = {}, []
    setup = j_sft.TPUSFTTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(_np(self.params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sft.TPUSFTTrainer, "setup_model", capture_setup)
        mp.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
        mp.setattr(JBaseTrainer, "evaluate", lambda self: {})
        ref = trlx_tpu.train(samples=sft_t.SAMPLES, config=cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wrappers.CausalLM, "init_params", _load_base(init))
        mp.setattr(trainer_base.TPUBaseTrainer, "evaluate", lambda self: {})
        ours = trlx_tpu_torch.train(samples=sft_t.SAMPLES, config=TRLConfig.from_dict(cfg.to_dict()), device="cpu")
    start = lm_state_dict_from_jax(init["base"], ours.model.cfg)
    after = lm_state_dict_from_jax(_np(ref.params["base"]), ours.model.cfg)
    want = {n: start[n] - after[n] for n in start}
    got = {n: start[n] - p.detach() for n, p in ours.model.base.named_parameters()}
    return got, want, ours


@pytest.mark.parametrize("minibatch_size", [None, 8], ids=["one_microbatch", "two_microbatches"])
def test_bf16_gradients_match_reference_by_class(minibatch_size, tmp_path):
    """With two microbatches each one's bf16 gradient is summed in fp32,
    averaged and rounded to bf16 again, in both packages."""
    got, want, ours = _sgd_step_grads(tmp_path, minibatch_size)
    assert ours.num_mb == (2 if minibatch_size else 1)
    assert ours.grads_dtype == torch.bfloat16 and not ours._grad_tree
    assert all(p.dtype == torch.float32 for p in ours.model.parameters())
    errs = {}
    for n in want:
        if n.endswith("attn.k.bias"):
            continue  # its exact gradient is zero (it shifts a query's scores equally): no relative error
        d = (got[n] - want[n]).norm() / want[n].norm().clamp(min=1e-30)
        errs[n] = float(d)
        projection = n.endswith(".kernel") and ".blocks." in f".{n}"
        assert errs[n] <= (0.02 if projection else 0.05), (n, errs[n])


# ---------------------------------------------------------------------------
# the fused 8-bit AdamW in the trainer: NaN guard and resume
# ---------------------------------------------------------------------------


def _fused_config(tmp_path, **train):
    return TRLConfig.from_dict(sft_t._config(tmp_path).evolve(
        train=dict(dict(total_steps=4, eval_interval=100, checkpoint_interval=2, grads_dtype="bfloat16",
                        minibatch_size=8, remat_policy="full"), **train),
        optimizer=dict(name="adamw_8bit_fused", kwargs=dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)),
    ).to_dict())


def test_fused_nan_guard_applies_zeroed_gradients(tmp_path):
    """A poisoned step under the fused 8-bit AdamW returns a NaN loss but
    still applies, with zeroed gradients: the count advances, the moments
    decay, the weight decay applies. The parameters and payloads equal the
    reference's fused update with zero gradients on the same state."""
    trainer = trlx_tpu_torch.train(samples=sft_t.SAMPLES, config=_fused_config(tmp_path, total_steps=1),
                                   device="cpu")
    batch = next(iter(trainer.create_train_dataloader()))
    p = trainer.model.base.blocks[0].mlp.fc_in.kernel
    st = trainer.optimizer.state[p]
    before = p.detach().clone()
    def j(t):  # a copy: the step below updates the state in place
        return jnp.asarray(t.numpy().copy())

    jstate = Adam8bitState(count=jnp.asarray(int(st["step"]), jnp.int32),
                           m=Q8(j(st["m_q"]), j(st["m_scale"]), tuple(p.shape)),
                           v=Q8(j(st["v_q"]), j(st["v_scale"]), tuple(p.shape)))
    lr = trainer.schedule(trainer.iter_count)
    loss_fn = trainer.loss
    trainer.loss = lambda b: (lambda out: (out[0] * float("nan"), out[1]))(loss_fn(b))
    loss, _ = trainer.train_step(batch)
    assert np.isnan(loss) and int(st["step"]) == 2
    want_p, want_state = fused_adamw_8bit_update(
        jnp.asarray(before.numpy()), jnp.zeros(tuple(p.shape), jnp.bfloat16), jstate, lr,
        b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(st["m_q"].numpy(), np.asarray(want_state.m.q))
    np.testing.assert_array_equal(st["v_q"].numpy(), np.asarray(want_state.v.q))
    assert not torch.equal(p.detach(), before)  # the decay applied


def test_nan_guard_skips_under_other_optimizers(tmp_path):
    trainer = trlx_tpu_torch.train(samples=sft_t.SAMPLES, device="cpu", config=_fused_config(
        tmp_path, total_steps=1).evolve(optimizer=dict(name="adamw_8bit_bnb")))
    batch = next(iter(trainer.create_train_dataloader()))
    params = [p.detach().clone() for p in trainer.trainable_params]
    steps = [int(s["step"]) for s in trainer.optimizer.state.values()]
    loss_fn = trainer.loss
    trainer.loss = lambda b: (lambda out: (out[0] * float("nan"), out[1]))(loss_fn(b))
    loss, _ = trainer.train_step(batch)
    assert np.isnan(loss)
    assert all(torch.equal(a, b.detach()) for a, b in zip(params, trainer.trainable_params))
    assert [int(s["step"]) for s in trainer.optimizer.state.values()] == steps


def test_bf16_gradient_hooks_let_the_trainer_go(tmp_path):
    """The gradient hooks under grads_dtype hold the trainer weakly: once
    the caller drops it, the trainer, its model and its optimizer state
    are freed (autograd keeps hooks out of the garbage collector's sight,
    so a strong reference would keep them for the process's life)."""
    import gc
    import weakref

    trainer = trlx_tpu_torch.train(samples=sft_t.SAMPLES, device="cpu",
                                   config=_fused_config(tmp_path, total_steps=1))
    assert trainer.grads_dtype == torch.bfloat16 and trainer.optimizer.state
    refs = [weakref.ref(x) for x in (trainer, trainer.model, trainer.trainable_params[0])]
    del trainer
    gc.collect()
    assert [r() is None for r in refs] == [True, True, True]


def test_resume_with_8bit_state_is_bit_for_bit(tmp_path):
    """Four steps uninterrupted, and two steps, a checkpoint, a fresh
    trainer resumed from it and two more: the weights, the int8 payloads,
    the scales and the counts equal bit for bit."""
    full = trlx_tpu_torch.train(samples=sft_t.SAMPLES, config=_fused_config(tmp_path / "a"), device="cpu")
    first = trlx_tpu_torch.train(samples=sft_t.SAMPLES, device="cpu",
                                 config=_fused_config(tmp_path / "b", total_steps=2))
    ckpts = sorted(p for p in os.listdir(tmp_path / "b" / "ckpts") if p.startswith("checkpoint_"))
    resumed = trlx_tpu_torch.train(samples=sft_t.SAMPLES, device="cpu", config=_fused_config(
        tmp_path / "b", resume_from_checkpoint=str(tmp_path / "b" / "ckpts" / ckpts[-1])))
    assert first.iter_count == 2 and resumed.iter_count == full.iter_count == 4
    for (n, a), b in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(full.trainable_params, resumed.trainable_params):
        sa, sb = full.optimizer.state[a], resumed.optimizer.state[b]
        for key in ("step", "m_q", "m_scale", "v_q", "v_scale"):
            assert sa[key].dtype == sb[key].dtype and torch.equal(sa[key], sb[key]), key


# ---------------------------------------------------------------------------
# the optimizer's state exists once the trainer is built
# ---------------------------------------------------------------------------

STATE_KEYS = {"adamw": {"step", "exp_avg", "exp_avg_sq"},
              "adamw_8bit_fused": {"step", "m_q", "m_scale", "v_q", "v_scale"}, "lion": {"step", "exp_avg"}}


def _optimizer_config(tmp_path, name, **train):
    config = _fused_config(tmp_path, **train)
    if name == "lion":  # Lion takes no eps
        config.optimizer.kwargs.pop("eps")
    return config.evolve(optimizer=dict(name=name))


@pytest.mark.parametrize("name", sorted(STATE_KEYS))
def test_optimizer_state_exists_once_the_trainer_is_built(name, tmp_path):
    """Every trainable parameter has its whole state before the first step
    (as the reference's optax state exists from `opt.init`), zero moments
    and a zero count, and the state's bytes equal the preflight plan's
    opt_state row."""
    from trlx_tpu_torch.ops.adam8bit import state_bytes
    from trlx_tpu_torch.utils import memdoctor
    from trlx_tpu_torch.utils.loading import get_trainer

    config = _optimizer_config(tmp_path, name)
    trainer = get_trainer(config.train.trainer)(config=config, device="cpu")
    assert trainer.trainable_params and len(trainer.optimizer.state) == len(trainer.trainable_params)
    for p in trainer.trainable_params:
        st = trainer.optimizer.state[p]
        assert set(st) == STATE_KEYS[name] and int(st["step"]) == 0
        assert all(not v.any() for k, v in st.items() if k != "step")
    plan = memdoctor.estimate_plan(trainer)
    rows = [it.bytes for it in plan.items if it.component == "opt_state"]
    assert rows == [state_bytes(trainer.optimizer)] and rows[0] > 0


@pytest.mark.parametrize("name", sorted(STATE_KEYS))
def test_optimizer_state_made_at_build_steps_as_the_lazy_state(name, tmp_path, monkeypatch):
    """Two steps with the state made when the trainer is built, and two
    with the optimizer creating it inside its first step (the lazy path
    the optimizers keep for direct use): the losses, the parameters and
    the state are equal bit for bit."""
    eager = trlx_tpu_torch.train(samples=sft_t.SAMPLES, device="cpu",
                                 config=_optimizer_config(tmp_path / "eager", name, total_steps=2))
    monkeypatch.setattr(trainer_base, "init_optimizer_state", lambda optimizer: None)
    lazy = trlx_tpu_torch.train(samples=sft_t.SAMPLES, device="cpu",
                                config=_optimizer_config(tmp_path / "lazy", name, total_steps=2))
    losses = [[st["losses/loss"] for _, st in t.stats_history if "losses/loss" in st] for t in (eager, lazy)]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    for (n, a), b in zip(eager.model.named_parameters(), lazy.model.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(eager.trainable_params, lazy.trainable_params):
        sa, sb = eager.optimizer.state[a], lazy.optimizer.state[b]
        assert set(sa) == set(sb) == STATE_KEYS[name]
        for key in sa:
            assert sa[key].dtype == sb[key].dtype and torch.equal(sa[key], sb[key]), key


# ---------------------------------------------------------------------------
# the recipe's config files load and train, also under the memory doctor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["single_chip_1p3b", "test_config_minibatch"])
def test_recipe_configs_load_and_train(which, tmp_path):
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    tiny = dict(
        train=dict(batch_size=16, total_steps=2, seq_length=16, epochs=10, tracker=None, eval_interval=100,
                   checkpoint_dir=str(tmp_path)),
        model=dict(model_path="random", model_extra_configs={"transformer": dict(hidden_size=64, n_layer=2,
                                                                                 n_head=1, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=16, chunk_size=16, ppo_epochs=2, gen_kwargs=dict(max_new_tokens=4)),
    )
    if which == "single_chip_1p3b":
        import yaml

        with open(os.path.join(REPO, "configs", "mesh", "single_chip_1p3b.yml")) as f:
            recipe = yaml.safe_load(f)
        config = default_ppo_config().evolve(**recipe).evolve(**tiny).evolve(train=dict(minibatch_size=8))
        assert config.optimizer.name == "adamw_8bit_fused" and config.train.remat_policy == "full"
        assert config.model.model_extra_configs["transformer"]["decode_weights_quant"] == "int8"
    else:
        config = TRLConfig.load_yaml(os.path.join(REPO, "configs", "test_config.yml"))
        config = config.evolve(**tiny).evolve(train=dict(minibatch_size=8), model=dict(num_layers_unfrozen=-1))
    trainer = trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, config=config,
                                   device="cpu")
    assert trainer.iter_count == 2 and trainer.num_mb == 2
    doctored = trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, device="cpu",
                                    config=config.evolve(train=dict(memory={"enabled": True})))
    assert doctored.iter_count == 2 and doctored.num_mb == 2 and not doctored.memdoctor.degraded
    assert doctored._hbm_plan is not None and not doctored._hbm_plan.over_budget()


def test_measure_forward_probes_one_microbatch(tmp_path, monkeypatch):
    """train.timing_split's probe runs the first microbatch and scales by
    their number (the reference's `_measure_forward`)."""
    trainer = trlx_tpu_torch.train(samples=sft_t.SAMPLES, device="cpu", config=_fused_config(
        tmp_path, total_steps=1))
    batch = next(iter(trainer.create_train_dataloader()))
    seen = []
    loss_fn = trainer.loss
    monkeypatch.setattr(trainer, "loss", lambda b: seen.append(len(b.input_ids)) or loss_fn(b))
    assert trainer._measure_forward(batch) > 0
    assert seen == [8, 8]
    assert dataclasses.is_dataclass(batch) and len(batch.input_ids) == 16
