"""Offline ILQL (port of trlx_tpu.trainer.ilql): reward-labelled samples
become an ILQL store whose normalised return sits on each sample's last
action; the loss is `ops.ilql.ilql_loss` over the wrapper's gathered
logits, Q and V heads; the target Q heads stay out of the optimizer and
move only by the Polyak sync every `steps_for_target_q_sync` steps; and
sampling (evaluation) shapes the policy's logits by beta * (min Q - V)
through the base trainer's logits-processor hook, with `beta` swept one
value per call when the config lists several."""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from trlx_tpu_torch.data.method_configs import ILQLConfig
from trlx_tpu_torch.models.wrappers import CausalLMWithILQLHeads, Seq2SeqLMWithILQLHeads
from trlx_tpu_torch.ops.ilql import ilql_loss
from trlx_tpu_torch.pipeline.offline_pipeline import (
    ILQLRolloutStorage,
    ILQLSeq2SeqRolloutStorage,
    tokenize_dialogue,
)
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TPUBaseTrainer
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def _normalized_returns(rewards: List[float], all_actions_ixs: List[List[int]]) -> List[List[float]]:
    """Each sample's per-action rewards: zeros, and on its last action the
    return standardised over the dataset (float64; left unscaled when the
    std is 0 or NaN)."""
    returns = np.asarray(rewards, np.float64)
    returns = returns - returns.mean()
    std = returns.std()
    if not np.isnan(std) and std > 0:
        returns = returns / (std + np.finfo(returns.dtype).eps)
    out = []
    for acts, ret in zip(all_actions_ixs, returns):
        rs = [0.0] * len(acts)
        rs[-1] = float(ret)
        out.append(rs)
    return out


def make_experience(
    samples: Union[List[str], List[tuple]],
    rewards: List[float],
    tokenizer=None,
    max_length: int = 2048,
    verbose: bool = True,
) -> ILQLRolloutStorage:
    """Tokenize dialogues (when a tokenizer is given), take every output
    token as an action (the state before it predicts it) plus the last
    position as the terminal state, and place the normalised return on
    the final action."""
    if verbose:
        logger.info("Collecting rollouts")
    if tokenizer is not None:
        samples = [tokenize_dialogue(s, tokenizer, max_length) for s in samples]

    all_input_ids, all_actions_ixs, all_states_ixs, all_dones = [], [], [], []
    for sample in samples:
        length = 0
        all_input_ids.append([t for m in sample for t in m.tokens])
        actions_ixs = []
        for dm in sample:
            if dm.is_output:
                actions_ixs.append(np.arange(length - 1, length + len(dm.tokens) - 1))
            length += len(dm.tokens)
        if not actions_ixs:
            raise ValueError("sample has no output tokens")
        acts = np.concatenate(actions_ixs)
        states = np.concatenate([acts, [length - 1]])
        all_actions_ixs.append(acts.tolist())
        all_states_ixs.append(states.tolist())
        all_dones.append([1] * (len(states) - 1) + [0])

    attention_masks = [[1] * len(ids) for ids in all_input_ids]
    return ILQLRolloutStorage(all_input_ids, attention_masks, _normalized_returns(rewards, all_actions_ixs),
                              all_states_ixs, all_actions_ixs, all_dones)


def make_experience_seq2seq(
    samples, rewards, tokenizer=None, max_length: int = 2048, verbose: bool = True,
    decoder_start_token_id: int = 0,
) -> ILQLSeq2SeqRolloutStorage:
    """The seq2seq store: the prompt phrases are the encoder input, the
    decoder rows are [decoder_start] ++ the output tokens, and the indices
    run over decoder positions. The loss reads the actions from
    decoder_input_ids[:, 1:], so position 0 is pure conditioning; without
    the start token the start -> first-token transition would never train,
    and sampling, which starts every row from it, would emit EOS at once."""
    if verbose:
        logger.info("Collecting rollouts")
    if tokenizer is not None:
        samples = [tokenize_dialogue(s, tokenizer, max_length) for s in samples]

    all_input_ids, all_output_ids = [], []
    all_actions_ixs, all_states_ixs, all_dones = [], [], []
    for sample in samples:
        inputs = [m for m in sample if not m.is_output]
        outputs = [m for m in sample if m.is_output]
        if not outputs:
            raise ValueError("sample has no output tokens")
        all_input_ids.append([t for m in inputs for t in m.tokens])
        out_tokens = [int(decoder_start_token_id)] + [t for m in outputs for t in m.tokens]
        all_output_ids.append(out_tokens)
        acts = list(range(len(out_tokens) - 1))
        states = acts + [len(out_tokens) - 1]
        all_actions_ixs.append(acts)
        all_states_ixs.append(states)
        all_dones.append([1] * (len(states) - 1) + [0])

    attention_masks = [[1] * len(ids) for ids in all_input_ids]
    return ILQLSeq2SeqRolloutStorage(all_input_ids, attention_masks, all_output_ids,
                                     _normalized_returns(rewards, all_actions_ixs), all_states_ixs,
                                     all_actions_ixs, all_dones)


@register_trainer("TPUILQLTrainer")
class TPUILQLTrainer(TPUBaseTrainer):
    def __init__(self, config, **kwargs):
        if not isinstance(config.method, ILQLConfig):
            raise ValueError("config.method must be ILQLConfig")
        super().__init__(config, **kwargs)

    def setup_model(self) -> None:
        """The LM with its ILQL heads: random weights from train.seed, or the
        weights of a saved directory (its heads too when it held them). The
        target heads are built without gradients, so they stay out of the
        optimizer: the reference masks their updates, weight decay
        included."""
        method = self.config.method
        if self.seq2seq:
            self.model = Seq2SeqLMWithILQLHeads(self.load_seq2seq_base(), two_qs=method.two_qs,
                                                alpha=method.alpha, device=self.device)
        else:
            self.model = CausalLMWithILQLHeads(self.load_base_model(), two_qs=method.two_qs,
                                               alpha=method.alpha, device=self.device)
        self.init_weights()

    def loss(self, batch):
        batch = batch.map(lambda x: x.to(self.device))
        if self.seq2seq:
            logits, qvs = self.model(batch.input_ids, batch.attention_mask, batch.decoder_input_ids,
                                     batch.states_ixs, batch.actions_ixs)
        else:
            logits, qvs = self.model(batch.input_ids, batch.attention_mask, batch.states_ixs, batch.actions_ixs)
        m = self.config.method
        return ilql_loss(logits, *qvs, batch, tau=m.tau, gamma=m.gamma, cql_scale=m.cql_scale,
                         awac_scale=m.awac_scale, beta=m.beta, two_qs=m.two_qs)

    def generation_logits_processor(self, beta: Optional[float] = None):
        """The advantage shaping with `beta` from the call (evaluation's
        sweep passes one value per call) or else the config's scalar (the
        first value of a swept list)."""
        if beta is None:
            beta = self.config.method.gen_kwargs.get("beta", 1.0)
            if isinstance(beta, (list, tuple)):
                beta = beta[0]
        return self.model.make_logits_processor(float(beta))

    def make_experience(self, samples, rewards, seq_length: int = 1024) -> None:
        if self.seq2seq:
            self.store = make_experience_seq2seq(samples, rewards, self.tokenizer, seq_length,
                                                 decoder_start_token_id=self.model.cfg.decoder_start_token_id)
        else:
            self.store = make_experience(samples, rewards, self.tokenizer, seq_length)

    def prepare_learning(self) -> None:
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.n_inner_epochs = 1
        n_batches = len(self.store) // self.config.train.batch_size
        self.total_steps = min(self.config.train.epochs * max(n_batches, 1), self.config.train.total_steps)

    def create_train_dataloader(self):
        return self.store.create_loader(self.config.train.batch_size, shuffle=True, drop_last=True,
                                        seed=self.config.train.seed + self._loader_iter)

    def post_backward_callback(self) -> None:
        """The Polyak sync, at the end of each pass over the store when the
        step count is a multiple of `steps_for_target_q_sync`: after that
        step's evaluation, as in the reference's loop."""
        if self.iter_count % self.config.method.steps_for_target_q_sync == 0:
            self.model.sync_target(self.config.method.alpha)
