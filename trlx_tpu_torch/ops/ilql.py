"""ILQL numerics (port of trlx_tpu.ops.ilql): the TD Q loss over the
non-terminal actions, the expectile V loss, CQL's cross-entropy on every
Q head, the AWAC-weighted policy cross-entropy, and the advantage-shaped
sampling logits `log_softmax(logits) + beta * (min Q - V)`."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from trlx_tpu_torch.ops.common import flatten_dict, get_tensor_stats, topk_mask


def ilql_loss(
    logits: torch.Tensor,  # [batch, n_actions, vocab], already gathered at the actions
    qs: Sequence[torch.Tensor],  # each [batch, n_actions, vocab]
    target_qs: Sequence[torch.Tensor],
    vs: torch.Tensor,  # [batch, n_states, 1]; n_states = n_actions + 1
    labels,  # ILQLBatch (actions from input_ids) or ILQLSeq2SeqBatch
    tau: float,
    gamma: float,
    cql_scale: float,
    awac_scale: float,
    beta: float,
    two_qs: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The ILQL loss and its stats, keyed as the reference flattens them
    (`losses/loss`, `values/mean`, `qvalues/0/max`, `awac_weight/std`, ...)."""
    from trlx_tpu_torch.data import ILQLBatch

    dones = labels.dones.float()
    terminal_mask = dones[:, :-1]  # [batch, n_actions]
    n_nonterminal = torch.clamp(terminal_mask.sum(), min=1.0)

    if isinstance(labels, ILQLBatch):
        actions = torch.gather(labels.input_ids[:, 1:].long(), 1, labels.actions_ixs.long())
    else:
        actions = labels.decoder_input_ids[:, 1:].long()
    actions = actions.unsqueeze(-1)  # [batch, n_actions, 1]

    def pick(q):
        return torch.gather(q, -1, actions)[..., 0]

    Q = [pick(q) for q in qs]
    with torch.no_grad():
        target_q = torch.minimum(*[pick(q) for q in target_qs]) if two_qs else pick(target_qs[0])

    V = vs[:, :-1, 0]  # values of the current states
    v_next = vs[:, 1:, 0].detach() * dones[:, 1:]
    q_target = labels.rewards + gamma * v_next

    loss_q = sum((((Qi - q_target) * terminal_mask) ** 2).sum() / n_nonterminal for Qi in Q)

    # expectile regression of V toward the target heads' min Q
    vdiff2 = (target_q - V) ** 2
    loss_v = (torch.where(target_q >= V, tau * vdiff2, (1 - tau) * vdiff2) * terminal_mask).sum() / n_nonterminal

    def masked_xent(scores):
        logp = torch.log_softmax(scores.float(), dim=-1)
        return -torch.gather(logp, -1, actions)[..., 0]  # [batch, n_actions]

    loss_cql = sum((masked_xent(q) * terminal_mask).sum() / n_nonterminal for q in qs)

    cross_entropy = masked_xent(logits)
    awac_weight = torch.exp(beta * (target_q - V)).detach()
    loss_awac = (cross_entropy * awac_weight * terminal_mask).sum() / n_nonterminal

    loss = loss_q + loss_v + cql_scale * loss_cql + awac_scale * loss_awac

    stats = dict(
        losses=dict(loss=loss, loss_q=loss_q, loss_v=loss_v, loss_cql=loss_cql, loss_awac=loss_awac),
        values=get_tensor_stats(V, terminal_mask, n_nonterminal),
        qvalues={str(ix): get_tensor_stats(Q[ix], terminal_mask, n_nonterminal) for ix in range(len(Q))},
        awac_weight=get_tensor_stats(awac_weight, terminal_mask, n_nonterminal),
    )
    return loss, flatten_dict(stats)


def ilql_shape_logits(
    logits: torch.Tensor,  # [batch, vocab] last-position logits
    qs: Sequence[torch.Tensor],  # each [batch, vocab]
    vs: torch.Tensor,  # [batch, 1]
    beta: float,
    top_k: int = 0,
) -> torch.Tensor:
    """The sampling logits of ILQL's inference-time policy improvement:
    log pi + beta * (min Q - V), in fp32."""
    min_q = qs[0] if len(qs) == 1 else torch.minimum(*qs)
    shaped = torch.log_softmax(logits.float(), dim=-1) + beta * (min_q - vs)
    if top_k:
        shaped = topk_mask(shaped, top_k)
    return shaped
