"""Policy LM + value head with the in-process frozen hydra reference
branch: the port of trlx_tpu.models.wrappers.CausalLMWithValueHead and
Seq2SeqLMWithValueHead; and `CausalLM`, the bare policy of SFT. Each
keeps its LM under `base`, so one base state dict moves between them.

One teacher-forced pass (`forward_train`) yields the policy logits, the
values and the reference logits: the trunk below `branch_at` is shared,
and the frozen top branch re-runs from the hidden state captured there
(for seq2seq, the top decoder blocks over the shared encoder output).
With `value_branch_at` (method.num_value_layers_unfrozen) the value head
reads a trainable copy of the top blocks and the final norm (`v_branch`),
re-run from the hidden state captured at that fork in the same trunk
pass.

Adapters (`models/peft.py`): a wrapper may carry `lora`, `prompt` or
`prefix` beside `base` (the trainer's `attach_peft`); every forward then
runs the adapter (LoRA inside the projections, the prompt or prefix as
`TransformerLM.forward` kwargs), `init_heads` draws its fresh values, the
trainer freezes the whole base, and the reference model is
`AdapterOffReference`: the same base with the adapter off, neither a
hydra branch nor a copy (the reference's peft contract).

`CausalLMWithILQLHeads` and `Seq2SeqLMWithILQLHeads` carry ILQL's head
group over the (decoder's) final hidden states: their forward gathers the
hidden rows at the actions and states before any head or the vocabulary
projection runs, and `make_logits_processor(beta)` is the sampler's
advantage shaping.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from trlx_tpu_torch.models.heads import (
    Head,
    ILQLHeads,
    apply_head,
    apply_ilql_heads,
    init_head,
    init_ilql_heads,
    sync_target_q_heads,
)
from trlx_tpu_torch.models.generation import cast_params_for_decode
from trlx_tpu_torch.models.lora import adapters_disabled
from trlx_tpu_torch.models.peft import adapter_call_kwargs, has_adapter, init_adapters
from trlx_tpu_torch.models.seq2seq import (
    Seq2SeqConfig,
    T5Branch,
    T5LM,
    extract_t5_branch_params,
    t5_logit_projection,
)
from trlx_tpu_torch.models.transformer import (
    Branch,
    TransformerConfig,
    TransformerLM,
    extract_branch_params,
    logit_projection,
)


class AdapterOffReference(nn.Module):
    """The reference model of an adapter run: the policy's own base with
    its adapter off (no LoRA term, no soft prompt or prefix). It holds no
    parameters of its own (the policy owns the base); attribute reads
    (`cfg`, `embed`, `lm_head`, ...) go to the base."""

    def __init__(self, base: nn.Module):
        super().__init__()
        self.__dict__["disabled_base"] = base

    def forward(self, *args, **kwargs):
        with adapters_disabled(self.disabled_base):
            return self.disabled_base(*args, **kwargs)

    def decode_copy(self, compute_dtype: torch.dtype) -> nn.Module:
        """The samplers' copy of the base with the adapter off (the
        speculative draft of an adapter run): no pair merged or kept."""
        with adapters_disabled(self.disabled_base):
            return cast_params_for_decode(self.disabled_base, compute_dtype)

    def __getattr__(self, name: str):
        try:
            return super().__getattr__(name)
        except AttributeError:
            base = self.__dict__.get("disabled_base")
            if base is None:
                raise
            return getattr(base, name)


class CausalLM(nn.Module):
    """The bare causal LM (the SFT policy): no heads, no reference."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.base = TransformerLM(cfg, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "CausalLM":
        self.base.init_params(generator)
        return self.init_heads(generator)

    @torch.no_grad()
    def init_heads(self, generator: torch.Generator) -> "CausalLM":
        init_adapters(self, generator)  # no heads
        return self

    def logit_project_fn(self):
        return logit_projection(self.base)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        return self.base(input_ids, attention_mask, compute_logits=compute_logits, **adapter_call_kwargs(self))


class ValueBranch(nn.Module):
    """The value branch: a trainable copy of the top blocks and the final
    norm, fed from the trunk's hidden state at its fork."""

    def __init__(self, blocks, ln_f):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f


class CausalLMWithValueHead(nn.Module):
    """`branch_at` (= n_layer - num_layers_unfrozen) picks where the frozen
    reference branch forks off; None means a full frozen copy.
    `value_branch_at` (= n_layer - num_value_layers_unfrozen) gives the
    value head its own trainable top blocks from that layer up; None
    means it reads the policy's final hidden state."""

    def __init__(
        self,
        cfg: TransformerConfig,
        branch_at: Optional[int] = None,
        value_branch_at: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        self.cfg = cfg
        self.branch_at = branch_at
        self.value_branch_at = value_branch_at
        self.base = TransformerLM(cfg, device)
        self.v_head = Head(cfg.hidden_size, 1, device=self.base.device)
        if value_branch_at is not None:
            self.v_branch = ValueBranch(
                [copy.deepcopy(b) for b in self.base.blocks[value_branch_at:]], copy.deepcopy(self.base.ln_f)
            )

    @classmethod
    def from_config(cls, config, device=None) -> "CausalLMWithValueHead":
        """Build the policy a TRLConfig describes: the architecture from
        `model.model_extra_configs["transformer"]`, the hydra fork from
        `model.num_layers_unfrozen`, the value branch from
        `method.num_value_layers_unfrozen`, dtypes from the train section."""
        mc = config.model
        if mc.model_arch_type != "causal":
            raise NotImplementedError(f"model_arch_type={mc.model_arch_type!r} is not ported")
        tdict = dict(mc.model_extra_configs.get("transformer", {}))
        tdict.setdefault("dtype", config.train.compute_dtype)
        tdict.setdefault("param_dtype", config.train.param_dtype)
        cfg = TransformerConfig(**tdict)
        k = mc.num_layers_unfrozen
        branch_at = cfg.n_layer - k if 0 < k < cfg.n_layer else None
        return cls(cfg, branch_at=branch_at, value_branch_at=value_branch_fork(cfg.n_layer, config.method),
                   device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "CausalLMWithValueHead":
        self.base.init_params(generator)
        return self.init_heads(generator)

    @torch.no_grad()
    def init_heads(self, generator: torch.Generator) -> "CausalLMWithValueHead":
        """A fresh value head, and the value branch copied from the base
        weights as they now are (the reference's `init_params`)."""
        init_head(self.v_head, generator)
        if self.value_branch_at is not None:
            for dst, src in zip(self.v_branch.blocks, self.base.blocks[self.value_branch_at:]):
                dst.load_state_dict(src.state_dict())
            self.v_branch.ln_f.load_state_dict(self.base.ln_f.state_dict())
        init_adapters(self, generator)
        return self

    def make_ref_params(self) -> nn.Module:
        """Frozen reference: the top branch (hydra), the base with the
        adapter off, or a full deep copy."""
        if self.branch_at is not None:
            return extract_branch_params(self.base, self.branch_at)
        if has_adapter(self):
            return AdapterOffReference(self.base)
        return copy.deepcopy(self.base).requires_grad_(False)

    def logit_project_fn(self):
        return logit_projection(self.base)

    def _multi_forward(self, input_ids, attention_mask, compute_logits):
        """The trunk pass capturing the hydra fork and the value fork (one
        capture when they coincide)."""
        points = tuple(sorted({p for p in (self.branch_at, self.value_branch_at) if p is not None}))
        out = self.base.forward_with_multi_capture(input_ids, attention_mask, points, compute_logits)
        named = dict(zip(points, out["captures"]))
        if self.branch_at is not None:
            out["branch_hidden"] = named[self.branch_at]
        if self.value_branch_at is not None:
            out["v_branch_hidden"] = named[self.value_branch_at]
        return out

    def _values(self, out: Dict[str, Any]) -> torch.Tensor:
        """The value head on the final hidden state, or on the value
        branch re-run from its captured fork with the trunk's attention
        bias and key mask. The capture is not detached: the value loss
        reaches the trainable trunk below the fork, as in the reference."""
        if self.value_branch_at is None:
            return apply_head(self.v_head, out["hidden_states"])[..., 0]
        h = self.base._run_blocks(self.v_branch.blocks, out["v_branch_hidden"], out["attn_bias"],
                                  key_mask=out["key_mask"], layer_offset=self.value_branch_at,
                                  positions=out["positions"])
        return apply_head(self.v_head, self.v_branch.ln_f(h))[..., 0]

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        if self.value_branch_at is None:
            out = self.base(input_ids, attention_mask, compute_logits=compute_logits, **adapter_call_kwargs(self))
        else:
            out = self._multi_forward(input_ids, attention_mask, compute_logits)
        return dict(out, values=self._values(out))

    def forward_train(
        self,
        ref_params: nn.Module,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        """One pass producing policy logits, values AND reference logits."""
        if self.branch_at is None:
            out = self.forward(input_ids, attention_mask, compute_logits)
            ref_out = ref_params(input_ids, attention_mask, compute_logits=compute_logits)
        else:
            out = self._multi_forward(input_ids, attention_mask, compute_logits)
            out["values"] = self._values(out)
            if not isinstance(ref_params, Branch):
                raise TypeError("hydra forward_train needs the Branch from make_ref_params()")
            ref_out = self.base.forward_from_layer(
                ref_params,
                out["branch_hidden"].detach(),
                out["attn_bias"],
                out["positions"],
                key_mask=out["key_mask"],
                compute_logits=compute_logits,
            )
        return dict(
            out,
            ref_logits=ref_out["logits"].detach() if compute_logits else None,
            ref_hidden=ref_out["hidden_states"].detach(),
        )


def value_branch_fork(n_layer: int, method) -> Optional[int]:
    """Where the value branch forks: n_layer - num_value_layers_unfrozen
    for 0 < that < n_layer, else None (no branch)."""
    nv = getattr(method, "num_value_layers_unfrozen", 0)
    return n_layer - nv if nv and 0 < nv < n_layer else None


class Seq2SeqLMWithValueHead(nn.Module):
    """Encoder-decoder policy + value head over the decoder's hidden
    states; `branch_at` (= n_decoder_layer - num_layers_unfrozen) picks
    where the frozen top-decoder reference branch forks off, None means a
    full frozen copy."""

    def __init__(self, cfg: Seq2SeqConfig, branch_at: Optional[int] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.branch_at = branch_at
        self.base = T5LM(cfg, device)
        self.v_head = Head(cfg.d_model, 1, device=self.base.device)

    @classmethod
    def from_config(cls, config, device=None) -> "Seq2SeqLMWithValueHead":
        """Build the policy a TRLConfig describes: the architecture from
        `model.model_extra_configs["seq2seq"]`, the hydra fork from
        `model.num_layers_unfrozen`, dtypes from the train section."""
        mc = config.model
        if mc.model_arch_type != "seq2seq":
            raise ValueError(f"model_arch_type={mc.model_arch_type!r}: use CausalLMWithValueHead")
        sdict = dict(mc.model_extra_configs.get("seq2seq", {}))
        sdict.setdefault("dtype", config.train.compute_dtype)
        sdict.setdefault("param_dtype", config.train.param_dtype)
        cfg = Seq2SeqConfig(**sdict)
        k = mc.num_layers_unfrozen
        branch_at = cfg.n_decoder_layer - k if 0 < k < cfg.n_decoder_layer else None
        return cls(cfg, branch_at=branch_at, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Seq2SeqLMWithValueHead":
        self.base.init_params(generator)
        return self.init_heads(generator)

    @torch.no_grad()
    def init_heads(self, generator: torch.Generator) -> "Seq2SeqLMWithValueHead":
        init_head(self.v_head, generator)
        init_adapters(self, generator)
        return self

    def make_ref_params(self) -> nn.Module:
        """Frozen reference: the top decoder branch (hydra), the base with
        the LoRA adapter off, or a full deep copy."""
        if self.branch_at is not None:
            return extract_t5_branch_params(self.base, self.branch_at)
        if has_adapter(self):
            return AdapterOffReference(self.base)
        return copy.deepcopy(self.base).requires_grad_(False)

    def logit_project_fn(self):
        return t5_logit_projection(self.base, self.cfg)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        decoder_input_ids: torch.Tensor,
        decoder_attention_mask: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        out = self.base(input_ids, attention_mask, decoder_input_ids, decoder_attention_mask,
                        compute_logits=compute_logits)
        return dict(out, values=apply_head(self.v_head, out["hidden_states"])[..., 0])

    def forward_train(
        self,
        ref_params: nn.Module,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        decoder_input_ids: torch.Tensor,
        decoder_attention_mask: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        """One pass producing policy logits, values AND reference logits."""
        if self.branch_at is None:
            out = self.forward(input_ids, attention_mask, decoder_input_ids, decoder_attention_mask,
                               compute_logits)
            ref_out = ref_params(input_ids, attention_mask, decoder_input_ids, decoder_attention_mask,
                                 compute_logits=compute_logits)
        else:
            if not isinstance(ref_params, T5Branch):
                raise TypeError("hydra forward_train needs the T5Branch from make_ref_params()")
            out = self.base.forward_with_branch_capture(
                input_ids, attention_mask, decoder_input_ids, decoder_attention_mask,
                self.branch_at, compute_logits,
            )
            out["values"] = apply_head(self.v_head, out["hidden_states"])[..., 0]
            ref_out = self.base.forward_from_layer(
                ref_params,
                out["branch_hidden"].detach(),
                out["self_bias"],
                out["encoder_hidden"].detach(),
                out["cross_bias"],
                compute_logits=compute_logits,
                pos_bias=out["pos_bias"],
                skey_mask=out["skey_mask"],
                ckey_mask=out["ckey_mask"],
            )
        return dict(
            out,
            ref_logits=ref_out["logits"].detach() if compute_logits else None,
            ref_hidden=ref_out["hidden_states"].detach(),
        )


class _ILQLHeadsMixin:
    """What the two ILQL wrappers share: the heads' init, the Polyak sync
    and the sampler's logits processor."""

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        self.base.init_params(generator)
        return self.init_heads(generator)

    @torch.no_grad()
    def init_heads(self, generator: torch.Generator):
        init_ilql_heads(self.heads, generator)
        init_adapters(self, generator)
        return self

    def sync_target(self, alpha: Optional[float] = None):
        """target <- alpha * q + (1 - alpha) * target (`alpha` defaults to
        the method's)."""
        sync_target_q_heads(self.heads, self.alpha if alpha is None else alpha)
        return self

    def _at_actions(self, hidden, states_ixs, actions_ixs):
        """(logits at the actions, (qs, target_qs, vs)): the hidden rows are
        gathered, then projected, so the vocabulary product is [B, A, V]."""
        from trlx_tpu_torch.ops.common import batched_index_select

        qvs = apply_ilql_heads(self.heads, hidden, states_ixs, actions_ixs)
        h_at = batched_index_select(hidden, actions_ixs, dim=1)
        return self.logit_project_fn()(h_at), qvs

    def make_logits_processor(self, beta: float):
        """`(hidden_last, logits_last) -> log_softmax(logits) + beta * (min
        target Q - V)` over [B, E] and [B, V], with the heads as they are
        when it is called."""
        from trlx_tpu_torch.ops.ilql import ilql_shape_logits

        heads = self.heads

        def processor(hidden_last: torch.Tensor, logits_last: torch.Tensor) -> torch.Tensor:
            qs = [apply_head(h, hidden_last) for h in heads.target_q_heads]
            return ilql_shape_logits(logits_last, qs, apply_head(heads.v_head, hidden_last), beta)

        return processor


class CausalLMWithILQLHeads(_ILQLHeadsMixin, nn.Module):
    """Causal LM + ILQL heads (v, q, frozen target q)."""

    def __init__(self, cfg: TransformerConfig, two_qs: bool = True, alpha: float = 0.001, device=None):
        super().__init__()
        self.cfg = cfg
        self.two_qs = two_qs
        self.alpha = alpha
        self.base = TransformerLM(cfg, device)
        self.heads = ILQLHeads(cfg.hidden_size, cfg.vocab_size, two_qs, device=self.base.device)

    def logit_project_fn(self):
        return logit_projection(self.base)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        states_ixs: torch.Tensor,
        actions_ixs: torch.Tensor,
    ):
        """(logits_at_actions, (qs, target_qs, vs)): what `ilql_loss` takes."""
        out = self.base(input_ids, attention_mask, compute_logits=False, **adapter_call_kwargs(self))
        return self._at_actions(out["hidden_states"], states_ixs, actions_ixs)


class Seq2SeqLMWithILQLHeads(_ILQLHeadsMixin, nn.Module):
    """Encoder-decoder LM + ILQL heads over the decoder's hidden states;
    the indices run over decoder positions."""

    def __init__(self, cfg: Seq2SeqConfig, two_qs: bool = True, alpha: float = 0.001, device=None):
        super().__init__()
        self.cfg = cfg
        self.two_qs = two_qs
        self.alpha = alpha
        self.base = T5LM(cfg, device)
        self.heads = ILQLHeads(cfg.d_model, cfg.vocab_size, two_qs, device=self.base.device)

    def logit_project_fn(self):
        return t5_logit_projection(self.base, self.cfg)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        decoder_input_ids: torch.Tensor,
        states_ixs: torch.Tensor,
        actions_ixs: torch.Tensor,
    ):
        out = self.base(input_ids, attention_mask, decoder_input_ids, compute_logits=False)
        return self._at_actions(out["hidden_states"], states_ixs, actions_ixs)
