"""Policy LM + value head with the in-process frozen hydra reference
branch: the port of trlx_tpu.models.wrappers.CausalLMWithValueHead and
Seq2SeqLMWithValueHead.

One teacher-forced pass (`forward_train`) yields the policy logits, the
values and the reference logits: the trunk below `branch_at` is shared,
and the frozen top branch re-runs from the hidden state captured there
(for seq2seq, the top decoder blocks over the shared encoder output).
The value branch, LoRA and other peft adapters are not ported yet and
raise.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from trlx_tpu_torch.models.heads import Head, apply_head, init_head
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


class CausalLMWithValueHead(nn.Module):
    """`branch_at` (= n_layer - num_layers_unfrozen) picks where the frozen
    reference branch forks off; None means a full frozen copy."""

    def __init__(
        self,
        cfg: TransformerConfig,
        branch_at: Optional[int] = None,
        value_branch_at: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        if value_branch_at is not None:
            raise NotImplementedError("the value branch is not ported yet")
        self.cfg = cfg
        self.branch_at = branch_at
        self.base = TransformerLM(cfg, device)
        self.v_head = Head(cfg.hidden_size, 1, device=self.base.device)

    @classmethod
    def from_config(cls, config, device=None) -> "CausalLMWithValueHead":
        """Build the policy a TRLConfig describes: the architecture from
        `model.model_extra_configs["transformer"]`, the hydra fork from
        `model.num_layers_unfrozen`, dtypes from the train section."""
        mc = config.model
        if mc.model_arch_type != "causal":
            raise NotImplementedError(f"model_arch_type={mc.model_arch_type!r} is not ported")
        if mc.peft_config is not None:
            raise NotImplementedError("peft adapters are not ported yet")
        if getattr(config.method, "num_value_layers_unfrozen", 0):
            raise NotImplementedError("the value branch is not ported yet")
        tdict = dict(mc.model_extra_configs.get("transformer", {}))
        tdict.setdefault("dtype", config.train.compute_dtype)
        tdict.setdefault("param_dtype", config.train.param_dtype)
        cfg = TransformerConfig(**tdict)
        k = mc.num_layers_unfrozen
        branch_at = cfg.n_layer - k if 0 < k < cfg.n_layer else None
        return cls(cfg, branch_at=branch_at, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "CausalLMWithValueHead":
        self.base.init_params(generator)
        init_head(self.v_head, generator)
        return self

    def make_ref_params(self) -> nn.Module:
        """Frozen reference: the top branch (hydra) or a full deep copy."""
        if self.branch_at is not None:
            return extract_branch_params(self.base, self.branch_at)
        return copy.deepcopy(self.base).requires_grad_(False)

    def logit_project_fn(self):
        return logit_projection(self.base)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        out = self.base(input_ids, attention_mask, compute_logits=compute_logits)
        return dict(out, values=apply_head(self.v_head, out["hidden_states"])[..., 0])

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
            out = self.base.forward_with_multi_capture(
                input_ids, attention_mask, (self.branch_at,), compute_logits
            )
            out["branch_hidden"] = out["captures"][0]
            out["values"] = apply_head(self.v_head, out["hidden_states"])[..., 0]
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
        if mc.peft_config is not None:
            raise NotImplementedError("peft adapters are not ported yet (ROADMAP queue 7)")
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
        init_head(self.v_head, generator)
        return self

    def make_ref_params(self) -> nn.Module:
        """Frozen reference: the top decoder branch (hydra) or a full deep copy."""
        if self.branch_at is not None:
            return extract_t5_branch_params(self.base, self.branch_at)
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
