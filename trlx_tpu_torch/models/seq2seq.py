"""The T5-family encoder-decoder: the port of trlx_tpu.models.seq2seq.

The JAX reference scans stacked block parameters; here each stack is an
`nn.ModuleList` run by a Python loop, and the hydra reference branch is a
frozen deep copy of the top decoder blocks (`extract_t5_branch_params`).
Parameter names follow the reference (`encoder.blocks.{i}.self_attn.q.kernel`,
`decoder.rel_bias`, `shared.wte`, ...), with the (H, d_kv) axes of the
attention kernels flattened; `models/convert.py` maps a JAX tree onto them.

T5 specifics kept: RMS norm without bias, no 1/sqrt(d) score scale (folded
into the init), one learned relative-position table [buckets, H] per stack
shared by its layers, ReLU or gated-GELU MLPs, logits scaled by
d_model^-0.5 when the embeddings are tied. Numerics follow the reference:
params in `param_dtype`, matmuls in `dtype`, norms in fp32, scores and
logits accumulated in fp32.

Attention dispatch keeps the reference's knob:
- `attention_impl="pallas"` runs the fused kernels in every teacher-forced
  stack pass: the bias-carrying flash kernels (`flash_attention_bias`)
  with the learned bias for the encoder's and the decoder's
  self-attention, whose dbias trains the tables, and the plain flash
  kernels (`flash_attention`, not causal, scale 1) for cross-attention.
  The kernels take any T and S, so the TPU's S % 128 gate is gone.
- `"xla"` runs the reference's combined-bias einsum/softmax math.
Decode steps over the KV cache always take the einsum path, as in the
reference (the cross-attention recomputes the encoder's K/V every step,
as there).

Int8 decode weights (`decode_weights_quant="int8"`): the sampler's decode
copy holds the decoder blocks' projections as int8 kernels with
per-output-channel scales (the encoder runs once, in full precision), and
`Dense` runs the W8A16 product (`ops.int8_matmul`). `remat` (the trainer's
resolved `train.remat_policy`) checkpoints each block of a pass that
records a graph, in both stacks (`ops.remat`).

Not ported, raising NotImplementedError: pipeline parallelism
(`pp_microbatches`, a mesh; ROADMAP queue 12).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.lora import adapter_of
from trlx_tpu_torch.models.transformer import NEG_INF, to_torch_dtype
from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bias
from trlx_tpu_torch.ops.int8_matmul import int8_weight_matmul
from trlx_tpu_torch.ops.remat import checkpoint_block
from trlx_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Seq2SeqConfig:
    """Field for field the reference's Seq2SeqConfig, so
    `model_extra_configs["seq2seq"]` dicts load unchanged; `dtype` and
    `param_dtype` accept torch dtypes or their names."""

    vocab_size: int
    d_model: int
    n_layer: int  # encoder layers
    n_decoder_layer: Optional[int] = None  # default n_layer
    n_head: int = 8
    d_kv: int = 64
    d_ff: int = 2048
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    activation: str = "relu"  # "relu" | "gated-gelu"
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attention_impl: str = "xla"  # "xla" | "pallas" (the fused kernels)
    decode_weights_quant: Optional[str] = None
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"

    def __post_init__(self):
        if self.n_decoder_layer is None:
            object.__setattr__(self, "n_decoder_layer", self.n_layer)
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", to_torch_dtype(self.param_dtype))

    def replace(self, **kw) -> "Seq2SeqConfig":
        return dataclasses.replace(self, **kw)


def check_ported(cfg: Seq2SeqConfig) -> None:
    """Raise NotImplementedError for a knob of a part not ported yet."""
    if cfg.decode_weights_quant not in (None, "int8"):
        raise ValueError(f"decode_weights_quant={cfg.decode_weights_quant!r} (None or 'int8')")
    if cfg.pp_microbatches:
        raise NotImplementedError("pipeline parallelism (pp_microbatches) is not ported yet (ROADMAP queue 12)")
    if cfg.attention_impl not in ("xla", "pallas"):
        raise NotImplementedError(f"attention_impl={cfg.attention_impl!r} is not ported")


def relative_position_bucket(
    relative_position: torch.Tensor, bidirectional: bool, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """T5's log-binned relative position bucketing, in the reference's fp32
    arithmetic (the same integers)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_range = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32, device=n.device))
    val_large = max_exact + (
        torch.log(torch.clamp(n, min=1).float() / max_exact) / log_range * (num_buckets - max_exact)
    ).to(ret.dtype)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def compute_position_bias(
    rel_bias_table: torch.Tensor,  # [n_buckets, n_head]
    q_pos: torch.Tensor,  # [T]
    k_pos: torch.Tensor,  # [S]
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """[1, n_head, T, S] fp32 additive attention bias, gathered head-major."""
    rel = k_pos[None, :] - q_pos[:, None]
    buckets = relative_position_bucket(rel, bidirectional, num_buckets, max_distance)
    return rel_bias_table.t()[:, buckets][None].float()


def compute_position_bias_dense(
    rel_bias_table: torch.Tensor,  # [n_buckets, n_head]
    T: int,
    S: int,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """[1, n_head, T, S] bias for consecutive positions (arange(T) against
    arange(S)), from its Toeplitz structure: the bias depends on s - t
    alone, so a [H, T + S - 1] vector over the diagonals is gathered once
    and row t is its window starting at (T - 1) - t (`unfold`, then
    reversed). Equal to `compute_position_bias` on the same positions."""
    rel_vec = torch.arange(T + S - 1, device=rel_bias_table.device) - (T - 1)  # s - t per diagonal
    buckets = relative_position_bucket(rel_vec, bidirectional, num_buckets, max_distance)
    bias_rel = rel_bias_table.t()[:, buckets]  # [H, T + S - 1]
    return bias_rel.unfold(1, S, 1).flip(1)[None].float()


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class T5Norm(nn.Module):
    """RMS norm without bias or mean, in fp32, cast back to the input dtype."""

    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.eps = cfg.layer_norm_epsilon
        self.scale = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.scale.float()).to(x.dtype)


class Dense(nn.Module):
    """Linear map without bias: `kernel` [in, out] (the reference's input
    dims and feature dims flattened); the product runs in `dtype`. A LoRA
    pair attached to it (`models/lora.py`) adds its unmerged term. In the
    sampler's int8 decode copy the kernel is int8 with `kernel_scale`, and
    the product the W8A16 one."""

    def __init__(self, in_features: int, out_features: int, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, dtype=cfg.param_dtype, device=device))
        self.register_buffer("kernel_scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_scale is not None:
            y = int8_weight_matmul(x.to(self.dtype), self.kernel, self.kernel_scale)
        else:
            y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        pair = adapter_of(self)
        return y if pair is None else y + pair.delta(x, self.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.n_head * cfg.d_kv
        self.q = Dense(cfg.d_model, inner, cfg, device)
        self.k = Dense(cfg.d_model, inner, cfg, device)
        self.v = Dense(cfg.d_model, inner, cfg, device)
        self.o = Dense(inner, cfg.d_model, cfg, device)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, E] queries
        kv: torch.Tensor,  # [B, S, E] keys/values source
        bias: Optional[torch.Tensor],  # [B or 1, 1 or H, T, S] additive; None: the fused path
        cache: Optional[Dict] = None,  # the decoder's whole self-attention cache
        ix: int = 0,  # this layer's index into the stacked cache
        pos_bias: Optional[torch.Tensor] = None,  # [1, H, T, S] learned bias (fused path)
        key_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = attendable (fused path)
        causal: bool = False,
    ) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        H, Dk = cfg.n_head, cfg.d_kv
        q = self.q(x).view(B, T, H, Dk)
        k = self.k(kv).view(B, kv.shape[1], H, Dk)
        v = self.v(kv).view(B, kv.shape[1], H, Dk)
        if cache is not None:
            # write this step's K/V into the stacked cache IN PLACE (the
            # reference's functional update-carry), then attend over it
            idx = cache["index"]
            cache["k"][ix, :, idx:idx + T] = k
            cache["v"][ix, :, idx:idx + T] = v
            k, v = cache["k"][ix], cache["v"][ix]
        if bias is None:
            # the fused kernels (T5 has no 1/sqrt(d): sm_scale 1.0)
            qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            if pos_bias is not None:
                out = flash_attention_bias(qT, kT, vT, key_mask, pos_bias[0], causal=causal, sm_scale=1.0)
            else:
                out = flash_attention(qT, kT, vT, key_mask, causal=False, sm_scale=1.0)
            out = out.transpose(1, 2).to(cfg.dtype)
        else:
            scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) + bias
            probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhts,bshd->bthd", probs, v.to(cfg.dtype))
        return self.o(out.reshape(B, T, H * Dk))


class T5MLP(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.gated = cfg.activation == "gated-gelu"
        self.fc_in = Dense(cfg.d_model, cfg.d_ff, cfg, device)
        if self.gated:
            self.fc_gate = Dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.fc_out = Dense(cfg.d_ff, cfg.d_model, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = F.gelu(self.fc_in(x), approximate="tanh") * self.fc_gate(x)
        else:
            h = torch.relu(self.fc_in(x))
        return self.fc_out(h)


class T5Block(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, is_decoder: bool, device=None):
        super().__init__()
        self.is_decoder = is_decoder
        self.ln_1 = T5Norm(cfg, device)
        self.self_attn = T5Attention(cfg, device)
        if is_decoder:
            self.ln_cross = T5Norm(cfg, device)
            self.cross_attn = T5Attention(cfg, device)
        self.ln_2 = T5Norm(cfg, device)
        self.mlp = T5MLP(cfg, device)

    def forward(self, x, self_bias, enc_out=None, cross_bias=None, pos_bias=None, skey_mask=None,
                ckey_mask=None, cache=None, ix=0):
        h = self.ln_1(x)
        x = x + self.self_attn(h, h, self_bias, cache, ix, pos_bias=pos_bias, key_mask=skey_mask,
                               causal=self.is_decoder)
        if self.is_decoder and enc_out is not None:
            h = self.ln_cross(x)
            x = x + self.cross_attn(h, enc_out, cross_bias, key_mask=ckey_mask)
        return x + self.mlp(self.ln_2(x))


class T5Stack(nn.Module):
    """One stack: its blocks, its final norm and its relative-bias table."""

    def __init__(self, cfg: Seq2SeqConfig, n_layer: int, is_decoder: bool, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(T5Block(cfg, is_decoder, device) for _ in range(n_layer))
        self.ln_f = T5Norm(cfg, device)
        self.rel_bias = nn.Parameter(torch.empty(
            cfg.relative_attention_num_buckets, cfg.n_head, dtype=cfg.param_dtype, device=device))


class Shared(nn.Module):
    """The token embedding shared by encoder, decoder and (tied) logits."""

    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=device))


class LMHead(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size, dtype=cfg.param_dtype, device=device))


class T5Branch(nn.Module):
    """The frozen hydra reference branch: the top decoder blocks, the
    decoder's final norm, the embedding and the untied head if any."""

    def __init__(self, blocks, ln_f: T5Norm, shared: Shared, lm_head: Optional[LMHead]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f
        self.shared = shared
        if lm_head is not None:
            self.lm_head = lm_head


def t5_logit_projection(model: nn.Module, cfg: Seq2SeqConfig):
    """hidden -> fp32 logits closure over a `T5LM` or `T5Branch`, with the
    reference's numerics: the tied-embedding d_model^-0.5 scale applied in
    the hidden's dtype, compute-dtype operands, fp32 accumulation."""
    if hasattr(model, "lm_head"):
        kernel = model.lm_head.kernel

        def proj(h: torch.Tensor) -> torch.Tensor:
            return torch.matmul(h.float(), kernel.to(h.dtype).float())

        return proj
    wte = model.shared.wte
    scale = cfg.d_model ** -0.5

    def proj(h: torch.Tensor) -> torch.Tensor:
        return torch.matmul((h * scale).float(), wte.to(h.dtype).float().t())

    return proj


def extract_t5_branch_params(model: "T5LM", branch_at: int) -> T5Branch:
    """A frozen deep copy of the decoder blocks from `branch_at` up, the
    decoder's final norm and the logit head: the hydra reference branch."""
    branch = T5Branch(
        [copy.deepcopy(b) for b in model.decoder.blocks[branch_at:]],
        copy.deepcopy(model.decoder.ln_f),
        copy.deepcopy(model.shared),
        copy.deepcopy(model.lm_head) if hasattr(model, "lm_head") else None,
    )
    return branch.requires_grad_(False)


class T5LM(nn.Module):
    """Encoder-decoder LM: `shared` {wte}, `encoder` and `decoder` stacks
    {blocks, ln_f, rel_bias}, and `lm_head` {kernel} when untied.

    `device` defaults to the current CUDA card and raises when there is
    none; pass device="cpu" for the plain path on the CPU."""

    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.shared = Shared(cfg, device)
        self.encoder = T5Stack(cfg, cfg.n_layer, False, device)
        self.decoder = T5Stack(cfg, cfg.n_decoder_layer, True, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = LMHead(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.shared.wte.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "T5LM":
        """Random init with the reference's distributions: normal(d_model^-0.5)
        for the q/k/v and MLP input kernels, normal((H d_kv)^-0.5) for o,
        normal(d_ff^-0.5) for fc_out, normal(1) wte, normal(0.1) relative-bias
        tables, normal(d_model^-0.5) for an untied head, unit norm scales.
        Draws come from a CPU `generator`, so a seed gives the same weights
        on every device."""
        cfg = self.cfg
        stds = {
            "o": (cfg.n_head * cfg.d_kv) ** -0.5, "fc_out": cfg.d_ff ** -0.5,
            "wte": 1.0, "rel_bias": 0.1, "lm_head": cfg.d_model ** -0.5,
        }
        for name, p in self.named_parameters():
            parts = name.split(".")
            if parts[-1] == "scale":
                p.fill_(1.0)
                continue
            key = parts[-2] if parts[-1] == "kernel" else parts[-1]
            std = stds.get(key, cfg.d_model ** -0.5)
            p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float32) * std)
        return self

    # -- helpers ---------------------------------------------------------

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.shared.wte).to(self.cfg.dtype)

    def _run(self, blocks, h, args: Tuple, cache=None):
        remat = getattr(self, "remat", False)
        for ix, block in enumerate(blocks):
            h = checkpoint_block(block, remat, h, *args, cache=cache, ix=ix)
        return h

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return t5_logit_projection(self, self.cfg)(hidden)

    def _self_attn_args(self, stack: T5Stack, T: int, key_mask, causal: bool, use_kernels: bool):
        """(self_bias, pos_bias, skey_mask) for a self-attention stack: the
        combined additive [.., T, T] bias on the einsum path, or the
        structured pieces (learned bias, padding mask) on the fused one,
        which serves every teacher-forced pass at any shape (decode steps
        never come here)."""
        cfg = self.cfg
        pb = compute_position_bias_dense(
            stack.rel_bias, T, T, not causal,
            cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance,
        )  # [1, H, T, T]
        if use_kernels:
            return None, pb, key_mask
        bias = pb
        dev = pb.device
        if causal:
            pos = torch.arange(T, device=dev)
            bias = bias + torch.where(pos[:, None] >= pos[None, :], 0.0, NEG_INF)[None, None]
        if key_mask is not None:
            bias = bias + torch.where(key_mask[:, None, None, :] > 0, 0.0, NEG_INF)
        return bias, None, None

    def _decoder_args(self, B, T, decoder_attention_mask, attention_mask, encoder_hidden):
        """The decoder blocks' shared args (self_bias, enc_out, cross_bias,
        pos_bias, skey_mask, ckey_mask): one place, so the teacher-forced
        and hydra-capture passes cannot diverge."""
        use_kernels = self.cfg.attention_impl == "pallas"
        self_bias, pos_bias, skey_mask = self._self_attn_args(
            self.decoder, T, decoder_attention_mask, True, use_kernels)
        if use_kernels:
            if skey_mask is None:
                skey_mask = torch.ones((B, T), dtype=torch.int32, device=encoder_hidden.device)
            cross_bias, ckey_mask = None, attention_mask
        else:
            cross_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG_INF)
            ckey_mask = None
        return self_bias, encoder_hidden, cross_bias, pos_bias, skey_mask, ckey_mask

    # -- forward ---------------------------------------------------------

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        T = input_ids.shape[1]
        self_bias, pos_bias, skey_mask = self._self_attn_args(
            self.encoder, T, attention_mask, False, self.cfg.attention_impl == "pallas")
        h = self._run(self.encoder.blocks, self._embed(input_ids),
                      (self_bias, None, None, pos_bias, skey_mask, None))
        return self.encoder.ln_f(h)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, S_enc]
        attention_mask: torch.Tensor,  # [B, S_enc]
        decoder_input_ids: torch.Tensor,  # [B, T]
        decoder_attention_mask: Optional[torch.Tensor] = None,
        encoder_hidden: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        """Teacher-forced forward; `encoder_hidden` may be reused across calls."""
        if encoder_hidden is None:
            encoder_hidden = self.encode(input_ids, attention_mask)
        B, T = decoder_input_ids.shape
        args = self._decoder_args(B, T, decoder_attention_mask, attention_mask, encoder_hidden)
        h = self._run(self.decoder.blocks, self._embed(decoder_input_ids), args)
        hidden = self.decoder.ln_f(h)
        return {
            "logits": self._logits(hidden) if compute_logits else None,
            "hidden_states": hidden,
            "encoder_hidden": encoder_hidden,
        }

    # -- hydra support ---------------------------------------------------

    def forward_with_branch_capture(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        decoder_input_ids: torch.Tensor,
        decoder_attention_mask: Optional[torch.Tensor],
        branch_at: int,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        """Teacher-forced forward that also returns the decoder hidden state
        entering layer `branch_at` and the pieces the top branch re-runs on."""
        encoder_hidden = self.encode(input_ids, attention_mask)
        B, T = decoder_input_ids.shape
        args = self._decoder_args(B, T, decoder_attention_mask, attention_mask, encoder_hidden)
        self_bias, _, cross_bias, pos_bias, skey_mask, ckey_mask = args
        h_branch = self._run(self.decoder.blocks[:branch_at], self._embed(decoder_input_ids), args)
        hidden = self.decoder.ln_f(self._run(self.decoder.blocks[branch_at:], h_branch, args))
        return {
            "logits": self._logits(hidden) if compute_logits else None,
            "hidden_states": hidden,
            "branch_hidden": h_branch,
            "self_bias": self_bias,
            "cross_bias": cross_bias,
            "pos_bias": pos_bias,
            "skey_mask": skey_mask,
            "ckey_mask": ckey_mask,
            "encoder_hidden": encoder_hidden,
        }

    def forward_from_layer(
        self,
        branch: T5Branch,
        branch_hidden: torch.Tensor,
        self_bias: Optional[torch.Tensor],
        encoder_hidden: torch.Tensor,
        cross_bias: Optional[torch.Tensor],
        compute_logits: bool = True,
        pos_bias: Optional[torch.Tensor] = None,
        skey_mask: Optional[torch.Tensor] = None,
        ckey_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Run the frozen top-k `branch` from a captured hidden state (on the
        fused path the combined biases are None and the structured pieces
        ride instead)."""
        h = self._run(branch.blocks, branch_hidden,
                      (self_bias, encoder_hidden, cross_bias, pos_bias, skey_mask, ckey_mask))
        hidden = branch.ln_f(h)
        return {
            "logits": t5_logit_projection(branch, self.cfg)(hidden) if compute_logits else None,
            "hidden_states": hidden,
        }

    # -- decoding --------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> Dict:
        """A zeroed compute-dtype decoder cache [L, B, S, H, d_kv] with write
        index 0 (a host int)."""
        cfg = self.cfg
        shape = (cfg.n_decoder_layer, batch, max_len, cfg.n_head, cfg.d_kv)
        return {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "index": 0,
        }

    def decode_step(
        self,
        token: torch.Tensor,  # [B, 1]
        encoder_hidden: torch.Tensor,
        attention_mask: torch.Tensor,  # [B, S_enc]
        cache: Dict,
    ) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """One decoder step at cache position `cache["index"]`; the cache
        buffers are written in place and the returned dict has the index
        advanced."""
        cfg = self.cfg
        S = cache["k"].shape[2]
        t = cache["index"]
        dev = token.device
        k_pos = torch.arange(S, device=dev)
        self_bias = compute_position_bias(
            self.decoder.rel_bias, torch.tensor([t], device=dev), k_pos, False,
            cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance,
        )
        self_bias = torch.where(k_pos[None, None, None, :] <= t, self_bias, NEG_INF)
        cross_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG_INF)
        h = self._run(self.decoder.blocks, self._embed(token),
                      (self_bias, encoder_hidden, cross_bias, None, None, None), cache=cache)
        hidden = self.decoder.ln_f(h)
        return {"logits": self._logits(hidden), "hidden_states": hidden}, dict(cache, index=t + 1)


@torch.no_grad()
def generate_seq2seq(
    model: T5LM,
    input_ids: torch.Tensor,  # [B, S_enc]
    attention_mask: torch.Tensor,  # [B, S_enc]
    generator: Optional[torch.Generator],
    settings,
    logits_processor=None,
) -> Dict[str, torch.Tensor]:
    """Sample decoder continuations: the encoder runs once, then one cached
    decoder step a token, from `decoder_start_token_id`, with the causal
    sampler's early exit once every row has finished. Returns sequences
    [B, N + 1] (the start token, then the response), response_ids and
    response_mask [B, N] (1 for real tokens, the EOS included) and
    encoder_hidden."""
    from trlx_tpu_torch.models.generation import cast_params_for_decode, sample_token

    cfg = model.cfg
    B = input_ids.shape[0]
    N = settings.max_new_tokens
    if N < 1:
        raise ValueError("max_new_tokens must be >= 1")
    dev = input_ids.device
    model = cast_params_for_decode(model, cfg.dtype)
    attention_mask = attention_mask.to(torch.int32)
    enc = model.encode(input_ids, attention_mask)
    cache = model.init_cache(B, N + 1)
    start = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)

    def pick(hidden_last, logits_last, finished):
        if logits_processor is not None:
            logits_last = logits_processor(hidden_last, logits_last)
        tok = sample_token(generator, logits_last, settings)
        tok = torch.where(finished, torch.full_like(tok, settings.pad_token_id), tok)
        return tok, finished | (tok == settings.eos_token_id)

    out, cache = model.decode_step(start, enc, attention_mask, cache)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    tok, finished = pick(out["hidden_states"][:, -1], out["logits"][:, -1], finished)
    ids_buf = torch.full((B, N), settings.pad_token_id, dtype=torch.long, device=dev)
    mask_buf = torch.zeros((B, N), dtype=torch.bool, device=dev)
    ids_buf[:, 0] = tok
    mask_buf[:, 0] = True
    t = 1
    while t < N and not bool(finished.all()):
        step, cache = model.decode_step(tok[:, None], enc, attention_mask, cache)
        nxt, now_finished = pick(step["hidden_states"][:, -1], step["logits"][:, -1], finished)
        ids_buf[:, t] = nxt
        mask_buf[:, t] = ~finished  # real iff the row had not finished before it
        tok, finished = nxt, now_finished
        t += 1
    return {
        "sequences": torch.cat([start, ids_buf], dim=1),
        "response_ids": ids_buf,
        "response_mask": mask_buf.to(torch.int32),
        "encoder_hidden": enc,
    }
