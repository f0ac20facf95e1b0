"""The decoder-only causal transformer: the port of
trlx_tpu.models.transformer (GPT-2, Llama and GPT-J through its switches).

The JAX reference keeps block parameters stacked [L, ...] and scans over
them; here the blocks are an `nn.ModuleList` and the forward is a Python
loop, and the hydra reference branch is a frozen deep copy of the top
blocks (`extract_branch_params`). Parameter names follow the reference
(`blocks.{i}.attn.q.kernel`, ...), with the (H, D) axes of the attention
kernels flattened; `models/convert.py` maps a JAX tree onto them.

Numerics follow the reference: params in `param_dtype` (fp32), matmuls in
the compute `dtype` (bf16 on the card), norms in fp32, attention scores
and logits accumulated in fp32.

Attention dispatch keeps the reference's knobs:
- `attention_impl="pallas"` runs the hand-written flash kernel
  (ops/flash_attention.py) in every teacher-forced pass and in a cache
  prefill (T > 1), with the queries at cache slots [index, index + T);
  `"xla"` runs the plain einsum/softmax math of the reference's XLA path.
  Decode steps over a bf16 cache always take the plain path, as in the
  reference. The kernel takes any T and S, so the TPU's S % 128 and
  T % 8 gates are gone.
- `kv_cache_quant="int8_kernel"` runs the hand-written int8 decode kernel
  (ops/decode_attention.py) for T == 1 steps over the quantized cache;
  `"int8"` runs the reference's folded-scale plain math.

Ported switches: learned or rotary positions (neox or gptj style, a
partial `rotary_dim`, `rope_theta`; the rope rotates q and k at each
token's real position before the cache write and before either kernel),
LayerNorm or RMSNorm with or without a bias, gelu_new / gelu / silu /
relu, the gated (SwiGLU) MLP, projections with or without biases, the
sequential or the parallel residual (GPT-J: attention and MLP both read
ln_1's output, and no ln_2 exists), tied embeddings or an untied
`lm_head`, and grouped-query attention. The switches of OPT, Bloom,
GPT-Neo and GPT-BigCode (alibi, pos_offset, embed_layernorm, attn_scale,
local windows) raise NotImplementedError.

Int8 decode weights (`decode_weights_quant="int8"`): the samplers'
decode copy (`generation.cast_params_for_decode`) holds every block
projection as an int8 kernel with per-output-channel fp32 scales
(`kernel_scale`), and `QDense` then runs the W8A16 product
(`ops.int8_matmul`, kernel 10 on the card). Training and teacher-forced
passes never see a scale.

Activation checkpointing (`remat`, set by the trainer from
`train.remat_policy`): `_run_blocks` wraps each block of a pass that
records a graph in `ops.remat.checkpoint_block`.

Adapters: a LoRA pair attached to a projection (`models/lora.py`) adds
its unmerged term inside `QDense`; `forward` takes prompt tuning's soft
tokens (`prefix_embeds`) and prefix tuning's per-layer keys and values
(`kv_prefix`, concatenated before each layer's own, so the teacher-forced
pass runs the flash kernel at T queries over n + T keys with q_offset n).

The KV cache is a dict of tensors plus a host-int write `index`. Forwards
with a cache write their new K/V columns into the cache buffers IN PLACE
(the reference's functional update-carry; in place it needs no second
copy of the cache) and return the dict with the index advanced. A cache
dict holding "pk" is the decode engine's paged pool instead
(models/gen_engine.py): each lane has its own slot position, the pages
are written in place, and attention runs through
`ops.decode_attention.paged_attention_step`.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.ops.decode_attention import (
    POOL_KEYS,
    decode_attention_int8,
    paged_attention_step,
)
from trlx_tpu_torch.models.lora import adapter_of
from trlx_tpu_torch.ops.flash_attention import flash_attention
from trlx_tpu_torch.ops.int8_matmul import int8_weight_matmul
from trlx_tpu_torch.ops.remat import checkpoint_block
from trlx_tpu_torch.utils.device import resolve_device

NEG_INF = -1e9  # additive mask value of the plain path (finite: no NaN rows)

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def to_torch_dtype(dtype: Any) -> torch.dtype:
    """torch dtype from a torch dtype or its name ("bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[dtype]


@dataclass(frozen=True)
class TransformerConfig:
    """Static architecture description; field for field the reference's
    TransformerConfig, so `model_extra_configs["transformer"]` dicts load
    unchanged. `dtype`/`param_dtype` accept torch dtypes or their names."""

    vocab_size: int
    hidden_size: int
    n_layer: int
    n_head: int
    n_positions: int = 1024
    intermediate_size: Optional[int] = None  # default 4*hidden
    n_kv_head: Optional[int] = None  # grouped-query attention; default n_head
    head_dim: Optional[int] = None  # default hidden // n_head

    pos_embed: str = "learned"
    pos_offset: int = 0
    embed_layernorm: bool = False
    rotary_style: str = "neox"
    rotary_dim: Optional[int] = None
    rope_theta: float = 10000.0
    attn_scale: Optional[float] = None
    local_window: Optional[int] = None
    attn_layers: Optional[Tuple[str, ...]] = None
    norm: str = "layernorm"
    layer_norm_epsilon: float = 1e-5
    activation: str = "gelu_new"
    mlp_gated: bool = False
    parallel_residual: bool = False
    use_attn_bias: bool = True
    use_attn_out_bias: Optional[bool] = None
    use_mlp_bias: bool = True
    use_norm_bias: bool = True
    tie_word_embeddings: bool = True

    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attention_impl: str = "xla"  # "xla" | "pallas" (the flash kernel)
    kv_cache_quant: Optional[str] = None  # None | "int8" | "int8_kernel"
    decode_weights_quant: Optional[str] = None
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"

    def __post_init__(self):
        if self.intermediate_size is None:
            object.__setattr__(self, "intermediate_size", 4 * self.hidden_size)
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.n_head)
        if self.n_kv_head is None:
            object.__setattr__(self, "n_kv_head", self.n_head)
        if self.rotary_dim is None and self.pos_embed == "rotary":
            object.__setattr__(self, "rotary_dim", self.head_dim)
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", to_torch_dtype(self.param_dtype))

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


_UNPORTED_QUEUE = "ROADMAP queue 7"

_CHOICES = {
    "pos_embed": ("learned", "rotary"),
    "rotary_style": ("neox", "gptj"),
    "norm": ("layernorm", "rmsnorm"),
    "activation": ("gelu_new", "gelu", "silu", "relu"),
}


def check_ported(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for any switch the port has not reached
    (rather than silently computing another model): the OPT, Bloom,
    GPT-Neo and GPT-BigCode switches."""
    unported = {
        "pos_offset": (cfg.pos_offset, 0),
        "embed_layernorm": (cfg.embed_layernorm, False),
        "attn_scale": (cfg.attn_scale, None),
        "local_window": (cfg.local_window, None),
        "attn_layers": (cfg.attn_layers, None),
    }
    for name, (got, ported) in unported.items():
        if got != ported:
            raise NotImplementedError(
                f"TransformerConfig.{name}={got!r} is not ported yet (only {ported!r}; {_UNPORTED_QUEUE})"
            )
    for name, choices in _CHOICES.items():
        if getattr(cfg, name) not in choices:
            raise NotImplementedError(
                f"TransformerConfig.{name}={getattr(cfg, name)!r} is not ported yet "
                f"(one of {choices}; {_UNPORTED_QUEUE})"
            )
    if cfg.pos_embed == "rotary" and (cfg.rotary_dim % 2 or not 0 < cfg.rotary_dim <= cfg.head_dim):
        raise ValueError(f"rotary_dim={cfg.rotary_dim} must be even and within head_dim={cfg.head_dim}")
    if cfg.attention_impl not in ("xla", "pallas"):
        raise NotImplementedError(f"attention_impl={cfg.attention_impl!r} is not ported ({_UNPORTED_QUEUE})")
    if cfg.kv_cache_quant not in (None, "int8", "int8_kernel"):
        raise NotImplementedError(f"kv_cache_quant={cfg.kv_cache_quant!r} is not ported")
    if cfg.decode_weights_quant not in (None, "int8"):
        raise ValueError(f"decode_weights_quant={cfg.decode_weights_quant!r} (None or 'int8')")
    if cfg.n_head % cfg.n_kv_head:
        raise ValueError(f"n_head={cfg.n_head} not a multiple of n_kv_head={cfg.n_kv_head}")


_ACTIVATIONS = {
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": F.gelu,
    "silu": F.silu,
    "relu": F.relu,
}


def rope_frequencies(cfg: TransformerConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, T, rotary_dim // 2] (fp32) for positions [B, T]."""
    dim = cfg.rotary_dim
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, style: str) -> torch.Tensor:
    """Rotate the first rotary_dim channels of x [B, T, H, D] in fp32 and
    cast back: "gptj" rotates interleaved pairs, "neox" (Llama) halves."""
    rot_dim = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rot_dim].float(), x[..., rot_dim:]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    if style == "gptj":
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x_rot.shape)
    else:
        half = rot_dim // 2
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """LayerNorm (a bias unless use_norm_bias is off) or RMSNorm (never a
    bias), computed in fp32 and cast back to the input dtype."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.eps = cfg.layer_norm_epsilon
        self.rms = cfg.norm == "rmsnorm"
        self.scale = nn.Parameter(torch.ones(cfg.hidden_size, dtype=cfg.param_dtype, device=device))
        if not self.rms and cfg.use_norm_bias:
            self.bias = nn.Parameter(torch.zeros(cfg.hidden_size, dtype=cfg.param_dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.rms:
            return (x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps) * self.scale.float()).to(x.dtype)
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.scale.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class QDense(nn.Module):
    """Linear map with the reference's param layout: `kernel` [in, out]
    (the reference's (input dims..., feature dims...) flattened) and a
    zero-init `bias` [out] unless `use_bias` is off. The product runs in
    `dtype`. A LoRA pair attached to it (`models/lora.py`) adds its
    unmerged term. In a samplers' int8 decode copy the kernel is int8 and
    `kernel_scale` its per-output-channel scales: the product is then the
    W8A16 one (`int8_weight_matmul`), the bias added after the scale as
    in the reference."""

    def __init__(self, in_features: int, out_features: int, dtype, param_dtype, device=None,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, out_features, dtype=param_dtype, device=device)
        )
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))
        else:
            self.register_parameter("bias", None)
        self.register_buffer("kernel_scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_scale is not None:
            y = int8_weight_matmul(x.to(self.dtype), self.kernel, self.kernel_scale)
        else:
            y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        pair = adapter_of(self)
        return y if pair is None else y + pair.delta(x, self.dtype)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the trailing D axis: (int8 values,
    per-row fp32 scales shaped x.shape[:-1]). Zero rows get scale 0 and
    dequantize back to exact zeros."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1) / 127.0
    q = torch.round(x32 / torch.clamp(s, min=1e-12)[..., None]).to(torch.int8)
    return q, s


def quantize_kv_cache(cache: Dict) -> Dict:
    """One-shot int8 quantization of a prefilled bf16 cache.

    Layout: the bf16 cache is [L, B, S, Hkv, D]; the int8 cache is
    [L, B, Hkv, S, D] (the decode kernel streams each (batch, kv-head)
    group's slots as plain rows). K scales per (layer, batch, kv-head,
    slot), stored [L, B, Hkv, 1, S]; V scales per (layer, batch, kv-head,
    channel) over the slot axis with 1.25x headroom, stored
    [L, B, Hkv, 1, D] and FROZEN here — decode writes saturate against
    them."""
    k = cache["k"].float().permute(0, 1, 3, 2, 4)
    v = cache["v"].float().permute(0, 1, 3, 2, 4)
    kq, ks = _quantize_kv(k)
    vs = v.abs().amax(dim=3) * (1.25 / 127.0)  # [L, B, Hkv, D]
    vq = torch.clamp(
        torch.round(v / torch.clamp(vs, min=1e-12)[:, :, :, None]), -127.0, 127.0
    ).to(torch.int8)
    return dict(
        cache,
        k=kq.contiguous(),
        v=vq.contiguous(),
        k_scale=ks[:, :, :, None].contiguous(),
        v_scale=vs[:, :, :, None].contiguous(),
    )


def _plain_attention(q, k, v, attn_bias, cfg: TransformerConfig) -> torch.Tensor:
    """The reference's XLA path: q [B,T,H,D], k/v [B,S,Hkv,D] -> [B,T,H,D]."""
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    scores = scores + attn_bias
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v.to(cfg.dtype))


def _int8_folded_attention(q, k_i8, v_i8, ks_l, layer_vs, attn_bias, cfg):
    """The reference's folded-scale int8 decode path: K/V stay int8; the
    per-slot K scale rides the scores, the per-channel V scale the output.
    k_i8/v_i8 [B,Hkv,S,D], ks_l [B,Hkv,1,S], layer_vs [B,Hkv,1,D]."""
    H, Hkv = q.shape[2], k_i8.shape[1]
    if Hkv != H:
        rep = H // Hkv
        k_i8, v_i8 = k_i8.repeat_interleave(rep, 1), v_i8.repeat_interleave(rep, 1)
        ks_l, layer_vs = ks_l.repeat_interleave(rep, 1), layer_vs.repeat_interleave(rep, 1)
    scores = torch.einsum(
        "bthd,bhsd->bhts", q.float(), k_i8.to(cfg.dtype).float()
    ) * (1.0 / math.sqrt(q.shape[-1]))
    scores = scores * ks_l + attn_bias
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.einsum("bhts,bhsd->bthd", probs, v_i8.to(cfg.dtype))
    return out * layer_vs.transpose(1, 2).to(cfg.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D, E = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.hidden_size
        dense = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        out_bias = cfg.use_attn_out_bias if cfg.use_attn_out_bias is not None else cfg.use_attn_bias
        self.q = QDense(E, H * D, use_bias=cfg.use_attn_bias, **dense)
        self.k = QDense(E, Hkv * D, use_bias=cfg.use_attn_bias, **dense)
        self.v = QDense(E, Hkv * D, use_bias=cfg.use_attn_bias, **dense)
        self.o = QDense(H * D, E, use_bias=out_bias, **dense)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, E]
        attn_bias: torch.Tensor,  # [B, 1, T, S] additive fp32
        cache: Optional[Dict] = None,  # the model's whole cache dict
        ix: int = 0,  # this layer's index into the stacked cache
        key_mask: Optional[torch.Tensor] = None,  # [B, S]
        positions: Optional[torch.Tensor] = None,  # [B, T] real positions (rope)
        prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # this layer's (k, v) [n, Hkv, D]
    ) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        H, Hkv, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
        q = self.q(x).view(B, T, H, D)
        k = self.k(x).view(B, T, Hkv, D)
        v = self.v(x).view(B, T, Hkv, D)
        if cfg.pos_embed == "rotary":
            cos, sin = rope_frequencies(cfg, positions)
            q = apply_rope(q, cos, sin, cfg.rotary_style)
            k = apply_rope(k, cos, sin, cfg.rotary_style)
        sm_scale = 1.0 / math.sqrt(D)

        out = None
        q_offset = None
        if prefix is not None:
            # prefix tuning's teacher-forced pass: the layer's prefix keys and
            # values (stored unrotated, as the reference's cache holds them)
            # occupy slots [0, n) before the sequence's, with no cache, so
            # autograd reaches them; the queries sit at slots [n, n + T)
            n = prefix[0].shape[0]
            k = torch.cat([prefix[0].to(k.dtype).expand(B, n, Hkv, D), k], dim=1)
            v = torch.cat([prefix[1].to(v.dtype).expand(B, n, Hkv, D), v], dim=1)
            q_offset = n
        if cache is not None and "pk" in cache:
            # paged pools (models/gen_engine.py): write this layer's T tokens
            # into their pages in place and attend over each lane's logical
            # sequence; all masking rides attn_bias
            pools = {name: cache[name] for name in POOL_KEYS if name in cache}
            out, _ = paged_attention_step(
                q, k, v, pools, ix, cache["page_table"], cache["slot_pos"], attn_bias, sm_scale,
                lane_valid=cache.get("lane_valid"), contiguous=bool(cache.get("contiguous", False)),
                impl=cache.get("attn_impl", "xla"),
            )
        elif cache is not None:
            idx = cache["index"]
            if "k_scale" in cache:
                # int8 cache [L, B, Hkv, S, D] (decode only; generate()
                # quantizes the prefilled cache once — quantize_kv_cache)
                layer_vs = cache["v_scale"][ix]  # [B, Hkv, 1, D]
                kq, ks = _quantize_kv(k)
                vq = torch.clamp(
                    torch.round(v.float() / torch.clamp(layer_vs.transpose(1, 2), min=1e-12)),
                    -127.0, 127.0,
                ).to(torch.int8)
                cache["k"][ix, :, :, idx:idx + T] = kq.transpose(1, 2)
                cache["v"][ix, :, :, idx:idx + T] = vq.transpose(1, 2)
                cache["k_scale"][ix, :, :, 0, idx:idx + T] = ks.transpose(1, 2)
                if cfg.kv_cache_quant == "int8_kernel" and T == 1 and key_mask is not None:
                    out = decode_attention_int8(
                        q[:, 0], cache["k"], cache["v"], cache["k_scale"], layer_vs,
                        key_mask, ix, sm_scale,
                    )[:, None]
                else:
                    out = _int8_folded_attention(
                        q, cache["k"][ix], cache["v"][ix], cache["k_scale"][ix],
                        layer_vs, attn_bias, cfg,
                    )
            else:
                cache["k"][ix, :, idx:idx + T] = k
                cache["v"][ix, :, idx:idx + T] = v
                k, v = cache["k"][ix], cache["v"][ix]  # [B, S, Hkv, D]
                if T > 1:  # prefill: queries at slots [idx, idx + T)
                    q_offset = idx

        if out is None:
            use_kernel = (
                cfg.attention_impl == "pallas"
                and key_mask is not None
                and (cache is None or q_offset is not None)
            )
            if use_kernel:
                out = flash_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    key_mask, q_offset=q_offset,
                ).transpose(1, 2)
            else:
                out = _plain_attention(q, k, v, attn_bias, cfg)
        return self.o(out.reshape(B, T, H * D))


class MLP(nn.Module):
    """fc_out(act(fc_in(x))), or with `mlp_gated` fc_out(act(fc_in(x)) *
    fc_gate(x)) (Llama's SwiGLU: fc_in is HF's gate_proj, fc_gate its
    up_proj)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dense = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device, use_bias=cfg.use_mlp_bias)
        self.act = _ACTIVATIONS[cfg.activation]
        self.fc_in = QDense(cfg.hidden_size, cfg.intermediate_size, **dense)
        if cfg.mlp_gated:
            self.fc_gate = QDense(cfg.hidden_size, cfg.intermediate_size, **dense)
        else:
            self.fc_gate = None
        self.fc_out = QDense(cfg.intermediate_size, cfg.hidden_size, **dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.fc_in(x))
        if self.fc_gate is not None:
            h = h * self.fc_gate(x)
        return self.fc_out(h)


class Block(nn.Module):
    """Pre-norm decoder block: a sequential residual (gpt2, llama), or with
    `parallel_residual` attention and MLP both on ln_1's output (gptj; no
    ln_2, as in the reference's param tree)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.parallel = cfg.parallel_residual
        self.ln_1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln_2 = None if self.parallel else Norm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, attn_bias, cache=None, ix=0, key_mask=None, positions=None, prefix=None):
        h = self.ln_1(x)
        attn_out = self.attn(h, attn_bias, cache, ix, key_mask, positions, prefix)
        if self.parallel:
            return x + attn_out + self.mlp(h)
        x = x + attn_out
        return x + self.mlp(self.ln_2(x))


class Embedding(nn.Module):
    """Token embedding `wte`, plus the learned position table `wpe` when
    pos_embed is "learned" (a rotary model has none)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype, device=device)
        )
        if cfg.pos_embed == "learned":
            self.wpe = nn.Parameter(
                torch.empty(cfg.n_positions, cfg.hidden_size, dtype=cfg.param_dtype, device=device)
            )
        else:
            self.register_parameter("wpe", None)

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = F.embedding(input_ids.long(), self.wte)
        if self.wpe is not None:
            pos = torch.clamp(positions, 0, self.cfg.n_positions - 1)
            h = h + F.embedding(pos.long(), self.wpe)
        return h.to(self.cfg.dtype)


class LMHead(nn.Module):
    """The untied output projection: `kernel` [E, V]."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(cfg.hidden_size, cfg.vocab_size, dtype=cfg.param_dtype, device=device)
        )


def logit_projection(model: "TransformerLM"):
    """hidden -> fp32 logits closure over the untied `lm_head` when the
    model (or hydra Branch) has one, else the tied wte: the product runs on
    compute-dtype operands with fp32 accumulation (the reference's
    preferred_element_type=float32), i.e. on their exact fp32 values."""
    head = getattr(model, "lm_head", None)
    if head is not None:
        kernel = head.kernel

        def proj(h: torch.Tensor) -> torch.Tensor:
            return torch.matmul(h.float(), kernel.to(h.dtype).float())

        return proj
    wte = model.embed.wte

    def proj(h: torch.Tensor) -> torch.Tensor:
        return torch.matmul(h.float(), wte.to(h.dtype).float().t())

    return proj


def make_attention_bias(
    key_mask: torch.Tensor,  # [B, S] 1 = attendable key slot
    q_slots: torch.Tensor,  # [T] or [B, T] slot index of each query token
    k_slots: torch.Tensor,  # [S] slot index of each key slot
) -> torch.Tensor:
    """Additive causal+padding bias [B, 1, T, S] in fp32 (slot-index
    causality, so it stays right under left padding)."""
    if q_slots.dim() == 1:
        q_slots = q_slots[None, :]
    causal = q_slots[:, :, None] >= k_slots[None, None, :]
    visible = causal & (key_mask[:, None, :] > 0)
    bias = torch.where(
        visible,
        torch.zeros((), dtype=torch.float32, device=key_mask.device),
        torch.full((), NEG_INF, dtype=torch.float32, device=key_mask.device),
    )
    return bias[:, None, :, :]


def _pad_positions(attention_mask: torch.Tensor) -> torch.Tensor:
    """Real positions of left-padded rows: cumsum of the mask minus one."""
    return torch.clamp(torch.cumsum(attention_mask.long(), dim=1) - 1, min=0)


class Branch(nn.Module):
    """The frozen hydra reference branch: the top blocks, the final norm,
    the embedding and the untied `lm_head` where the model has one."""

    def __init__(self, blocks: Sequence[Block], ln_f: Norm, embed: Embedding,
                 lm_head: Optional[LMHead] = None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f
        self.embed = embed
        self.lm_head = lm_head


class TransformerLM(nn.Module):
    """Causal LM: embedding, a stack of blocks, final norm, and the logits
    through the tied embedding or the untied `lm_head`.

    `device` defaults to the current CUDA card and raises when there is
    none; pass device="cpu" for the plain path on the CPU."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Embedding(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = Norm(cfg, device)
        self.lm_head = None if cfg.tie_word_embeddings else LMHead(cfg, device)
        self.remat = False  # the resolved train.remat_policy (ops/remat.py)

    @property
    def device(self) -> torch.device:
        return self.embed.wte.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerLM":
        """Random init with the reference's distributions (`init_value`),
        parameter by parameter in order. Draws come from `generator` on its
        device: a CPU generator gives the same weights on every device."""
        for name, p in self.named_parameters():
            p.copy_(self.init_value(name, p, generator))
        return self

    def init_value(self, name: str, p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """The next init draw for parameter `name` (fp32, on the generator's
        device): normal(0.02) kernels, wte and lm_head, normal(0.02 /
        sqrt(2L)) for the o and fc_out kernels, normal(0.01) wpe, zero
        biases, unit norm scales."""
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            return torch.ones(p.shape, dtype=torch.float32, device=generator.device)
        if leaf == "bias":
            return torch.zeros(p.shape, dtype=torch.float32, device=generator.device)
        std = 0.02
        if name.endswith(("attn.o.kernel", "mlp.fc_out.kernel")):
            std = 0.02 / math.sqrt(2 * self.cfg.n_layer)
        elif name.endswith("wpe"):
            std = 0.01
        return torch.randn(p.shape, generator=generator, dtype=torch.float32, device=generator.device) * std

    def init_cache(self, batch: int, max_len: int,
                   key_mask: Optional[torch.Tensor] = None) -> Dict:
        """A zeroed bf16 (compute dtype) cache [L, B, S, Hkv, D] with write
        index 0 and the slot key_mask [B, S]."""
        cfg = self.cfg
        shape = (cfg.n_layer, batch, max_len, cfg.n_kv_head, cfg.head_dim)
        if key_mask is None:
            key_mask = torch.ones((batch, max_len), dtype=torch.int32, device=self.device)
        return {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "index": 0,
            "key_mask": key_mask,
        }

    def _run_blocks(self, blocks, h, attn_bias, cache=None, key_mask=None, layer_offset=0,
                    layer_ixs=None, positions=None, kv_prefix=None):
        """`layer_ixs` maps block i onto cache layer layer_ixs[i] (a hydra
        draft's trunk blocks onto the policy's trunk slots of a paged pool,
        its branch blocks onto the extension slots); default
        layer_offset + i. `positions` [B, T] are the real positions the
        rope rotates by; `kv_prefix` {k, v} [L, n, Hkv, D] are prefix
        tuning's keys and values, by cache layer. Under `remat` each block of
        a pass that records a graph is checkpointed."""
        remat = getattr(self, "remat", False)  # a draft composed without __init__ has none
        for i, block in enumerate(blocks):
            ix = layer_offset + i if layer_ixs is None else int(layer_ixs[i])
            prefix = None if kv_prefix is None else (kv_prefix["k"][ix], kv_prefix["v"][ix])
            h = checkpoint_block(block, remat, h, attn_bias, cache, ix, key_mask, positions, prefix)
        return h

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return logit_projection(self)(hidden)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T]
        attention_mask: Optional[torch.Tensor] = None,  # [B, T]
        positions: Optional[torch.Tensor] = None,
        cache: Optional[Dict] = None,
        compute_logits: bool = True,
        prefix_embeds: Optional[torch.Tensor] = None,  # [n, E] prompt tuning
        kv_prefix: Optional[Dict[str, torch.Tensor]] = None,  # {k, v} [L, n, Hkv, D] prefix tuning
    ) -> Dict[str, Any]:
        """Without `cache`: a teacher-forced pass over a (possibly
        left-padded) sequence. With `cache`: the input occupies cache
        slots [index, index + T) and attends over the cache prefix — the
        same entry point serves prefill (T = prompt length) and decode
        (T = 1).

        Adapters (teacher-forced; `generate` warms its cache with them):
        - `prefix_embeds` (prompt tuning): n soft tokens run as real leading
          positions, embedded as token 0 plus their position embedding
          with the wte row swapped for the soft one; the outputs keep
          [B, T] (the virtual rows are sliced off after the blocks). With a
          cache, every input row is a soft token (the sampler's warm-up).
        - `kv_prefix` (prefix tuning): each layer attends over its n prefix
          keys and values before the sequence's, the queries at slots
          [n, n + T) (`Attention`, no cache).
        Real-token positions start at n under either (HF past-length
        semantics)."""
        B, T = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        n_virtual = 0  # rows to slice off the outputs (prompt tuning)
        if prefix_embeds is not None and cache is None:
            n_virtual = prefix_embeds.shape[0]
            input_ids = torch.cat([torch.zeros((B, n_virtual), dtype=input_ids.dtype, device=dev), input_ids], 1)
            attention_mask = torch.cat(
                [torch.ones((B, n_virtual), dtype=attention_mask.dtype, device=dev), attention_mask], 1)
            positions = None  # recomputed over the extended mask
            T = T + n_virtual
        if kv_prefix is not None and cache is None:
            n = kv_prefix["k"].shape[1]
            key_mask = torch.cat([torch.ones((B, n), dtype=attention_mask.dtype, device=dev), attention_mask], 1)
            positions = n + _pad_positions(attention_mask)
            bias = make_attention_bias(key_mask, n + torch.arange(T, device=dev), torch.arange(n + T, device=dev))
            h = self.embed(input_ids, positions)
            h = self._run_blocks(self.blocks, h, bias, key_mask=key_mask, positions=positions, kv_prefix=kv_prefix)
            hidden = self.ln_f(h)
            return {
                "logits": self._logits(hidden) if compute_logits else None,
                "hidden_states": hidden,
                "cache": None,
                "positions": positions,
            }
        if cache is not None and "pk" in cache:
            # paged pools: each lane sits at its own depth (per-row slot_pos
            # instead of one write index); the engine precomputes key_mask
            # over the valid slots including the T incoming tokens, and
            # causality among those tokens falls out of the slot comparison
            S = cache["page_table"].shape[1] * cache["pk"].shape[2]
            q_slots = cache["slot_pos"][:, None] + torch.arange(T, device=dev)[None, :]
            if positions is None:
                positions = q_slots
            bias = make_attention_bias(cache["key_mask"], q_slots, torch.arange(S, device=dev))
            h = self.embed(input_ids, positions)
            h = self._run_blocks(self.blocks, h, bias, cache, cache["key_mask"],
                                 layer_ixs=cache.get("layer_ixs"), positions=positions)
            hidden = self.ln_f(h)
            return {
                "logits": self._logits(hidden) if compute_logits else None,
                "hidden_states": hidden,
                "cache": cache,  # the pools were written in place
                "positions": positions,
            }
        if cache is not None:
            quant = "k_scale" in cache
            S = cache["k"].shape[3 if quant else 2]
            idx = cache["index"]
            q_slots = idx + torch.arange(T, device=dev)
            if positions is None:
                positions = q_slots[None, :].expand(B, T)
            within = torch.arange(S, device=dev)[None, :] < idx + T
            key_mask = (within & (cache["key_mask"] > 0)).to(torch.int32)
            bias = make_attention_bias(key_mask, q_slots, torch.arange(S, device=dev))
        else:
            if positions is None:
                positions = _pad_positions(attention_mask)
            key_mask = attention_mask
            bias = make_attention_bias(
                attention_mask, torch.arange(T, device=dev), torch.arange(T, device=dev)
            )
        h = self.embed(input_ids, positions)
        if prefix_embeds is not None:
            # the virtual rows were embedded as token 0 (+ wpe): swap the wte
            # row for the soft embedding, keeping wpe
            n_rows = n_virtual or T
            soft = h[:, :n_rows] - self.embed.wte[0].to(h.dtype) + prefix_embeds[None, :n_rows].to(h.dtype)
            h = torch.cat([soft, h[:, n_rows:]], dim=1)
        h = self._run_blocks(self.blocks, h, bias, cache, key_mask, positions=positions)
        hidden = self.ln_f(h)
        new_cache = dict(cache, index=cache["index"] + T) if cache is not None else None
        if n_virtual:
            hidden, positions = hidden[:, n_virtual:], positions[:, n_virtual:]
        return {
            "logits": self._logits(hidden) if compute_logits else None,
            "hidden_states": hidden,
            "cache": new_cache,
            "positions": positions,
        }

    def forward_with_multi_capture(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        points: Tuple[int, ...],
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        """Teacher-forced pass that also returns the hidden state entering
        each layer index in `points` (ascending) — the fork points of the
        hydra reference branch."""
        B, T = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        positions = _pad_positions(attention_mask)
        bias = make_attention_bias(
            attention_mask, torch.arange(T, device=dev), torch.arange(T, device=dev)
        )
        h = self.embed(input_ids, positions)
        captures = []
        prev = 0
        for point in tuple(points) + (self.cfg.n_layer,):
            if point > prev:
                h = self._run_blocks(
                    self.blocks[prev:point], h, bias, key_mask=attention_mask,
                    layer_offset=prev, positions=positions,
                )
            if point < self.cfg.n_layer:
                captures.append(h)
            prev = point
        hidden = self.ln_f(h)
        return {
            "logits": self._logits(hidden) if compute_logits else None,
            "hidden_states": hidden,
            "captures": captures,
            "positions": positions,
            "attn_bias": bias,
            "key_mask": attention_mask,
        }

    def forward_from_layer(
        self,
        branch: Branch,
        branch_hidden: torch.Tensor,
        attn_bias: torch.Tensor,
        positions: torch.Tensor,
        key_mask: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        """Run only the top-k `branch` (from `extract_branch_params`) from
        a captured hidden state."""
        h = self._run_blocks(
            branch.blocks, branch_hidden, attn_bias, key_mask=key_mask,
            layer_offset=self.cfg.n_layer - len(branch.blocks), positions=positions,
        )
        hidden = branch.ln_f(h)
        logits = logit_projection(branch)(hidden) if compute_logits else None
        return {"logits": logits, "hidden_states": hidden}


def extract_branch_params(model: TransformerLM, branch_at: int) -> Branch:
    """A frozen deep copy of the top (L - branch_at) blocks, the final norm,
    the embedding and the untied lm_head where there is one: the hydra
    reference branch."""
    branch = Branch(
        [copy.deepcopy(b) for b in model.blocks[branch_at:]],
        copy.deepcopy(model.ln_f),
        copy.deepcopy(model.embed),
        copy.deepcopy(model.lm_head),
    )
    return branch.requires_grad_(False)
