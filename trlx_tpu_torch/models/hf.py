"""Local HuggingFace checkpoint directories: the port of trlx_tpu.models.hf.

Reads an HF-layout directory (`config.json` and its weights) into the
port's configs and state dicts, and writes the port's weights back in that
layout, with no `transformers` and no `safetensors` package:

- `config.json` is read as JSON into a plain namespace. A key the file
  lacks takes the default that transformers' config class would give it
  (transformers writes only the keys that differ from a default, and keeps
  every model-specific key).
- `.safetensors` files go through `read_safetensors`, a reader of the
  format itself: an 8-byte little-endian header length, a JSON header of
  {name: {dtype, shape, data_offsets}}, then the raw tensors
  (`write_safetensors` writes it, for HF-peft adapters). `.bin` files
  go through `torch.load(weights_only=True)`. Sharded checkpoints are
  merged through their `*.index.json`.

Families: gpt2, gptj and llama (causal), t5 and mt5 (seq2seq), with the
reference's config mappings and weight layouts. HF keeps [out, in] Linear
weights (GPT-2's Conv1D keeps [in, out]); the port keeps [in, out]
kernels, with the attention heads flattened. gpt_neox, opt, bloom,
gpt_bigcode and gpt_neo raise NotImplementedError (ROADMAP queue 7).
As in the reference, GPT-J's lm_head bias is not read (it is zero in a
fresh model; the export writes zeros), and Llama's `rope_scaling` is not
read.
"""

from __future__ import annotations

import json
import os
import shutil
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch

from trlx_tpu_torch.models.seq2seq import Seq2SeqConfig
from trlx_tpu_torch.models.transformer import TransformerConfig

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "pytorch_model.bin"
CAUSAL_TYPES = ("gpt2", "gptj", "llama")
SEQ2SEQ_TYPES = ("t5", "mt5")
# the reference's other families, whose switches the port has not reached
UNPORTED_TYPES = ("gpt_neox", "opt", "bloom", "gpt_bigcode", "gpt_neo")

# transformers' defaults for the keys a config.json may leave out
_DEFAULTS = {
    "gpt2": dict(n_inner=None, layer_norm_epsilon=1e-5, n_positions=1024),
    "gptj": dict(n_inner=None, layer_norm_epsilon=1e-5, n_positions=2048, rotary_dim=64),
    "llama": dict(num_key_value_heads=None, rope_theta=10000.0, rms_norm_eps=1e-6,
                  max_position_embeddings=2048, tie_word_embeddings=False),
    "t5": dict(relative_attention_max_distance=128, feed_forward_proj="relu", num_decoder_layers=None,
               tie_word_embeddings=True, decoder_start_token_id=0, layer_norm_epsilon=1e-6),
    "mt5": dict(relative_attention_max_distance=128, feed_forward_proj="gated-gelu", num_decoder_layers=None,
                tie_word_embeddings=False, decoder_start_token_id=0, layer_norm_epsilon=1e-6),
}


def _unported(model_type: str) -> NotImplementedError:
    return NotImplementedError(
        f"HF model_type {model_type!r} is not ported yet (ROADMAP queue 7; the port loads "
        f"{', '.join(CAUSAL_TYPES + SEQ2SEQ_TYPES)})"
    )


def read_config(path: str) -> SimpleNamespace:
    """`<path>/config.json` as a namespace, with transformers' defaults for
    the keys it leaves out."""
    with open(os.path.join(path, CONFIG_NAME)) as f:
        raw = json.load(f)
    mt = raw.get("model_type")
    return SimpleNamespace(**{**_DEFAULTS.get(mt, {}), **raw})


def config_from_hf(hf: Any, dtype=None, param_dtype=None) -> TransformerConfig:
    """The `TransformerConfig` of an HF causal config (the reference's
    mapping); dtypes default to bf16 compute, fp32 params."""
    dt = dict(dtype=dtype or torch.bfloat16, param_dtype=param_dtype or torch.float32)
    mt = hf.model_type
    if mt == "gpt2":
        return TransformerConfig(
            vocab_size=hf.vocab_size, hidden_size=hf.n_embd, n_layer=hf.n_layer, n_head=hf.n_head,
            n_positions=hf.n_positions, intermediate_size=hf.n_inner or 4 * hf.n_embd,
            pos_embed="learned", activation="gelu_new", layer_norm_epsilon=hf.layer_norm_epsilon,
            tie_word_embeddings=True, **dt,
        )
    if mt == "gptj":
        return TransformerConfig(
            vocab_size=hf.vocab_size, hidden_size=hf.n_embd, n_layer=hf.n_layer, n_head=hf.n_head,
            n_positions=hf.n_positions, intermediate_size=hf.n_inner or 4 * hf.n_embd,
            pos_embed="rotary", rotary_style="gptj", rotary_dim=hf.rotary_dim, activation="gelu_new",
            layer_norm_epsilon=hf.layer_norm_epsilon, parallel_residual=True, use_attn_bias=False,
            use_mlp_bias=True, tie_word_embeddings=False, **dt,
        )
    if mt == "llama":
        return TransformerConfig(
            vocab_size=hf.vocab_size, hidden_size=hf.hidden_size, n_layer=hf.num_hidden_layers,
            n_head=hf.num_attention_heads, n_kv_head=hf.num_key_value_heads or hf.num_attention_heads,
            n_positions=hf.max_position_embeddings, intermediate_size=hf.intermediate_size,
            pos_embed="rotary", rotary_style="neox", rope_theta=hf.rope_theta, norm="rmsnorm",
            layer_norm_epsilon=hf.rms_norm_eps, activation="silu", mlp_gated=True, use_attn_bias=False,
            use_mlp_bias=False, use_norm_bias=False, tie_word_embeddings=hf.tie_word_embeddings, **dt,
        )
    if mt in UNPORTED_TYPES:
        raise _unported(mt)
    raise ValueError(f"unsupported model_type {mt!r} (causal: {', '.join(CAUSAL_TYPES)})")


def seq2seq_config_from_hf(hf: Any, dtype=None, param_dtype=None) -> Seq2SeqConfig:
    """The `Seq2SeqConfig` of an HF T5 / mT5 config (the reference's
    mapping)."""
    if hf.model_type not in SEQ2SEQ_TYPES:
        raise ValueError(f"unsupported seq2seq model_type {hf.model_type!r}")
    return Seq2SeqConfig(
        vocab_size=hf.vocab_size, d_model=hf.d_model, n_layer=hf.num_layers,
        n_decoder_layer=hf.num_decoder_layers or hf.num_layers, n_head=hf.num_heads, d_kv=hf.d_kv,
        d_ff=hf.d_ff, relative_attention_num_buckets=hf.relative_attention_num_buckets,
        relative_attention_max_distance=hf.relative_attention_max_distance,
        layer_norm_epsilon=hf.layer_norm_epsilon,
        activation="gated-gelu" if "gated" in hf.feed_forward_proj else "relu",
        tie_word_embeddings=hf.tie_word_embeddings, decoder_start_token_id=hf.decoder_start_token_id or 0,
        dtype=dtype or torch.bfloat16, param_dtype=param_dtype or torch.float32,
    )


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(fp: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, as CPU tensors over the
    file's bytes read once."""
    with open(fp, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(meta["shape"])
    return out


def write_safetensors(fp: str, tensors: Dict[str, torch.Tensor]) -> None:
    """A `.safetensors` file of `tensors`, the reader's format: the JSON
    header padded with spaces to a multiple of 8 bytes, then each tensor's
    raw little-endian bytes back to back, in name order."""
    names = {dtype: name for name, dtype in _ST_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(fp, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def _load_file(fp: str) -> Dict[str, torch.Tensor]:
    if fp.endswith(".safetensors"):
        return read_safetensors(fp)
    return torch.load(fp, map_location="cpu", weights_only=True)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The weights of an HF-layout directory, a sharded checkpoint merged
    through its index file (the reference's `_read_state_dict`)."""
    for idx_name in ("pytorch_model.bin.index.json", "model.safetensors.index.json"):
        idx_fp = os.path.join(path, idx_name)
        if os.path.exists(idx_fp):
            with open(idx_fp) as f:
                index = json.load(f)
            sd: Dict[str, torch.Tensor] = {}
            for shard in sorted(set(index["weight_map"].values())):
                sd.update(_load_file(os.path.join(path, shard)))
            return sd
    for name in (WEIGHTS_NAME, "model.safetensors"):
        fp = os.path.join(path, name)
        if os.path.exists(fp):
            return _load_file(fp)
    raise FileNotFoundError(f"no model weights found under {path}")


# ---------------------------------------------------------------------------
# weight layouts: HF state dict <-> the port's state dict
# ---------------------------------------------------------------------------


def _f(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32).contiguous()


def _prefix(sd: Dict[str, Any], pfx: str) -> str:
    return pfx if any(k.startswith(pfx) for k in sd) else ""


def params_from_state_dict(sd: Dict[str, torch.Tensor], cfg: TransformerConfig,
                           model_type: str) -> Dict[str, torch.Tensor]:
    """A `TransformerLM` state dict (fp32) from an HF causal state dict."""
    E = cfg.hidden_size
    out: Dict[str, torch.Tensor] = {}
    if model_type == "gpt2":
        p = _prefix(sd, "transformer.")
        out["embed.wte"], out["embed.wpe"] = _f(sd[p + "wte.weight"]), _f(sd[p + "wpe.weight"])
        for i in range(cfg.n_layer):
            b, o = f"{p}h.{i}.", f"blocks.{i}."
            for ln in ("ln_1", "ln_2"):
                out[o + f"{ln}.scale"], out[o + f"{ln}.bias"] = _f(sd[b + f"{ln}.weight"]), _f(sd[b + f"{ln}.bias"])
            ws = _f(sd[b + "attn.c_attn.weight"]).split(E, dim=1)  # Conv1D: [in, out]
            bs = _f(sd[b + "attn.c_attn.bias"]).split(E)
            for j, name in enumerate("qkv"):
                out[o + f"attn.{name}.kernel"], out[o + f"attn.{name}.bias"] = ws[j].contiguous(), bs[j].contiguous()
            out[o + "attn.o.kernel"], out[o + "attn.o.bias"] = _f(sd[b + "attn.c_proj.weight"]), _f(sd[b + "attn.c_proj.bias"])
            for ours, theirs in (("fc_in", "c_fc"), ("fc_out", "c_proj")):
                out[o + f"mlp.{ours}.kernel"] = _f(sd[b + f"mlp.{theirs}.weight"])
                out[o + f"mlp.{ours}.bias"] = _f(sd[b + f"mlp.{theirs}.bias"])
        out["ln_f.scale"], out["ln_f.bias"] = _f(sd[p + "ln_f.weight"]), _f(sd[p + "ln_f.bias"])
        return out
    if model_type == "gptj":
        p = _prefix(sd, "transformer.")
        out["embed.wte"] = _f(sd[p + "wte.weight"])
        for i in range(cfg.n_layer):
            b, o = f"{p}h.{i}.", f"blocks.{i}."
            out[o + "ln_1.scale"], out[o + "ln_1.bias"] = _f(sd[b + "ln_1.weight"]), _f(sd[b + "ln_1.bias"])
            for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
                out[o + f"attn.{ours}.kernel"] = _f(sd[b + f"attn.{theirs}.weight"]).t().contiguous()
            for name in ("fc_in", "fc_out"):
                out[o + f"mlp.{name}.kernel"] = _f(sd[b + f"mlp.{name}.weight"]).t().contiguous()
                out[o + f"mlp.{name}.bias"] = _f(sd[b + f"mlp.{name}.bias"])
        out["ln_f.scale"], out["ln_f.bias"] = _f(sd[p + "ln_f.weight"]), _f(sd[p + "ln_f.bias"])
        out["lm_head.kernel"] = _f(sd["lm_head.weight"]).t().contiguous()
        return out
    if model_type == "llama":
        p = _prefix(sd, "model.")
        out["embed.wte"] = _f(sd[p + "embed_tokens.weight"])
        for i in range(cfg.n_layer):
            b, o = f"{p}layers.{i}.", f"blocks.{i}."
            out[o + "ln_1.scale"] = _f(sd[b + "input_layernorm.weight"])
            out[o + "ln_2.scale"] = _f(sd[b + "post_attention_layernorm.weight"])
            for name in "qkvo":
                out[o + f"attn.{name}.kernel"] = _f(sd[b + f"self_attn.{name}_proj.weight"]).t().contiguous()
            # HF: gate_proj activated, up_proj linear; ours: fc_in activated, fc_gate linear
            for ours, theirs in (("fc_in", "gate_proj"), ("fc_gate", "up_proj"), ("fc_out", "down_proj")):
                out[o + f"mlp.{ours}.kernel"] = _f(sd[b + f"mlp.{theirs}.weight"]).t().contiguous()
        out["ln_f.scale"] = _f(sd[p + "norm.weight"])
        if not cfg.tie_word_embeddings:
            out["lm_head.kernel"] = _f(sd["lm_head.weight"]).t().contiguous()
        return out
    if model_type in UNPORTED_TYPES:
        raise _unported(model_type)
    raise ValueError(f"unsupported model_type {model_type!r}")


def state_dict_from_params(params: Dict[str, torch.Tensor], cfg: TransformerConfig,
                           model_type: str) -> Dict[str, torch.Tensor]:
    """The inverse of `params_from_state_dict`: HF names and layouts, fp32."""
    E = cfg.hidden_size
    P = {k: _f(v) for k, v in params.items()}
    out: Dict[str, torch.Tensor] = {}
    if model_type == "gpt2":
        out["transformer.wte.weight"], out["transformer.wpe.weight"] = P["embed.wte"], P["embed.wpe"]
        for i in range(cfg.n_layer):
            b, o = f"transformer.h.{i}.", f"blocks.{i}."
            for ln in ("ln_1", "ln_2"):
                out[b + f"{ln}.weight"], out[b + f"{ln}.bias"] = P[o + f"{ln}.scale"], P[o + f"{ln}.bias"]
            out[b + "attn.c_attn.weight"] = torch.cat([P[o + f"attn.{n}.kernel"] for n in "qkv"], dim=1)
            out[b + "attn.c_attn.bias"] = torch.cat([P[o + f"attn.{n}.bias"] for n in "qkv"])
            out[b + "attn.c_proj.weight"], out[b + "attn.c_proj.bias"] = P[o + "attn.o.kernel"], P[o + "attn.o.bias"]
            for ours, theirs in (("fc_in", "c_fc"), ("fc_out", "c_proj")):
                out[b + f"mlp.{theirs}.weight"] = P[o + f"mlp.{ours}.kernel"]
                out[b + f"mlp.{theirs}.bias"] = P[o + f"mlp.{ours}.bias"]
        out["transformer.ln_f.weight"], out["transformer.ln_f.bias"] = P["ln_f.scale"], P["ln_f.bias"]
        out["lm_head.weight"] = out["transformer.wte.weight"]
        return out
    if model_type == "gptj":
        out["transformer.wte.weight"] = P["embed.wte"]
        for i in range(cfg.n_layer):
            b, o = f"transformer.h.{i}.", f"blocks.{i}."
            out[b + "ln_1.weight"], out[b + "ln_1.bias"] = P[o + "ln_1.scale"], P[o + "ln_1.bias"]
            for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
                out[b + f"attn.{theirs}.weight"] = P[o + f"attn.{ours}.kernel"].t().contiguous()
            for name in ("fc_in", "fc_out"):
                out[b + f"mlp.{name}.weight"] = P[o + f"mlp.{name}.kernel"].t().contiguous()
                out[b + f"mlp.{name}.bias"] = P[o + f"mlp.{name}.bias"]
        out["transformer.ln_f.weight"], out["transformer.ln_f.bias"] = P["ln_f.scale"], P["ln_f.bias"]
        out["lm_head.weight"] = P["lm_head.kernel"].t().contiguous()
        out["lm_head.bias"] = torch.zeros(cfg.vocab_size)
        return out
    if model_type == "llama":
        out["model.embed_tokens.weight"] = P["embed.wte"]
        for i in range(cfg.n_layer):
            b, o = f"model.layers.{i}.", f"blocks.{i}."
            out[b + "input_layernorm.weight"] = P[o + "ln_1.scale"]
            out[b + "post_attention_layernorm.weight"] = P[o + "ln_2.scale"]
            for name in "qkvo":
                out[b + f"self_attn.{name}_proj.weight"] = P[o + f"attn.{name}.kernel"].t().contiguous()
            for ours, theirs in (("fc_in", "gate_proj"), ("fc_gate", "up_proj"), ("fc_out", "down_proj")):
                out[b + f"mlp.{theirs}.weight"] = P[o + f"mlp.{ours}.kernel"].t().contiguous()
        out["model.norm.weight"] = P["ln_f.scale"]
        if "lm_head.kernel" in P:
            out["lm_head.weight"] = P["lm_head.kernel"].t().contiguous()
        else:
            out["lm_head.weight"] = out["model.embed_tokens.weight"]
        return out
    if model_type in UNPORTED_TYPES:
        raise _unported(model_type)
    raise ValueError(f"export not implemented for {model_type!r}")


_T5_ATTN = (("self_attn", "0.SelfAttention"), ("cross_attn", "1.EncDecAttention"))


def t5_params_from_state_dict(sd: Dict[str, torch.Tensor], cfg: Seq2SeqConfig) -> Dict[str, torch.Tensor]:
    """A `T5LM` state dict (fp32) from an HF T5 / mT5 state dict."""
    out = {"shared.wte": _f(sd["shared.weight"])}
    for side, n, dec in (("encoder", cfg.n_layer, False), ("decoder", cfg.n_decoder_layer, True)):
        for i in range(n):
            b, o = f"{side}.block.{i}.layer.", f"{side}.blocks.{i}."
            out[o + "ln_1.scale"] = _f(sd[b + "0.layer_norm.weight"])
            for ours, theirs in _T5_ATTN[: 2 if dec else 1]:
                for name in "qkvo":
                    out[o + f"{ours}.{name}.kernel"] = _f(sd[f"{b}{theirs}.{name}.weight"]).t().contiguous()
            if dec:
                out[o + "ln_cross.scale"] = _f(sd[b + "1.layer_norm.weight"])
            ff = f"{b}{2 if dec else 1}."
            out[o + "ln_2.scale"] = _f(sd[ff + "layer_norm.weight"])
            mlp = ff + "DenseReluDense."
            out[o + "mlp.fc_out.kernel"] = _f(sd[mlp + "wo.weight"]).t().contiguous()
            if mlp + "wi.weight" in sd:
                out[o + "mlp.fc_in.kernel"] = _f(sd[mlp + "wi.weight"]).t().contiguous()
            else:  # gated (v1.1): wi_0 activated, wi_1 linear
                out[o + "mlp.fc_in.kernel"] = _f(sd[mlp + "wi_0.weight"]).t().contiguous()
                out[o + "mlp.fc_gate.kernel"] = _f(sd[mlp + "wi_1.weight"]).t().contiguous()
        out[f"{side}.ln_f.scale"] = _f(sd[f"{side}.final_layer_norm.weight"])
        out[f"{side}.rel_bias"] = _f(sd[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        out["lm_head.kernel"] = _f(sd["lm_head.weight"]).t().contiguous()
    return out


def t5_state_dict_from_params(params: Dict[str, torch.Tensor], cfg: Seq2SeqConfig) -> Dict[str, torch.Tensor]:
    """The inverse of `t5_params_from_state_dict`: HF T5 names, fp32."""
    P = {k: _f(v) for k, v in params.items()}
    shared = P["shared.wte"]
    out = {"shared.weight": shared, "encoder.embed_tokens.weight": shared, "decoder.embed_tokens.weight": shared}
    for side, n, dec in (("encoder", cfg.n_layer, False), ("decoder", cfg.n_decoder_layer, True)):
        for i in range(n):
            b, o = f"{side}.block.{i}.layer.", f"{side}.blocks.{i}."
            out[b + "0.layer_norm.weight"] = P[o + "ln_1.scale"]
            for ours, theirs in _T5_ATTN[: 2 if dec else 1]:
                for name in "qkvo":
                    out[f"{b}{theirs}.{name}.weight"] = P[o + f"{ours}.{name}.kernel"].t().contiguous()
            if dec:
                out[b + "1.layer_norm.weight"] = P[o + "ln_cross.scale"]
            ff = f"{b}{2 if dec else 1}."
            out[ff + "layer_norm.weight"] = P[o + "ln_2.scale"]
            mlp = ff + "DenseReluDense."
            out[mlp + "wo.weight"] = P[o + "mlp.fc_out.kernel"].t().contiguous()
            if o + "mlp.fc_gate.kernel" in P:
                out[mlp + "wi_0.weight"] = P[o + "mlp.fc_in.kernel"].t().contiguous()
                out[mlp + "wi_1.weight"] = P[o + "mlp.fc_gate.kernel"].t().contiguous()
            else:
                out[mlp + "wi.weight"] = P[o + "mlp.fc_in.kernel"].t().contiguous()
        out[f"{side}.final_layer_norm.weight"] = P[f"{side}.ln_f.scale"]
        # HF keeps the relative bias on block 0 only
        out[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = P[f"{side}.rel_bias"]
    out["lm_head.weight"] = P["lm_head.kernel"].t().contiguous() if "lm_head.kernel" in P else shared
    return out


# ---------------------------------------------------------------------------
# directories
# ---------------------------------------------------------------------------


def is_hf_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, CONFIG_NAME))


def load_pretrained(path: str, dtype=None, param_dtype=None) -> Tuple[TransformerConfig, Dict[str, torch.Tensor], str]:
    """An HF-layout causal checkpoint directory: (config, `TransformerLM`
    state dict on the CPU, model_type)."""
    hf = read_config(path)
    if hf.model_type in SEQ2SEQ_TYPES:
        raise ValueError(f"{path} holds a seq2seq model ({hf.model_type}): set model_arch_type='seq2seq'")
    cfg = config_from_hf(hf, dtype=dtype, param_dtype=param_dtype)
    return cfg, params_from_state_dict(read_state_dict(path), cfg, hf.model_type), hf.model_type


def load_pretrained_seq2seq(path: str, dtype=None, param_dtype=None) -> Tuple[Seq2SeqConfig, Dict[str, torch.Tensor], str]:
    """An HF-layout T5 / mT5 checkpoint directory: (config, `T5LM` state
    dict on the CPU, model_type)."""
    hf = read_config(path)
    if hf.model_type in UNPORTED_TYPES:
        raise _unported(hf.model_type)
    cfg = seq2seq_config_from_hf(hf, dtype=dtype, param_dtype=param_dtype)
    return cfg, t5_params_from_state_dict(read_state_dict(path), cfg), hf.model_type


def save_pretrained_hf(params: Dict[str, torch.Tensor], cfg, model_type: str, config_dir: Optional[str],
                       path: str) -> None:
    """Write `params` (a `TransformerLM` or `T5LM` state dict) as a plain
    HF torch checkpoint: `pytorch_model.bin`, and `config.json` copied from
    `config_dir` (the directory the model was loaded from)."""
    os.makedirs(path, exist_ok=True)
    if model_type in SEQ2SEQ_TYPES:
        sd = t5_state_dict_from_params(params, cfg)
    else:
        sd = state_dict_from_params(params, cfg, model_type)
    # tied entries share one tensor in memory; torch.save keeps them shared
    torch.save(sd, os.path.join(path, WEIGHTS_NAME))
    if config_dir is not None and os.path.abspath(config_dir) != os.path.abspath(path):
        shutil.copyfile(os.path.join(config_dir, CONFIG_NAME), os.path.join(path, CONFIG_NAME))
