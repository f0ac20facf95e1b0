"""Autoregressive generation: a KV-cache prefill over the left-padded
prompt, then single-token decode steps (port of
trlx_tpu.models.generation).

The reference jits one function with a `lax.while_loop`; here the decode
is a Python loop with the same early exit once every row has finished,
and `make_generate_fn` returns a plain closure. Sampling draws from an
explicit `torch.Generator` on the logits' device; its stream cannot
reproduce `jax.random`, so greedy decoding (`do_sample=False`) is the
path held token for token against the reference and sampling is held to
its distribution.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from trlx_tpu_torch.models.transformer import (
    TransformerLM,
    logit_projection,
    quantize_kv_cache,
)
from trlx_tpu_torch.ops.common import topk_mask
from trlx_tpu_torch.ops.int8_matmul import check_decode_dtype, quantize_kernel

# HF `generate` kwargs this sampler does not implement: ignored with a
# warning, so reference configs run unmodified
HF_GEN_KWARGS_UNIMPLEMENTED = frozenset({
    "num_beams", "num_beam_groups", "penalty_alpha", "use_cache",
    "typical_p", "epsilon_cutoff", "eta_cutoff", "diversity_penalty",
    "repetition_penalty", "encoder_repetition_penalty", "length_penalty",
    "no_repeat_ngram_size", "bad_words_ids", "force_words_ids",
    "renormalize_logits", "constraints", "forced_bos_token_id",
    "forced_eos_token_id", "remove_invalid_values", "early_stopping",
    "exponential_decay_length_penalty", "suppress_tokens",
    "begin_suppress_tokens", "forced_decoder_ids", "num_return_sequences",
    "output_attentions", "output_hidden_states", "output_scores",
    "return_dict_in_generate", "min_length", "min_new_tokens",
    "max_length", "max_time",
})


@dataclass(frozen=True)
class SamplerSettings:
    """Sampling hyperparameters (the HF gen_kwargs surface)."""

    max_new_tokens: int
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    do_sample: bool = True
    eos_token_id: int = -1  # -1: never stops early
    pad_token_id: int = 0

    @classmethod
    def from_gen_kwargs(cls, gen_kwargs: Dict, eos_token_id=None, pad_token_id=None):
        kw = dict(gen_kwargs)
        eos = kw.pop("eos_token_id", eos_token_id)
        pad = kw.pop("pad_token_id", pad_token_id)
        known = {f.name for f in dataclasses.fields(cls)}
        dropped_hf = set(kw) & HF_GEN_KWARGS_UNIMPLEMENTED
        if dropped_hf:
            logging.getLogger(__name__).warning(
                "SamplerSettings: ignoring HF gen_kwargs this sampler "
                f"does not implement: {sorted(dropped_hf)}"
            )
        kw = {k: v for k, v in kw.items() if k in known}
        return cls(
            **kw,
            eos_token_id=-1 if eos is None else int(eos),
            pad_token_id=0 if pad is None else int(pad),
        )


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: mask logits outside the smallest set with
    cumulative probability >= p (always keeps the argmax)."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < p  # a sorted position is kept while the mass before it is < p
    cutoff = torch.where(keep, sorted_desc, torch.full_like(sorted_desc, float("inf")))
    cutoff = cutoff.amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, torch.full_like(logits, float("-inf")), logits)


def process_logits(logits: torch.Tensor, settings: SamplerSettings) -> torch.Tensor:
    """Temperature / top-k / top-p pipeline in fp32."""
    logits = logits.float()
    if settings.temperature != 1.0:
        logits = logits / max(settings.temperature, 1e-6)
    if settings.top_k:
        logits = topk_mask(logits, settings.top_k)
    if settings.top_p < 1.0:
        logits = top_p_mask(logits, settings.top_p)
    return logits


def sample_token(
    generator: Optional[torch.Generator], logits: torch.Tensor, settings: SamplerSettings
) -> torch.Tensor:
    """Next tokens [B] from last-position logits [B, V]: the argmax when
    greedy, else a categorical draw from `generator` (on logits' device)."""
    logits = process_logits(logits, settings)
    if not settings.do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# -- per-lane sampling -------------------------------------------------------
#
# The decode engine keys every draw on (queue row, response index, event
# kind), never on the slot or the step. `jax.random` cannot be reproduced
# in torch, so the port builds the same contract on a counter-based hash:
# a draw is a pure function of (base seed, lane id, vocab index), computed
# with int64 tensor ops masked to 32 bits, so the integers are the same on
# every device. The base seed comes from the trainer's torch.Generator once
# per generate call.

_M32 = 0xFFFFFFFF


def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without leaving int64: the
    high 16 bits of x multiply only the low 16 bits of c."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * (c & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (lowbias32) on int64 tensors."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def lane_keys(base: int, lane_ids: torch.Tensor) -> torch.Tensor:
    """Per-lane 32-bit keys [M] (int64) from a base seed and lane ids."""
    seed = _mix32(torch.full((), int(base) & _M32, dtype=torch.int64, device=lane_ids.device))
    return _mix32(seed ^ _mix32(lane_ids.to(torch.int64) & _M32))


def lane_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Counter stream [M, n]: 32 random bits for each (lane, index)."""
    idx = _mulmod32(torch.arange(n, dtype=torch.int64, device=keys.device), 0x9E3779B9)
    return _mix32(_mix32(keys[:, None] ^ idx[None, :]) + keys[:, None])


def lane_uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Uniform draws in (0, 1), fp32, [M, n]: the top 24 bits of the
    counter stream, so every value is exact in fp32."""
    return ((lane_bits(keys, n) >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def lane_gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    return -torch.log(-torch.log(lane_uniform(keys, n)))


def sample_token_lanes(keys: torch.Tensor, logits: torch.Tensor, settings: SamplerSettings) -> torch.Tensor:
    """Per-lane sampling from [M, V] logits: each row draws from its own
    key (Gumbel-max, which is a categorical draw); the argmax when greedy."""
    logits = process_logits(logits, settings)
    if not settings.do_sample:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(logits + lane_gumbel(keys, logits.shape[-1]), dim=-1)


def categorical_lanes(keys: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Per-lane categorical draw from probability rows [M, V] (need not be
    normalised): the speculative residual re-draw."""
    logp = torch.log(torch.clamp(probs, min=1e-30))
    return torch.argmax(logp + lane_gumbel(keys, probs.shape[-1]), dim=-1)


def _quantized_projections(model: nn.Module) -> Dict[int, nn.Module]:
    """{id(kernel): projection module} of the block projections an int8
    decode copy quantizes: every `kernel_scale`-carrying projection under
    the blocks (a seq2seq model's decoder blocks: its encoder runs once,
    in full precision), when the config asks for int8 decode weights."""
    if getattr(getattr(model, "cfg", None), "decode_weights_quant", None) != "int8":
        return {}
    decoder = getattr(model, "decoder", None)
    blocks = decoder.blocks if decoder is not None else model.blocks
    return {id(m.kernel): m for m in blocks.modules()
            if hasattr(m, "kernel_scale") and m.kernel.dtype.is_floating_point}


def cast_params_for_decode(model: TransformerLM, compute_dtype: torch.dtype) -> TransformerLM:
    """A copy of `model` whose matmul weights (`kernel`, `wte`, `wpe`) are
    pre-cast to the compute dtype, so decode steps do not re-cast them;
    norm scales and biases stay fp32. Returns `model` itself when nothing
    needs a cast. The sampler then adds take(wte) + take(wpe) on rounded
    operands, while the teacher-forced pass adds in fp32 and rounds — the
    reference's split, kept on purpose.

    A projection with an active LoRA pair gets its merged weight W + s A B
    (fp32, then cast), as the reference merges before its sampler; the
    copy holds no pair (a pair switched off is dropped unmerged). With
    `decode_weights_quant="int8"` every block projection of the copy is
    int8 with per-output-channel scales (`kernel_scale`), quantized from
    its compute-dtype rounding as the reference quantizes its cast tree
    (`quantize_decode_weights`); embeddings and the head stay in the
    compute dtype. Only the new weights are allocated, one tensor at a
    time: the cast and quantized tensors are put in place during the
    copy."""
    merged = {}
    held = []
    for module in model.modules():
        pair = module.__dict__.get("lora")
        if pair is not None:
            held.append(pair)
            if pair.enabled:
                merged[id(module.kernel)] = pair
    quantized = _quantized_projections(model)
    if quantized:
        check_decode_dtype(next(iter(quantized.values())).kernel.device, compute_dtype)
    scales = {}
    memo = {id(pair): None for pair in held}
    for n, p in model.named_parameters():
        cast = (n.rsplit(".", 1)[-1] in ("kernel", "wte", "wpe") and p.dtype.is_floating_point
                and p.dtype != compute_dtype)
        pair = merged.get(id(p))
        module = quantized.get(id(p))
        if module is not None:
            data = p.detach() if pair is None else pair.merged(p.detach())
            q, scales[id(module)] = quantize_kernel(data.to(compute_dtype))
            memo[id(p)] = nn.Parameter(q, requires_grad=False)
        elif cast or pair is not None:
            data = p.detach() if pair is None else pair.merged(p.detach())
            memo[id(p)] = nn.Parameter(data.to(compute_dtype) if cast else data, requires_grad=False)
    if not memo:
        return model
    out = copy.deepcopy(model, memo)
    for module_id, s in scales.items():
        memo[module_id].kernel_scale = s  # the deep copy of that projection
    return out


@torch.no_grad()
def generate(
    model: TransformerLM,
    input_ids: torch.Tensor,  # [B, P], LEFT-padded
    attention_mask: torch.Tensor,  # [B, P]
    generator: Optional[torch.Generator],
    settings: SamplerSettings,
    logits_processor: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    soft_prompt: Optional[torch.Tensor] = None,  # [n, E] prompt tuning's soft tokens
    kv_prefix: Optional[Dict[str, torch.Tensor]] = None,  # {k, v} [L, n, Hkv, D] prefix tuning
) -> Dict[str, torch.Tensor]:
    """Sample up to `settings.max_new_tokens` continuations.

    Returns sequences [B, P+N] (prompt ++ response, response right-padded),
    response_ids [B, N] and response_mask [B, N] (1 for real response
    tokens, incl. the EOS). `logits_processor(hidden_last, logits)` runs
    before temperature/top-k/top-p.

    Adapters warm the cache: soft tokens run one extra prefill over slots
    [0, n); prefix keys and values are written there directly. Either way
    the prompt then occupies slots [n, n + P), its positions start at n,
    and the decode loop is adapter-oblivious (an int8 cache holds the
    virtual slots quantized like the rest)."""
    B, P = input_ids.shape
    N = settings.max_new_tokens
    if N < 1:
        raise ValueError("max_new_tokens must be >= 1")
    cfg = model.cfg
    dev = input_ids.device
    model = cast_params_for_decode(model, cfg.dtype)
    n_virt = 0
    if soft_prompt is not None:
        n_virt = soft_prompt.shape[0]
    elif kv_prefix is not None:
        n_virt = kv_prefix["k"].shape[1]
    # the reference's cache length: rounded up to 128 slots when its
    # prefill takes the fused kernel, so both packages compare equal shapes
    total = n_virt + P + N
    pad_slots = (-total) % 128 if cfg.attention_impl == "pallas" and P % 8 == 0 else 0
    total += pad_slots
    attention_mask = attention_mask.to(torch.int32)
    key_mask = torch.cat(
        [
            torch.ones((B, n_virt), dtype=torch.int32, device=dev),
            attention_mask,
            torch.ones((B, N), dtype=torch.int32, device=dev),
            torch.zeros((B, pad_slots), dtype=torch.int32, device=dev),
        ],
        dim=1,
    )
    cache = model.init_cache(B, total, key_mask)
    if kv_prefix is not None:
        for side in ("k", "v"):
            cache[side][:, :, :n_virt] = kv_prefix[side][:, None].to(cache[side].dtype)
        cache["index"] = n_virt
    elif soft_prompt is not None:
        warm = model(torch.zeros((B, n_virt), dtype=input_ids.dtype, device=dev), cache=cache,
                     prefix_embeds=soft_prompt, compute_logits=False)
        cache = warm["cache"]
    positions = n_virt + torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    out = model(input_ids, attention_mask, positions=positions, cache=cache,
                compute_logits=False)
    project = logit_projection(model)

    def pick_next(hidden_last, logits_last, finished):
        if logits_processor is not None:
            logits_last = logits_processor(hidden_last, logits_last)
        tok = sample_token(generator, logits_last, settings)
        tok = torch.where(finished, torch.full_like(tok, settings.pad_token_id), tok)
        return tok, finished | (tok == settings.eos_token_id)

    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    h_last = out["hidden_states"][:, -1]
    tok, finished = pick_next(h_last, project(h_last), finished)
    cache = out["cache"]
    if cfg.kv_cache_quant in ("int8", "int8_kernel"):
        cache = quantize_kv_cache(cache)

    ids_buf = torch.full((B, N), settings.pad_token_id, dtype=torch.long, device=dev)
    mask_buf = torch.zeros((B, N), dtype=torch.bool, device=dev)
    ids_buf[:, 0] = tok
    mask_buf[:, 0] = True
    pos = n_virt + attention_mask.sum(dim=1).long()  # the next token's real position
    t = 1
    while t < N and not bool(finished.all()):
        step = model(tok[:, None], positions=pos[:, None], cache=cache)
        next_tok, now_finished = pick_next(
            step["hidden_states"][:, -1], step["logits"][:, -1], finished
        )
        ids_buf[:, t] = next_tok
        mask_buf[:, t] = ~finished  # real iff the row had not finished before it
        cache, tok, finished = step["cache"], next_tok, now_finished
        pos = pos + 1
        t += 1
    return {
        "sequences": torch.cat([input_ids.long(), ids_buf], dim=1),
        "response_ids": ids_buf,
        "response_mask": mask_buf.to(torch.int32),
    }


def make_generate_fn(
    model: TransformerLM,
    settings: SamplerSettings,
    logits_processor: Optional[Callable] = None,
):
    """`(input_ids, attention_mask, generator) -> dict` sampler closure."""

    def fn(input_ids, attention_mask, generator):
        return generate(
            model, input_ids, attention_mask, generator, settings,
            logits_processor=logits_processor,
        )

    return fn
