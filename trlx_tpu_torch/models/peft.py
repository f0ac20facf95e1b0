"""Parameter-efficient fine-tuning: LoRA, prompt tuning and prefix tuning
(the port of trlx_tpu.models.peft).

The adapters live on the wrapper beside `base`, under the reference's
keys, and the base is frozen whenever one is on:

  lora    a `models/lora.py` tree: `lora.blocks.{i}.attn.q.{a,b}` ...
  prompt  `prompt.embedding` [n_virtual, E]: soft tokens, run as real
          leading sequence positions
  prefix  `prefix.k`, `prefix.v` [L, n_virtual, Hkv, D]: per-layer keys
          and values before every layer's own

`TransformerLM.forward` takes the prompt and prefix adapters as its
`prefix_embeds` / `kv_prefix` kwargs (`adapter_call_kwargs`);
`models/generation.py::generate` warms its cache with them.

HF-peft checkpoints: `save_peft_adapter` writes `adapter_config.json` and
`adapter_model.safetensors` with the reference's names (`_HF_LORA_MODULES`,
`_LOGICAL_MODULE`), through `models/hf.py::write_safetensors`;
`load_peft_adapter` reads them (or `adapter_model.bin`) back, a fused
GPT-2 `c_attn` adapter split into q, k and v column blocks.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from trlx_tpu_torch.models import hf
from trlx_tpu_torch.models.lora import (
    DEFAULT_TARGETS,
    fp32_tensor,
    build_lora,
    init_lora,
    lora_state_dict_from_stacked,
    stacked_from_lora,
)

ADAPTER_KEYS = ("lora", "prompt", "prefix")


def normalize_peft_config(peft_config: Any) -> Optional[Dict[str, Any]]:
    """An HF-peft-style dict ({"peft_type": ..., ...}) in the reference's
    normal form; None for no adapter."""
    if peft_config is None:
        return None
    cfg = dict(peft_config)
    peft_type = str(cfg.get("peft_type", "LORA")).upper()
    if peft_type == "LORA":
        return {
            "peft_type": "LORA",
            "r": int(cfg.get("r", 8)),
            "alpha": float(cfg.get("lora_alpha", cfg.get("alpha", 16))),
            "targets": cfg.get("target_modules") or DEFAULT_TARGETS,
        }
    if peft_type in ("PROMPT_TUNING", "PREFIX_TUNING"):
        return {"peft_type": peft_type, "num_virtual_tokens": int(cfg.get("num_virtual_tokens", 10))}
    raise ValueError(f"peft_type {peft_type!r} not supported (LORA | PROMPT_TUNING | PREFIX_TUNING)")


def read_peft_config(peft_config: Any) -> Optional[Dict[str, Any]]:
    """The normalized config a `model.peft_config` names: an HF-peft-style
    dict, or the path of an adapter directory (its `adapter_config.json`);
    None for no adapter."""
    if isinstance(peft_config, str):
        if not is_peft_checkpoint(peft_config):
            raise ValueError(
                f"peft_config {peft_config!r} is a string but not an adapter checkpoint directory (no "
                'adapter_config.json inside); pass either a trained HF-peft adapter dir or a config dict like '
                '{"peft_type": "LORA", "r": 8}')
        with open(os.path.join(peft_config, ADAPTER_CONFIG)) as f:
            peft_config = json.load(f)
    return normalize_peft_config(peft_config)


def check_peft_arch(pc: Dict[str, Any], seq2seq: bool) -> None:
    """Seq2seq takes LoRA only, as in the reference (whose own peft tests
    skip seq2seq prompt and prefix tuning)."""
    if seq2seq and pc["peft_type"] != "LORA":
        raise NotImplementedError("seq2seq supports peft_type='LORA' only")


class PromptAdapter(nn.Module):
    """Prompt tuning's soft tokens: `embedding` [n_virtual, E]."""

    def __init__(self, n_virtual: int, hidden: int, dtype, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(n_virtual, hidden, dtype=dtype, device=device))


class PrefixAdapter(nn.Module):
    """Prefix tuning's per-layer keys and values: `k`, `v` [L, n_virtual,
    Hkv, D]."""

    def __init__(self, n_layer: int, n_virtual: int, n_kv_head: int, head_dim: int, dtype, device=None):
        super().__init__()
        shape = (n_layer, n_virtual, n_kv_head, head_dim)
        self.k = nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))
        self.v = nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def attach_adapter(wrapper: nn.Module, pc: Dict[str, Any]) -> None:
    """Add the adapter `pc` (normalized) to `wrapper` (zeros until
    `init_adapters`): a LoRA tree over `wrapper.base` as `wrapper.lora`,
    or `wrapper.prompt` / `wrapper.prefix` for a causal LM."""
    base = wrapper.base
    cfg = wrapper.cfg
    dev = next(base.parameters()).device
    if pc["peft_type"] == "LORA":
        wrapper.lora = build_lora(base, pc["r"], pc["alpha"], pc["targets"])
    elif pc["peft_type"] == "PROMPT_TUNING":
        wrapper.prompt = PromptAdapter(pc["num_virtual_tokens"], cfg.hidden_size, cfg.param_dtype, dev)
    else:
        wrapper.prefix = PrefixAdapter(cfg.n_layer, pc["num_virtual_tokens"], cfg.n_kv_head, cfg.head_dim,
                                       cfg.param_dtype, dev)


@torch.no_grad()
def init_adapters(wrapper: nn.Module, generator: torch.Generator) -> None:
    """Fresh adapter values, as the reference's init: LoRA A ~ N(0, 0.02)
    and B = 0; soft tokens and prefixes ~ N(0, 0.02)."""
    if hasattr(wrapper, "lora"):
        init_lora(wrapper.lora, generator)
    for key in ("prompt", "prefix"):
        module = getattr(wrapper, key, None)
        if module is not None:
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float32) * 0.02)


def has_adapter(wrapper: nn.Module) -> bool:
    return any(getattr(wrapper, key, None) is not None for key in ADAPTER_KEYS)


def adapter_call_kwargs(wrapper: nn.Module) -> Dict[str, Any]:
    """`TransformerLM.forward` kwargs of the wrapper's prompt or prefix
    adapter (LoRA runs inside the projections instead)."""
    kw: Dict[str, Any] = {}
    prompt = getattr(wrapper, "prompt", None)
    if prompt is not None:
        kw["prefix_embeds"] = prompt.embedding
    prefix = getattr(wrapper, "prefix", None)
    if prefix is not None:
        kw["kv_prefix"] = {"k": prefix.k, "v": prefix.v}
    return kw


def adapter_state_dict_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The wrapper's adapter entries from the reference's param tree keys
    `lora` (stacked), `prompt` and `prefix`."""
    sd: Dict[str, torch.Tensor] = {}
    if "lora" in tree:
        sd.update(lora_state_dict_from_stacked(tree["lora"]))
    if "prompt" in tree:
        sd["prompt.embedding"] = fp32_tensor(tree["prompt"]["embedding"])
    if "prefix" in tree:
        for side in ("k", "v"):
            sd[f"prefix.{side}"] = fp32_tensor(tree["prefix"][side])
    return sd


# ---------------------------------------------------------------------------
# HF-peft checkpoints
# ---------------------------------------------------------------------------

# per-layer HF module prefixes of the ported families with separate q/k/v
# projections; the others (GPT-2's fused c_attn) take the logical names
_HF_LORA_MODULES = {
    "gptj": ("transformer.h.{i}.attn.", {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}),
    "llama": ("model.layers.{i}.self_attn.", {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj"}),
}
_LOGICAL_MODULE = "layers.{i}.{mod}"

# foreign HF module name -> the block-local module
_HF_TO_OURS = {
    "q_proj": "q", "k_proj": "k", "v_proj": "v",
    "o_proj": "o", "out_proj": "o", "dense": "o",
    "q": "q", "k": "k", "v": "v", "o": "o",
    "fc_in": "fc_in", "fc_out": "fc_out", "fc_gate": "fc_gate",
    "gate_proj": "fc_gate", "up_proj": "fc_in", "down_proj": "fc_out",
}
_OUR_PATH = {
    "q": "blocks/attn/q/kernel", "k": "blocks/attn/k/kernel",
    "v": "blocks/attn/v/kernel", "o": "blocks/attn/o/kernel",
    "fc_in": "blocks/mlp/fc_in/kernel", "fc_gate": "blocks/mlp/fc_gate/kernel",
    "fc_out": "blocks/mlp/fc_out/kernel",
}

ADAPTER_CONFIG = "adapter_config.json"
ADAPTER_SAFETENSORS = "adapter_model.safetensors"
ADAPTER_BIN = "adapter_model.bin"


def adapter_tensors(wrapper: nn.Module) -> Dict[str, Any]:
    """The wrapper's adapter in the reference's in-memory layout: {"lora":
    stacked} | {"prompt": {"embedding"}} | {"prefix": {"k", "v"}}."""
    if getattr(wrapper, "lora", None) is not None:
        return {"lora": stacked_from_lora(wrapper.lora)}
    if getattr(wrapper, "prompt", None) is not None:
        return {"prompt": {"embedding": wrapper.prompt.embedding.detach().float().cpu()}}
    if getattr(wrapper, "prefix", None) is not None:
        return {"prefix": {s: getattr(wrapper.prefix, s).detach().float().cpu() for s in ("k", "v")}}
    return {}


def save_peft_adapter(directory: str, adapter: Dict[str, Any], peft_cfg: Dict[str, Any],
                      model_type: Optional[str] = None) -> None:
    """Write an HF-peft adapter checkpoint: `adapter_config.json` and
    `adapter_model.safetensors` (per-layer names, torch Linear layout:
    lora_A.weight [r, in], lora_B.weight [out, r])."""
    os.makedirs(directory, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    adapter_config: Dict[str, Any] = {
        "peft_type": peft_cfg["peft_type"], "task_type": "CAUSAL_LM", "base_model_name_or_path": model_type or "",
    }
    if peft_cfg["peft_type"] == "LORA":
        adapter_config.update(r=peft_cfg["r"], lora_alpha=peft_cfg["alpha"], lora_dropout=0.0)
        prefix_fmt, name_map = _HF_LORA_MODULES.get(model_type or "", (None, None))
        target_modules = set()
        for path, ab in adapter["lora"].items():
            mod = path.split("/")[-2]
            a, b = ab["a"].float(), ab["b"].float()  # [L, in, r], [L, r, out]
            for i in range(a.shape[0]):
                if prefix_fmt is not None and mod in name_map:
                    module = prefix_fmt.format(i=i) + name_map[mod]
                else:
                    module = _LOGICAL_MODULE.format(i=i, mod=mod)
                target_modules.add(module.rsplit(".", 1)[-1])
                stem = f"base_model.model.{module}"
                tensors[f"{stem}.lora_A.weight"] = a[i].t().contiguous()
                tensors[f"{stem}.lora_B.weight"] = b[i].t().contiguous()
        adapter_config["target_modules"] = sorted(target_modules)
    elif peft_cfg["peft_type"] in ("PROMPT_TUNING", "PREFIX_TUNING"):
        adapter_config["num_virtual_tokens"] = peft_cfg["num_virtual_tokens"]
        if peft_cfg["peft_type"] == "PROMPT_TUNING":
            emb = adapter["prompt"]["embedding"].float()
        else:
            # peft's prefix layout: [n_virtual, L * 2 * Hkv * D], each layer's
            # (key, value) pair consecutive on the second axis
            k, v = adapter["prefix"]["k"].float(), adapter["prefix"]["v"].float()
            L, n, Hkv, D = k.shape
            emb = torch.stack([k, v], dim=1).permute(2, 0, 1, 3, 4).reshape(n, L * 2 * Hkv * D)
        tensors["prompt_embeddings"] = emb.contiguous()
    else:
        raise ValueError(f"cannot export peft_type {peft_cfg['peft_type']!r}")
    hf.write_safetensors(os.path.join(directory, ADAPTER_SAFETENSORS), tensors)
    with open(os.path.join(directory, ADAPTER_CONFIG), "w") as f:
        json.dump(adapter_config, f, indent=2)


def is_peft_checkpoint(path: Any) -> bool:
    return isinstance(path, str) and os.path.isfile(os.path.join(path, ADAPTER_CONFIG))


def _layer_index(name: str) -> Optional[int]:
    """The first integer segment of an HF module name ('...h.3.attn...' -> 3)."""
    for seg in name.split("."):
        if seg.isdigit():
            return int(seg)
    return None


def load_peft_adapter(path: str, cfg) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(normalized peft config, adapter in the reference's in-memory
    layout) of an HF-peft adapter directory. Separate projections
    (q_proj/k_proj/v_proj/o_proj/out_proj and the logical names) map one to
    one; a fused c_attn / query_key_value adapter's shared lora_A feeds q,
    k and v, whose lora_B are its column blocks (exact: the fused delta
    splits by columns)."""
    pc = read_peft_config(path)
    st = os.path.join(path, ADAPTER_SAFETENSORS)
    if os.path.exists(st):
        sd = hf.read_safetensors(st)
    else:
        sd = torch.load(os.path.join(path, ADAPTER_BIN), map_location="cpu", weights_only=True)
    sd = {k: v.detach().float() for k, v in sd.items()}
    if pc["peft_type"] == "PROMPT_TUNING":
        return pc, {"prompt": {"embedding": sd["prompt_embeddings"]}}
    if pc["peft_type"] == "PREFIX_TUNING":
        emb = sd["prompt_embeddings"]
        n = emb.shape[0]
        Hkv, D = cfg.n_kv_head, cfg.head_dim
        L = emb.shape[1] // (2 * Hkv * D)
        kv = emb.reshape(n, L, 2, Hkv, D).permute(1, 2, 0, 3, 4)
        return pc, {"prefix": {"k": kv[:, 0].contiguous(), "v": kv[:, 1].contiguous()}}

    per_mod: Dict[str, Dict[Optional[int], Dict[str, torch.Tensor]]] = {}
    for name, w in sd.items():
        if ".lora_A." not in name and ".lora_B." not in name:
            continue
        side = "a" if ".lora_A." in name else "b"
        module = name.split(".lora_")[0].split(".")[-1]
        li = _layer_index(name)
        w = w.t().contiguous()  # a: [in, r]; b: [r, out]
        if module in ("c_attn", "query_key_value"):
            if side == "a":
                for m in ("q", "k", "v"):
                    per_mod.setdefault(m, {}).setdefault(li, {})["a"] = w
            else:
                out = w.shape[1] // 3
                for j, m in enumerate(("q", "k", "v")):
                    per_mod.setdefault(m, {}).setdefault(li, {})["b"] = w[:, j * out:(j + 1) * out]
            continue
        ours = _HF_TO_OURS.get(module)
        if ours is None and module == "lm_head":
            raise NotImplementedError("a LoRA adapter on lm_head is not ported yet (ROADMAP queue 7)")
        if ours is None:
            raise ValueError(f"cannot map adapter module {module!r} (from {name!r}) onto the transformer layout")
        per_mod.setdefault(ours, {}).setdefault(li, {})[side] = w

    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    for mod, by_layer in per_mod.items():
        layers = sorted(by_layer)
        if layers != list(range(cfg.n_layer)):
            raise ValueError(f"adapter for {mod!r} covers layers {layers}, expected all {cfg.n_layer} "
                             "(partial-layer adapters are not representable)")
        lora[_OUR_PATH[mod]] = {side: torch.stack([by_layer[i][side] for i in layers]) for side in ("a", "b")}
    return pc, {"lora": lora}


def targets_of(adapter: Dict[str, Any]):
    """A regex that matches exactly the paths a loaded LoRA adapter holds."""
    return "|".join(f"^{p}$" for p in sorted(adapter["lora"]))


def load_adapter_into(wrapper: nn.Module, adapter: Dict[str, Any]) -> None:
    """Copy a reference-layout adapter into the wrapper's own modules."""
    sd = adapter_state_dict_from_jax(adapter)
    own = wrapper.state_dict()
    missing = [k for k in sd if k not in own]
    if missing:
        raise ValueError(f"the adapter holds tensors the model has no place for: {missing[:4]}")
    with torch.no_grad():
        for k, v in sd.items():
            if tuple(own[k].shape) != tuple(v.shape):
                raise ValueError(f"adapter tensor {k}: {tuple(v.shape)} vs the model's {tuple(own[k].shape)}")
            own[k].copy_(v)
