"""JAX parameter trees -> the port's state dicts.

The input is the reference's param tree as nested dicts of numpy arrays
(`jax.tree_util.tree_map(np.asarray, params)` on the JAX side); this
module itself imports no JAX. The reference stacks block leaves along a
leading layer axis and keeps attention kernels as [E, H, D] / [H, D, E];
the port has one module per block and [E, H*D] / [H*D, E] kernels.
The T5 trees (`models/seq2seq.py`) keep (H, d_kv) kernels the same way.
Adapters: the reference's stacked LoRA {path: {"a": [L, in, r], "b": [L,
r, out]}} becomes one pair a projection (`lora.blocks.{i}.attn.q.a`), and
`prompt.embedding` / `prefix.{k,v}` keep their names
(`models/peft.py::adapter_state_dict_from_jax`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from trlx_tpu_torch.models.peft import adapter_state_dict_from_jax
from trlx_tpu_torch.models.seq2seq import Seq2SeqConfig
from trlx_tpu_torch.models.transformer import TransformerConfig


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def lm_state_dict_from_jax(p: Mapping, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """State dict of a `TransformerLM` from a reference `TransformerLM`
    param tree {embed, blocks, ln_f[, lm_head]}; without `embed`, of the
    blocks and final norm alone (a value branch, whose blocks stack only its
    layers). Leaves the tree lacks (biases of a bias-free model, ln_2 under
    the parallel residual, wpe of a rotary model) are absent here too."""
    sd = {f"embed.{leaf}": _t(x) for leaf, x in p["embed"].items()} if "embed" in p else {}
    blocks = p["blocks"]
    E = cfg.hidden_size
    for i in range(len(blocks["ln_1"]["scale"])):
        pre = f"blocks.{i}."
        for ln in ("ln_1", "ln_2"):
            for leaf, x in blocks.get(ln, {}).items():
                sd[pre + f"{ln}.{leaf}"] = _t(x[i])
        for name in ("q", "k", "v", "o"):
            dense = blocks["attn"][name]
            shape = (-1, E) if name == "o" else (E, -1)
            sd[pre + f"attn.{name}.kernel"] = _t(dense["kernel"][i]).reshape(shape)
            if "bias" in dense:
                sd[pre + f"attn.{name}.bias"] = _t(dense["bias"][i]).reshape(-1)
        for name, dense in blocks["mlp"].items():
            for leaf, x in dense.items():
                sd[pre + f"mlp.{name}.{leaf}"] = _t(x[i])
    for leaf, x in p["ln_f"].items():
        sd[f"ln_f.{leaf}"] = _t(x)
    if "lm_head" in p:
        sd["lm_head.kernel"] = _t(p["lm_head"]["kernel"])
    return sd


def t5_state_dict_from_jax(p: Mapping, cfg: Seq2SeqConfig) -> Dict[str, torch.Tensor]:
    """State dict of a `T5LM` from a reference `T5LM` param tree {shared,
    encoder, decoder[, lm_head]}: block leaves stacked on a leading layer
    axis, q/k/v kernels [E, H, d_kv] and o kernels [H, d_kv, E]."""
    sd = {"shared.wte": _t(p["shared"]["wte"])}
    E = cfg.d_model
    for stack, n_layer in (("encoder", cfg.n_layer), ("decoder", cfg.n_decoder_layer)):
        blocks = p[stack]["blocks"]
        for i in range(n_layer):
            pre = f"{stack}.blocks.{i}."
            for ln in ("ln_1", "ln_cross", "ln_2"):
                if ln in blocks:
                    sd[pre + f"{ln}.scale"] = _t(blocks[ln]["scale"][i])
            for attn in ("self_attn", "cross_attn"):
                if attn not in blocks:
                    continue
                for name in ("q", "k", "v"):
                    sd[pre + f"{attn}.{name}.kernel"] = _t(blocks[attn][name]["kernel"][i]).reshape(E, -1)
                sd[pre + f"{attn}.o.kernel"] = _t(blocks[attn]["o"]["kernel"][i]).reshape(-1, E)
            for name, dense in blocks["mlp"].items():
                sd[pre + f"mlp.{name}.kernel"] = _t(dense["kernel"][i])
        sd[f"{stack}.ln_f.scale"] = _t(p[stack]["ln_f"]["scale"])
        sd[f"{stack}.rel_bias"] = _t(p[stack]["rel_bias"])
    if "lm_head" in p:
        sd["lm_head.kernel"] = _t(p["lm_head"]["kernel"])
    return sd


def head_state_dict_from_jax(head: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A `Head`'s entries from a reference head tree {fc_in, fc_out}, each
    {kernel, bias} (the same layouts)."""
    return {f"{prefix}.{dense}.{leaf}": _t(x) for dense in ("fc_in", "fc_out") for leaf, x in head[dense].items()}


def ilql_heads_state_dict_from_jax(heads: Mapping, prefix: str = "heads") -> Dict[str, torch.Tensor]:
    """An `ILQLHeads`' entries from the reference's {"q_heads": [..],
    "target_q_heads": [..], "v_head"} tree; a list that went through orbax
    comes back as {"0": .., "1": ..} and is read in index order."""
    sd = head_state_dict_from_jax(heads["v_head"], f"{prefix}.v_head")
    for group in ("q_heads", "target_q_heads"):
        items = heads[group]
        if isinstance(items, Mapping):
            items = [items[k] for k in sorted(items, key=int)]
        for i, head in enumerate(items):
            sd.update(head_state_dict_from_jax(head, f"{prefix}.{group}.{i}"))
    return sd


def params_from_jax(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """State dict from a reference param tree: a `CausalLMWithValueHead` or
    `Seq2SeqLMWithValueHead` `init_params` tree {base, v_head[, v_branch]},
    or an ILQL wrapper's {base, heads}, each with an adapter (`lora`,
    `prompt` or `prefix`) where it has one, gives the wrapper's state dict,
    a bare LM tree a `TransformerLM` or `T5LM` one (by the config's type)."""
    lm = t5_state_dict_from_jax if isinstance(cfg, Seq2SeqConfig) else lm_state_dict_from_jax
    if "base" not in tree:
        return lm(tree, cfg)
    sd = {f"base.{k}": v for k, v in lm(tree["base"], cfg).items()}
    if "heads" in tree:
        sd.update(ilql_heads_state_dict_from_jax(tree["heads"]))
    if "v_head" in tree:
        sd.update(head_state_dict_from_jax(tree["v_head"], "v_head"))
    if "v_branch" in tree:
        sd.update({f"v_branch.{k}": v for k, v in lm_state_dict_from_jax(tree["v_branch"], cfg).items()})
    sd.update(adapter_state_dict_from_jax(tree))
    return sd
