"""JAX parameter trees -> the port's state dicts.

The input is the reference's param tree as nested dicts of numpy arrays
(`jax.tree_util.tree_map(np.asarray, params)` on the JAX side); this
module itself imports no JAX. The reference stacks block leaves along a
leading layer axis and keeps attention kernels as [E, H, D] / [H, D, E];
the port has one module per block and [E, H*D] / [H*D, E] kernels.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from trlx_tpu_torch.models.transformer import TransformerConfig


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def lm_state_dict_from_jax(p: Mapping, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """State dict of a `TransformerLM` from a reference `TransformerLM`
    param tree {embed, blocks, ln_f}."""
    sd = {"embed.wte": _t(p["embed"]["wte"]), "embed.wpe": _t(p["embed"]["wpe"])}
    blocks = p["blocks"]
    E = cfg.hidden_size
    for i in range(cfg.n_layer):
        pre = f"blocks.{i}."
        for ln in ("ln_1", "ln_2"):
            for leaf, x in blocks[ln].items():
                sd[pre + f"{ln}.{leaf}"] = _t(x[i])
        for name in ("q", "k", "v"):
            dense = blocks["attn"][name]
            sd[pre + f"attn.{name}.kernel"] = _t(dense["kernel"][i]).reshape(E, -1)
            sd[pre + f"attn.{name}.bias"] = _t(dense["bias"][i]).reshape(-1)
        o = blocks["attn"]["o"]
        sd[pre + "attn.o.kernel"] = _t(o["kernel"][i]).reshape(-1, E)
        sd[pre + "attn.o.bias"] = _t(o["bias"][i])
        for name in ("fc_in", "fc_out"):
            for leaf, x in blocks["mlp"][name].items():
                sd[pre + f"mlp.{name}.{leaf}"] = _t(x[i])
    for leaf, x in p["ln_f"].items():
        sd[f"ln_f.{leaf}"] = _t(x)
    return sd


def params_from_jax(tree: Mapping, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """State dict from a reference param tree: a
    `CausalLMWithValueHead.init_params` tree {base, v_head} gives a
    `CausalLMWithValueHead` state dict, a bare LM tree a `TransformerLM`
    one."""
    if "base" not in tree:
        return lm_state_dict_from_jax(tree, cfg)
    sd = {f"base.{k}": v for k, v in lm_state_dict_from_jax(tree["base"], cfg).items()}
    for dense in ("fc_in", "fc_out"):
        for leaf, x in tree["v_head"][dense].items():
            sd[f"v_head.{dense}.{leaf}"] = _t(x)
    return sd
