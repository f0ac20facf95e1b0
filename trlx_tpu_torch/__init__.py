"""trlx_tpu_torch — the PyTorch/CUDA port of trlx_tpu for NVIDIA Hopper.

It grows slice by slice beside the JAX package and never imports it.
So far it covers online PPO end to end on a GPT-2-, GPT-J- or
Llama-class policy and on a T5-class encoder-decoder, `trlx_tpu_torch.train(reward_fn=...,
prompts=..., config=...)`: the left-padded KV-cache prefill and sampled
decode over an int8 cache (or the paged decode engine), the
teacher-forced experience pass (policy logits, values, frozen hydra
reference logits), the KL-penalised rewards, GAE, and the clipped PPO
steps under AdamW; GRPO and RFT on the same prompts-and-reward contract;
supervised fine-tuning, `train(samples=...)`, and DPO on (prompt, chosen,
rejected) triples; offline ILQL, `train(samples=..., rewards=...)`; and
`save_pretrained` with the reload through `model_path=<dir>`, which may
also name a local HF directory (`models/hf.py`). Its
attention kernels are hand-written CUDA C++ (`csrc/`: flash forward and
backward, T5's bias-carrying pair, int8 decode, paged decode), built on
first use by `ops/_build.py`.

Importing the package needs neither a GPU nor `nvcc`.
"""

__version__ = "0.2.0"

from trlx_tpu_torch.api import train  # noqa: F401,E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: F401,E402
