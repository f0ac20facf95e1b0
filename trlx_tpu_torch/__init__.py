"""trlx_tpu_torch — the PyTorch/CUDA port of trlx_tpu for NVIDIA Hopper.

It grows slice by slice beside the JAX package and never imports it.
So far it covers online PPO on a GPT-2-class policy end to end,
`trlx_tpu_torch.train(reward_fn=..., prompts=..., config=...)`: the
left-padded KV-cache prefill and sampled decode over an int8 cache, the
teacher-forced experience pass (policy logits, values, frozen hydra
reference logits), the KL-penalised rewards, GAE, and the clipped PPO
steps under AdamW. Its attention kernels are hand-written CUDA C++
(`csrc/`: flash forward and backward, int8 decode), built on first use by
`ops/_build.py`.

Importing the package needs neither a GPU nor `nvcc`.
"""

__version__ = "0.2.0"

from trlx_tpu_torch.api import train  # noqa: F401,E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: F401,E402
