"""trlx_tpu_torch — the PyTorch/CUDA port of trlx_tpu for NVIDIA Hopper.

It grows slice by slice beside the JAX package and never imports it.
So far it covers the PPO rollout path of a GPT-2-class policy: the
left-padded KV-cache prefill, sampled decode over an int8 cache, and the
teacher-forced experience forward (policy logits, values, frozen hydra
reference logits). Its two attention kernels are hand-written CUDA C++
(`csrc/`), built on first use by `ops/_build.py`.

Importing the package needs neither a GPU nor `nvcc`.
"""

__version__ = "0.1.0"
