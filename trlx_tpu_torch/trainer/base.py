"""Trainer base: model/optimizer setup, generation (with the logits
processor hook that ILQL's evaluations sample through), evaluation and
the per-step `learn()` loop (port of the parts of trlx_tpu.trainer.base
that the PPO, GRPO, SFT, ILQL, RFT and DPO trainers run: `TPUBaseTrainer`
and the `TPUOnlineTrainer` experience core).

What the port does differently, and why:
- Freezing. The reference masks the optimizer's UPDATES of frozen leaves
  (`make_freeze_mask`: the embeddings and the blocks below `branch_at`).
  Here frozen parameters get `requires_grad_(False)` and stay out of the
  optimizer; the parameters come out identical. Frozen leaves then have no
  optimizer moments in a checkpoint.
- The inner loop. `train.fused_inner_loop` (default on) makes the
  reference scan all `ppo_epochs` x minibatch steps in one device call
  over `_epoch_perms`, which are by construction the per-epoch loader
  orders (`pipeline.epoch_shuffle_order` with seed train.seed +
  iter_count). The port accepts the knob and always runs the per-step
  loop over those same permutations, with the per-step loop's cadence of
  evaluation, stats and callbacks; a CUDA graph of the step is its
  analogue of the fused scan (ROADMAP queue 1, item 14).
- The rollout prefetch (`method.overlap_rollouts`). The reference
  generates the next cycle's first chunk with the pre-update weights
  just before it dispatches the fused block, and scores it (decode,
  reward, experience pass) with the updated weights when the next cycle
  starts. The port calls the same hook before the first step of each
  cycle's run (only under `train.fused_inner_loop`, as the reference
  prefetches in no other mode), so the stored chunk is the same. What
  it does not do is overlap: the eager sampler reads a host flag every
  decode step, so its device work has ended when the hook returns, and
  the host cannot score the chunk under a block that it is itself still
  launching step by step. The overlap comes with the captured loops of
  ROADMAP queue 1, item 14.
- Deferred stats. The rollout stats are staged with
  `utils.trackers.DeferredStats` (one stacked copy into pinned memory
  behind a CUDA event) and logged at the next flush, as in the
  reference. The train step still reads its loss and stats at once (the
  per-step loop's NaN guard needs them).
- `train.timing_split` times a no-grad forward-only `loss` pass once per
  batch shape (warm, then timed, the device synchronised before each
  clock read) and logs `time/forward` / `time/backward` from the second
  step of each batch shape, as the reference's per-step loop does.
- One process, one device: no mesh and no row padding for sharding.
- The decode engine (`method.gen_engine`) takes rollout and evaluation
  sampling as in the reference, with one lane group; its speculative
  draft is the frozen reference (the hydra Branch under the policy's
  trunk, or the full copy).
- Weights. `save_pretrained` writes the reference's native artifact
  with torch files in place of orbax: `trlx_tpu_config.json` (the same
  keys and values), the base LM's state dict and every other parameter
  ("aux", the value head) in a second file. `model_path` loads such a
  directory, "random", or a local HF directory (`models/hf.py`: gpt2,
  gptj, llama, t5, mt5); a model loaded from HF is saved in the HF layout
  again (`pytorch_model.bin`, its `config.json` carried over), with the
  aux file beside it. A hub name raises (no network; ROADMAP queue 7).
- Checkpoints. `save` writes the reference's layout with torch files for
  orbax: `state/` holds the model's, the optimizer's and the scheduler's
  state dicts, `state.json` the reference's resume keys plus every random
  stream the port draws from, `topology.json` each tensor's shape and
  dtype. `_save_checkpoint` commits `state/` and `hf_model/` atomically
  through `utils.checkpointing.CheckpointManager`; `load` verifies the
  integrity manifest, then the topology, then restores. The loop also
  stores where it stands in its pass over the data (`loop_position`), so
  an offline trainer resumed mid-pass continues the same minibatch order.
- The memory recipe. `train.minibatch_size` splits each step's batch
  into microbatches whose gradients and stats are summed in fp32 and
  averaged, as the reference's scan does. `train.grads_dtype` (bf16)
  keeps the gradient tree in that dtype beside the fp32 masters: a
  post-accumulate hook on each trainable parameter moves its fp32
  `.grad` into the tree as the backward produces it, so at most one
  parameter's fp32 gradient is alive at a time (the reference
  differentiates through a bf16 view of the parameters instead; the two
  round differently where a parameter's gradient is a sum, the tied wte,
  or where it is used in fp32, the norm gains). `train.remat_policy`
  checkpoints each block (`ops/remat.py`). With the fused 8-bit AdamW a
  step whose loss or gradients are not finite applies with zeroed
  gradients (its count advances, its moments decay, its weight decay
  applies), as in the reference's fused branch; other optimizers skip it.
- Adapters (`model.peft_config`). The reference masks the base's updates
  and keeps the adapter beside it in its param tree; here `init_weights`
  attaches the adapter to the wrapper (`models/peft.py`), the base gets
  `requires_grad_(False)` and no AdamW state, and the reference model is
  the same base with the adapter off (`wrappers.AdapterOffReference`).
- The guardrails, the memory doctor and the chaos harness
  (`train.guardrails`, `train.memory`, `train.chaos`) hook into the
  per-step loop where the reference's per-step loop takes them: the chaos
  sites at fixed points, an OOM envelope around each train step and each
  rollout generate() call, the watermark and the ladder once a step. An
  OOM is handled after its `except` block has ended (the exception's
  traceback holds the failed step's activations), with the step's partial
  gradients cleared and the allocator's cache emptied before the retry;
  an OOM inside the optimizer step leaves some parameters updated and
  others not, so it rolls back instead of retrying. The watchdog, the
  flight recorder, the resilient reward I/O, the transport, fleet and
  serving tiers are not ported yet; each knob that would turn one on
  raises NotImplementedError naming its ROADMAP queue.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import json
import os
import random
import time
import weakref
from abc import abstractmethod
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data import PromptBatch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import hf
from trlx_tpu_torch.models.gen_engine import (
    GenEngineConfig,
    compose_draft_params,
    hydra_shared_trunk_layers,
    make_engine_fn,
)
from trlx_tpu_torch.models.generation import (
    HF_GEN_KWARGS_UNIMPLEMENTED,
    SamplerSettings,
    generate,
)
from trlx_tpu_torch.models.peft import (
    ADAPTER_KEYS,
    adapter_tensors,
    attach_adapter,
    check_peft_arch,
    has_adapter,
    load_adapter_into,
    load_peft_adapter,
    read_peft_config,
    save_peft_adapter,
    targets_of,
)
from trlx_tpu_torch.models.seq2seq import Seq2SeqConfig, generate_seq2seq
from trlx_tpu_torch.models.transformer import TransformerConfig, logit_projection, to_torch_dtype
from trlx_tpu_torch.models.wrappers import AdapterOffReference, CausalLM
from trlx_tpu_torch.ops.int8_matmul import check_decode_dtype
from trlx_tpu_torch.ops.remat import resolve_remat
from trlx_tpu_torch.ops.common import (
    chunked_logprobs,
    logprobs_of_labels,
    running_moments_init,
    running_moments_update,
)
from trlx_tpu_torch.trainer import BaseRLTrainer
from trlx_tpu_torch.utils import (
    Clock,
    build_optimizer,
    infinite_loader,
    init_optimizer_state,
    logging,
    significant,
    to_scalar,
)
from trlx_tpu_torch.utils.chaos import build_chaos, poison_batch
from trlx_tpu_torch.utils.checkpointing import (
    TOPOLOGY_MANIFEST,
    CheckpointCorruptError,
    CheckpointManager,
    ElasticConfig,
    PreemptionHandler,
    atomic_json_write,
    verify_or_quarantine,
)
from trlx_tpu_torch.utils.device import resolve_device
from trlx_tpu_torch.utils.guardrails import MEMORY_SIGNAL, build_monitor
from trlx_tpu_torch.utils.memdoctor import (
    MemoryAbortError,
    MemoryPlanError,
    OOMEvent,
    build_memdoctor,
    classify_oom,
    estimate_plan,
    is_degraded_record,
    is_oom,
    remat_strength,
)
from trlx_tpu_torch.utils.resilient import ChaosFault, CircuitBreaker, retry_call
from trlx_tpu_torch.utils.tokenizers import load_tokenizer
from trlx_tpu_torch.utils.trackers import DeferredStats, Tracker

logger = logging.get_logger(__name__)


def _masked_kl_stats(kl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean KL per row, mean KL per token) over the chunk's rows."""
    return kl.sum(dim=1).mean(), kl.mean()

# TransformerConfig knobs that tune execution, not architecture: their
# presence alone does not select the random-init path
_RUNTIME_TRANSFORMER_KEYS = frozenset({
    "attention_impl", "kv_cache_quant", "decode_weights_quant",
    "pp_microbatches", "pp_schedule",
})

# a save_pretrained directory: the reference's architecture file, and the
# port's two weight files in place of its orbax `params/` and `aux/`
NATIVE_CONFIG = "trlx_tpu_config.json"
BASE_WEIGHTS = "base_weights.pt"
AUX_WEIGHTS = "aux_weights.pt"
# a checkpoint's state/ tree: the reference's orbax {params, opt_state}
# as the state dicts of the model, the optimizer and the LR scheduler
STATE_FILES = {"model": "model.pt", "optimizer": "optimizer.pt", "scheduler": "scheduler.pt"}


def _unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({where})")


def _apply_runtime_overrides(cfg, extra: Dict[str, Any]):
    """The runtime keys of a `model_extra_configs` sub-dict applied onto a
    loaded model config (only the fields the config has: seq2seq has no
    kv_cache_quant)."""
    names = {f.name for f in dataclasses.fields(cfg)}
    overrides = {k: v for k, v in extra.items() if k in _RUNTIME_TRANSFORMER_KEYS and k in names}
    return cfg.replace(**overrides) if overrides else cfg


def _batch_shape_key(batch) -> tuple:
    """The tensor shapes of a batch dataclass: keys the timing-split probe
    and the first-step gate."""
    return tuple((f.name, tuple(getattr(batch, f.name).shape)) for f in dataclasses.fields(batch)
                 if getattr(batch, f.name) is not None)


def _enabled(section: Any) -> bool:
    return bool(section) and bool(dict(section).get("enabled", False))


# the robustness tier's next slice: the watchdog with the host-RAM shadow
# and the emergency snapshot, obs/, resilient_io and profile_dir
_NEXT_ROBUSTNESS = "ROADMAP queue 1, item [10]: the next robustness slice"


def check_ported(config: TRLConfig) -> None:
    """Raise NotImplementedError for every knob that would turn on a part
    of the reference the port has not reached, rather than training
    without it."""
    train, method, model = config.train, config.method, config.model
    checks = [
        (_enabled(train.guardrails) and int(dict(train.guardrails).get("consistency_every", 0) or 0) > 0,
         "train.guardrails.consistency_every (the cross-host consistency check)", "ROADMAP queue 1, item [12]"),
        (_enabled(train.watchdog), "train.watchdog (the hang doctor)", _NEXT_ROBUSTNESS),
        (_enabled(train.obs), "train.obs (the flight recorder)", _NEXT_ROBUSTNESS),
        (bool(train.resilient_io), "train.resilient_io", _NEXT_ROBUSTNESS),
        (train.profile_dir is not None, "train.profile_dir", _NEXT_ROBUSTNESS),
        (_enabled(train.serve), "train.serve", "ROADMAP queue 11"),
        (any(int(v) not in (-1, 1) for v in train.mesh.values()),
         f"train.mesh={train.mesh} (one device only)", "ROADMAP queue 12"),
        (_enabled(getattr(method, "exp", None)), "method.exp (the experience transport)", "ROADMAP queue 11"),
        (_enabled(getattr(method, "fleet", None)), "method.fleet", "ROADMAP queue 11"),
        (int(dict(getattr(method, "gen_engine", None) or {}).get("data_groups", 1)) > 1,
         "method.gen_engine.data_groups > 1 (engine lane groups)", "ROADMAP queue 12"),
        (model.model_arch_type not in ("causal", "seq2seq"),
         f"model.model_arch_type={model.model_arch_type!r}", "ROADMAP queue 7"),
    ]
    for failed, what, where in checks:
        if failed:
            raise _unported(what, where)


class TPUBaseTrainer(BaseRLTrainer):
    """Shared trainer machinery; subclasses provide the algorithm.

    `device` defaults to the current CUDA card and raises when there is
    none; pass device="cpu" to train on the CPU (the plain paths)."""

    def __init__(
        self,
        config: TRLConfig,
        reward_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        stop_sequences: Optional[List[str]] = None,
        device=None,
        **kwargs: Any,
    ):
        super().__init__(config, reward_fn, metric_fn, stop_sequences)
        check_ported(config)
        train = config.train
        self.device = resolve_device(device)
        self.seq2seq = config.model.model_arch_type == "seq2seq"
        # the guardrails (divergence watchdog and its ladder), the chaos
        # harness and the memory doctor (preflight plan, watermark sampler,
        # OOM ladder): all off by default
        self.guardrails = build_monitor(train)
        self.chaos = build_chaos(train)
        self.memdoctor = build_memdoctor(train, device=self.device)
        self._hbm_plan = None  # the preflight plan, kept for the abort report
        self._lr_scale = 1.0  # cumulative guardrail LR-cut factor
        # an OOM struck inside the optimizer step: some parameters and
        # moments are updated and others not, so only a restore recovers
        self._optimizer_step_torn = False
        # what a save_pretrained directory held: the base state dict (kept
        # until init_weights), the aux parameters and the model_type
        self._loaded_base: Optional[Dict[str, torch.Tensor]] = None
        self._loaded_aux: Optional[Dict[str, torch.Tensor]] = None
        self.model_type: Optional[str] = None
        # the HF directory the base model was loaded from (save_pretrained
        # writes the HF layout again, with its config.json)
        self._hf_config_path: Optional[str] = None
        # the normalized peft config (model.peft_config's, or its adapter
        # directory's), read once; attach_peft attaches it
        self._peft_cfg: Optional[Dict[str, Any]] = read_peft_config(config.model.peft_config)
        self.tokenizer = load_tokenizer(config.tokenizer)
        # the sampler's random stream (the reference splits a jax PRNG key
        # per call; the two streams differ, greedy decoding does not)
        self.generator = torch.Generator(device=self.device).manual_seed(train.seed)
        # the continuous-batching decode engine (method.gen_engine.*) behind
        # the same generate() seam; off by default
        self._engine_cfg = GenEngineConfig.from_dict(getattr(config.method, "gen_engine", None))
        self._engine_fns: Dict[Tuple, Callable] = {}
        self._warned_engine_fallback = False

        # gradient accumulation: the reference's (mb_size, num_mb)
        self.mb_size = train.minibatch_size or train.batch_size
        if train.batch_size % self.mb_size:
            raise ValueError("batch_size must be divisible by minibatch_size")
        self.num_mb = train.batch_size // self.mb_size
        self.grads_dtype = to_torch_dtype(train.grads_dtype) if train.grads_dtype else None

        self.setup_model()
        cfg = getattr(self.model, "cfg", None)
        if getattr(cfg, "decode_weights_quant", None) == "int8":
            check_decode_dtype(self.device, cfg.dtype)
        self.freeze_parameters()
        self.model.base.remat = resolve_remat(train.remat_policy)
        self.trainable_params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer, self.scheduler, self.schedule = build_optimizer(
            self.trainable_params, config.optimizer, config.scheduler
        )
        init_optimizer_state(self.optimizer)
        # the gradient tree in train.grads_dtype (the post-accumulate hooks
        # fill it during train_step's backwards, and only there). A hook
        # holds the trainer weakly: autograd keeps hooks where the garbage
        # collector cannot see them, so a strong one would keep the
        # trainer, its model and its optimizer alive forever
        self._grad_tree: Dict[torch.Tensor, torch.Tensor] = {}
        self._grad_sink_on = False
        if self.grads_dtype is not None:
            sink = weakref.WeakMethod(self._sink_grad)

            def hook(p: torch.Tensor) -> None:
                fn = sink()
                if fn is not None:
                    fn(p)

            for p in self.trainable_params:
                if p.dtype != self.grads_dtype:
                    p.register_post_accumulate_grad_hook(hook)

        gen_kwargs = dict(config.method.gen_kwargs)
        self.generate_sweep_kwarg = None
        for k, v in gen_kwargs.items():
            if isinstance(v, list):
                self.generate_sweep_kwarg = (k, v)
        if self.generate_sweep_kwarg:
            gen_kwargs.pop(self.generate_sweep_kwarg[0])
        eos = getattr(self.tokenizer, "eos_token_id", None)
        pad = getattr(self.tokenizer, "pad_token_id", None)
        if pad is None:  # NOT `or`: pad_token_id == 0 is legitimate
            pad = eos
        self.generate_settings = SamplerSettings.from_gen_kwargs(
            gen_kwargs, eos_token_id=eos, pad_token_id=pad
        )
        exp_kwargs = getattr(config.method, "gen_experience_kwargs", None)
        self.generate_experience_settings = (
            SamplerSettings.from_gen_kwargs(exp_kwargs, eos_token_id=eos, pad_token_id=pad)
            if exp_kwargs
            else self.generate_settings
        )

        self.tracker = Tracker(config)
        # the last cycle's staged metrics survive any shutdown order
        self.tracker.attach_pending(self._finish_rollout_stats)
        self.iter_count = 0
        self.nth_evaluation = 0
        self.best_reward = -float("inf")
        self.total_steps = train.total_steps
        self.elastic = ElasticConfig.from_dict(train.elastic)
        self.ckpt_manager = CheckpointManager(train.checkpoint_dir, keep_last_n=train.keep_last_n,
                                              integrity=self.elastic.integrity)
        self.preemption = PreemptionHandler()
        self._bad_steps = 0  # consecutive non-finite-loss steps
        # a tracker outage opens this after _TRACKER_CIRCUIT_LIMIT
        # exhausted-retry failures in a row; reset 0 = one probe a step
        self._tracker_breaker = CircuitBreaker(failure_threshold=self._TRACKER_CIRCUIT_LIMIT, reset_timeout=0.0)
        self._ckpt_commit_failures = 0  # consecutive failed commits
        # the run-derived step budget of a restored checkpoint (PPO derives
        # total_steps from the store in prepare_learning, so the config
        # value alone cannot tell a completed run from one with steps left)
        self._restored_total_steps: Optional[int] = None
        self._restored_config_total_steps: Optional[int] = None
        # a preemption truncated the rollout store (online trainers)
        self._rollout_abandoned = False
        # where the loop stands in its pass over the data: the outer epoch,
        # the inner epoch, the iter_count its dataloader was made at and
        # the batches that loader has yielded (`_resume_position` holds a
        # restored one until the loop takes it)
        self._loop_position: Dict[str, int] = {"epoch": 0, "inner": 0, "loader_iter": 0, "batches": 0}
        self._resume_position: Optional[Dict[str, int]] = None
        self._loader_iter = 0
        # every logged stats dict as (step, {key: float}), beside the
        # tracker's own log
        self.stats_history: List[Tuple[int, Dict[str, float]]] = []
        # wall seconds by phase (generate / experience / train / eval /
        # reward), each closed by a device sync; readers reset it at will
        self.phase_seconds: Dict[str, float] = defaultdict(float)
        self._active_phase: Optional[str] = None
        # train.timing_split: forward-only probe times by batch shape, and
        # the batch shapes whose step has run once
        self._measured_forward_times: Dict[tuple, float] = {}
        self._seen_step_shapes: set = set()

    # ------------------------------------------------------------------
    # model setup
    # ------------------------------------------------------------------

    def _load_native(self, arch_key: str, config_cls):
        """The config of the directory `model.model_path` when
        `save_pretrained` wrote it (None otherwise), its weights into
        `_loaded_base` / `_loaded_aux`: the dtypes from the train section
        and the runtime keys of `model_extra_configs[arch_key]` on top (the
        reference's `finalize`)."""
        mc, train = self.config.model, self.config.train
        path = mc.model_path
        if not (os.path.isdir(path) and os.path.exists(os.path.join(path, NATIVE_CONFIG))):
            return None
        base_fp = os.path.join(path, BASE_WEIGHTS)
        if not os.path.exists(base_fp):
            if os.path.isdir(os.path.join(path, "params")):
                raise ValueError(
                    f"{path} holds the JAX package's orbax params/, which cannot be read without JAX: "
                    "save the model with trlx_tpu_torch's save_pretrained"
                )
            raise FileNotFoundError(f"{path} has {NATIVE_CONFIG} but no {BASE_WEIGHTS}")
        with open(os.path.join(path, NATIVE_CONFIG)) as f:
            meta = json.load(f)
        if arch_key not in meta:
            raise ValueError(f"{path}/{NATIVE_CONFIG} holds no {arch_key!r} architecture: {sorted(meta)}")
        cfg = config_cls(dtype=train.compute_dtype, param_dtype=train.param_dtype, **meta[arch_key])
        cfg = _apply_runtime_overrides(cfg, (mc.model_extra_configs or {}).get(arch_key, {}))
        self._loaded_base = torch.load(base_fp, map_location="cpu", weights_only=True)
        aux_fp = os.path.join(path, AUX_WEIGHTS)
        if os.path.exists(aux_fp):
            self._loaded_aux = torch.load(aux_fp, map_location="cpu", weights_only=True)
        self.model_type = meta.get("model_type", "t5" if arch_key == "seq2seq" else None)
        return cfg

    def _random_init_arch(self, arch_key: str) -> Optional[Dict[str, Any]]:
        """The `model_extra_configs[arch_key]` dict of a random-init model:
        `model_path="random"` or architecture keys select it, as in the
        reference; None for any other path (an HF directory)."""
        mc, train = self.config.model, self.config.train
        extra = dict((mc.model_extra_configs or {}).get(arch_key, {}))
        if mc.model_path != "random" and not set(extra) - _RUNTIME_TRANSFORMER_KEYS:
            return None
        self.model_type = (mc.model_extra_configs or {}).get(
            "model_type", "t5" if arch_key == "seq2seq" else None)
        extra.setdefault("vocab_size", getattr(self.tokenizer, "vocab_size", 258))
        extra.setdefault("dtype", train.compute_dtype)
        extra.setdefault("param_dtype", train.param_dtype)
        return extra

    def _load_hf(self, arch_key: str):
        """The config of the local HF directory `model.model_path`, its base
        weights into `_loaded_base` (`models/hf.py`), the runtime keys of
        `model_extra_configs[arch_key]` on top. Anything else, a hub name
        included, raises: there is no network."""
        mc, train = self.config.model, self.config.train
        path = mc.model_path
        if not hf.is_hf_dir(path):
            raise _unported(
                f"loading model_path={path!r} (the port loads 'random', directories its save_pretrained "
                "wrote and local HF directories; a hub download needs the network)", "ROADMAP queue 7: HF interop",
            )
        load = hf.load_pretrained_seq2seq if arch_key == "seq2seq" else hf.load_pretrained
        cfg, self._loaded_base, self.model_type = load(
            path, dtype=train.compute_dtype, param_dtype=train.param_dtype)
        self._hf_config_path = path
        return _apply_runtime_overrides(cfg, (mc.model_extra_configs or {}).get(arch_key, {}))

    def load_base_model(self) -> TransformerConfig:
        """The architecture that `model.model_path` names: a directory that
        `save_pretrained` wrote or a local HF directory (their weights go to
        `init_weights`), or `model_extra_configs["transformer"]` with random
        weights."""
        cfg = self._load_native("transformer", TransformerConfig)
        if cfg is None:
            extra = self._random_init_arch("transformer")
            cfg = TransformerConfig(**extra) if extra is not None else self._load_hf("transformer")
        self._check_token_ids(cfg.vocab_size)
        return cfg

    def load_seq2seq_base(self) -> Seq2SeqConfig:
        """The T5 architecture, as `load_base_model`: from a saved or an HF
        directory, or `model_extra_configs["seq2seq"]` with random weights,
        the vocabulary from the tokenizer when not given, and the decoder
        start token its pad token (the HF T5 convention)."""
        cfg = self._load_native("seq2seq", Seq2SeqConfig)
        if cfg is None:
            extra = self._random_init_arch("seq2seq")
            if extra is None:
                cfg = self._load_hf("seq2seq")
            else:
                pad = getattr(self.tokenizer, "pad_token_id", None)
                if pad is not None:
                    extra.setdefault("decoder_start_token_id", int(pad))
                cfg = Seq2SeqConfig(**extra)
        self._check_token_ids(cfg.vocab_size)
        return cfg

    @torch.no_grad()
    def init_weights(self) -> None:
        """Fill `self.model`: the configured adapter attached first
        (`attach_peft`), then random weights from train.seed, or the loaded
        base weights, then fresh heads and adapter from train.seed, then the
        loaded aux parameters the model has (the reference's `init_params(key,
        base_params)` and `_loaded_aux` update; a saved adapter in the aux
        file is not one of them: the configured one is, as there), then a
        trained adapter directory's tensors when `peft_config` names one."""
        adapter = self.attach_peft()
        gen = torch.Generator().manual_seed(self.config.train.seed)
        if self._loaded_base is None:
            self.model.init_params(gen)
        else:
            self.model.base.load_state_dict(self._loaded_base)
            self._loaded_base = None
            self.model.init_heads(gen)
            own = self.model.state_dict()
            aux = {k: v for k, v in (self._loaded_aux or {}).items()
                   if k in own and k.split(".", 1)[0] not in ("base",) + ADAPTER_KEYS}
            if aux:
                self.model.load_state_dict(aux, strict=False)
        if adapter is not None:
            load_adapter_into(self.model, adapter)

    def attach_peft(self) -> Optional[Dict[str, Any]]:
        """Attach `model.peft_config`'s adapter to `self.model` (its values
        come with the model's init): an HF-peft-style dict for a fresh one,
        or the path of a trained HF-peft adapter directory
        (`adapter_config.json` with `adapter_model.safetensors` or `.bin`),
        whose tensors it returns in the reference's layout. A loaded LoRA
        adapter's targets become `self._peft_cfg`'s."""
        pc = self._peft_cfg
        if pc is None:
            return None
        adapter = None
        if isinstance(self.config.model.peft_config, str):
            _, adapter = load_peft_adapter(self.config.model.peft_config, self.model.cfg)
            if pc["peft_type"] == "LORA":
                pc = self._peft_cfg = dict(pc, targets=targets_of(adapter))
        check_peft_arch(pc, self.seq2seq)
        attach_adapter(self.model, pc)
        return adapter

    def save_pretrained(self, directory: Optional[str] = None) -> None:
        """The deploy artifact. A model loaded from an HF directory is
        written in the HF layout (`pytorch_model.bin` and that directory's
        `config.json`, `models/hf.py`), as the reference exports it; any
        other in the reference's native layout with torch files for orbax:
        `trlx_tpu_config.json` with the architecture (no dtypes, no None
        values) and the model_type, the base LM's state dict in
        `base_weights.pt`. Either way every other parameter (the value
        head) goes to `aux_weights.pt` beside it, and the tokenizer saves
        itself where it can. Default directory: `<train.checkpoint_dir>/hf_model`."""
        directory = os.path.abspath(directory or os.path.join(self.config.train.checkpoint_dir, "hf_model"))
        os.makedirs(directory, exist_ok=True)
        state = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        base = {k[len("base."):]: v for k, v in state.items() if k.startswith("base.")}
        aux = {k: v for k, v in state.items() if not k.startswith("base.")}
        aux_fp = os.path.join(directory, AUX_WEIGHTS)
        if aux:
            torch.save(aux, aux_fp)
        elif os.path.exists(aux_fp):
            os.remove(aux_fp)  # a stale head from an earlier save
        if self._hf_config_path is not None:
            hf.save_pretrained_hf(base, self.model.cfg, self.model_type, self._hf_config_path, directory)
        else:
            torch.save(base, os.path.join(directory, BASE_WEIGHTS))
            arch = {k: v for k, v in dataclasses.asdict(self.model.cfg).items()
                    if k not in ("dtype", "param_dtype") and v is not None}
            with open(os.path.join(directory, NATIVE_CONFIG), "w") as f:
                json.dump({"seq2seq" if self.seq2seq else "transformer": arch, "model_type": self.model_type}, f)
        if self._peft_cfg is not None:
            # the trained adapter also in the HF-peft layout, which
            # `model.peft_config=<directory>` loads
            save_peft_adapter(directory, adapter_tensors(self.model), self._peft_cfg, self.model_type)
        if hasattr(self.tokenizer, "save_pretrained"):
            self.tokenizer.save_pretrained(directory)

    def _check_token_ids(self, vocab_size: int) -> None:
        """An id >= vocab_size would index past the embedding: fail loudly."""
        for name in ("pad_token_id", "eos_token_id", "bos_token_id"):
            tid = getattr(self.tokenizer, name, None)
            if tid is not None and int(tid) >= vocab_size:
                raise ValueError(
                    f"tokenizer {name}={tid} is out of range for model "
                    f"vocab_size={vocab_size} (the byte tokenizer needs vocab_size>=258)"
                )

    @abstractmethod
    def setup_model(self) -> None:
        """Set self.model (and any frozen auxiliaries)."""

    def setup_policy_and_frozen_copy(self, method: str) -> None:
        """The bare policy (random weights from train.seed, or the base
        weights of a directory `save_pretrained` wrote) and its frozen
        reference `ref_params`: a full copy of those weights, made after
        they are in place, outside the model and so outside AdamW (GRPO,
        DPO); with an adapter, the base itself with the adapter off. Causal
        only."""
        if self.seq2seq:
            raise NotImplementedError(f"seq2seq {method} is not implemented (causal only)")
        self.model = CausalLM(self.load_base_model(), device=self.device)
        self.init_weights()
        if has_adapter(self.model):
            # the base with the adapter off is the reference: no copy
            self.ref_params = AdapterOffReference(self.model.base)
        else:
            self.ref_params = copy.deepcopy(self.model.base).requires_grad_(False)

    def branch_at(self) -> Optional[int]:
        """Layer index where the trainable top starts (None = all): of the
        decoder stack for a seq2seq model."""
        k = self.config.model.num_layers_unfrozen
        if k is None or k < 0:
            return None
        n = self.model.cfg.n_decoder_layer if self.seq2seq else self.model.cfg.n_layer
        return max(n - k, 0)

    def freeze_parameters(self) -> None:
        """The reference's freeze masks. Causal (`make_freeze_mask`): with
        num_layers_unfrozen k >= 0 the embeddings and the blocks below
        n_layer - k do not train; the top blocks, the final norm and the
        heads do. Seq2seq (`make_seq2seq_freeze_mask`): the encoder, the
        shared embedding, both relative-bias tables and the decoder blocks
        below n_decoder_layer - k do not train; the top decoder blocks, the
        decoder's final norm, an untied head and the value head do. With a
        peft adapter (`lora_freeze_mask`) the whole base is frozen, and the
        adapter and the heads train."""
        if self.lora_freeze_mask():
            return
        at = self.branch_at()
        if not at:
            return
        for name, p in self.model.named_parameters():
            parts = name.split(".")
            if parts[0] != "base":
                continue
            if self.seq2seq:
                frozen = (parts[1] in ("encoder", "shared") or parts[-1] == "rel_bias"
                          or (parts[1:3] == ["decoder", "blocks"] and int(parts[3]) < at))
            else:
                frozen = parts[1] == "embed" or (parts[1] == "blocks" and int(parts[2]) < at)
            if frozen:
                p.requires_grad_(False)

    def lora_freeze_mask(self) -> bool:
        """With any peft adapter: freeze the whole base, so only the
        adapter and the heads train (the reference's peft contract; the
        optimizer then holds only those). Returns whether it froze."""
        if not has_adapter(self.model):
            return False
        self.model.base.requires_grad_(False)
        return True

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def generation_logits_processor(self, **kwargs) -> Optional[Callable]:
        """The sampler's logits hook `(hidden_last, logits_last) -> logits`,
        or None. A subclass declares the kwargs it consumes (ILQL's `beta`):
        `generate` passes those through, one scalar per call, and rejects
        names that neither it nor `SamplerSettings` declares."""
        return None

    def generate(self, input_ids, attention_mask=None, settings=None, **kwargs):
        """Sample continuations of left-padded prompts with the policy.
        kwargs override SamplerSettings fields or reach the logits
        processor (`generation_logits_processor`'s parameters, each a
        scalar); HF generate kwargs the sampler does not implement are
        dropped with a warning; anything else is an error. A logits
        processor keeps the call on the static sampler (the decode engine
        has no hook for it). Returns generate()'s dict plus `prompt_mask`."""
        settings = settings or self.generate_experience_settings
        fields = {f.name for f in dataclasses.fields(SamplerSettings)}
        proc_fields = {name for name, p in inspect.signature(self.generation_logits_processor).parameters.items()
                       if p.kind not in (inspect.Parameter.VAR_KEYWORD, inspect.Parameter.VAR_POSITIONAL)}
        dropped = set(kwargs) & HF_GEN_KWARGS_UNIMPLEMENTED
        if dropped:
            logger.warning("generate(): ignoring HF gen_kwargs this sampler does not implement: %s",
                           sorted(dropped))
        unknown = set(kwargs) - fields - proc_fields - HF_GEN_KWARGS_UNIMPLEMENTED
        if unknown:
            raise TypeError(f"generate() got kwargs {sorted(unknown)} that neither SamplerSettings nor "
                            f"{type(self).__name__}.generation_logits_processor accepts")
        for k in set(kwargs) & proc_fields:
            if not (kwargs[k] is None or np.isscalar(kwargs[k])):
                raise TypeError(f"generate() kwarg {k}={kwargs[k]!r} must be a scalar: swept values are "
                                "passed one per call, not as a list")
        processor = self.generation_logits_processor(**{k: v for k, v in kwargs.items() if k in proc_fields})
        kwargs = {k: v for k, v in kwargs.items() if k in fields}
        if kwargs:
            settings = dataclasses.replace(settings, **kwargs)
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = (torch.ones_like(ids) if attention_mask is None
                else torch.as_tensor(attention_mask, device=self.device)).to(torch.int32)
        with self._phase("generate"):
            if self.seq2seq:
                out = generate_seq2seq(self.model.base, ids, mask, self.generator, settings,
                                       logits_processor=processor)
            elif self._engine_cfg.enabled and self._engine_eligible():
                out = self._engine_generate(ids, mask, settings)
            else:
                if self._engine_cfg.enabled and not self._warned_engine_fallback:
                    self._warned_engine_fallback = True
                    logger.warning("method.gen_engine.enabled, but this run is outside the engine's envelope "
                                   "(a causal LM without a logits processor): sampling on the static sampler")
                out = generate(self.model.base, ids, mask, self.generator, settings, logits_processor=processor,
                               **self._sampler_adapter_kwargs())
        return dict(out, prompt_mask=mask)

    def _sampler_adapter_kwargs(self) -> Dict[str, Any]:
        """`generate`'s soft prompt or kv prefix from the live adapter (a
        LoRA adapter needs none: the sampler merges it)."""
        prompt = getattr(self.model, "prompt", None)
        prefix = getattr(self.model, "prefix", None)
        if prompt is not None:
            return {"soft_prompt": prompt.embedding.detach()}
        if prefix is not None:
            return {"kv_prefix": {"k": prefix.k.detach(), "v": prefix.v.detach()}}
        return {}

    def generate_eval(self, input_ids, attention_mask=None, **kwargs):
        return self.generate(input_ids, attention_mask, settings=self.generate_settings, **kwargs)

    # -- the rollout decode engine (method.gen_engine.*) -----------------

    def _engine_eligible(self) -> bool:
        """The engine's envelope: a causal LM (never seq2seq, whose rollouts
        take `generate_seq2seq`) without prompt or prefix adapters and
        without a logits processor (the engine's step has no hook for it;
        ILQL's advantage shaping would be lost), and one data group by
        `check_ported`. LoRA is in: the engine samples the merged weights,
        as the static sampler does."""
        return (not self.seq2seq and not self._sampler_adapter_kwargs()
                and self.generation_logits_processor() is None)

    def _engine_spec(self, batch: int):
        """The engine spec for a call's batch width. With speculative
        decoding, a hydra reference (its top-k branch) gives the draft's
        shared trunk depth, whose KV the pool holds once."""
        spec = self._engine_cfg.resolve(batch, self.model.cfg)
        if spec.spec_decode:
            shared = hydra_shared_trunk_layers(self.model.cfg.n_layer, len(self.ref_params.blocks))
            if shared:
                spec = dataclasses.replace(spec, draft_shared_layers=shared)
        # the memory doctor's shrink_pool rungs: fewer lanes and a smaller
        # pool, the same output (the queue drains in more refill waves)
        scale = self.memdoctor.pool_scale() if self.memdoctor.enabled else 1.0
        if scale < 1.0:
            spec = dataclasses.replace(
                spec, slots=max(1, int(spec.slots * scale)),
                pool_pages=max(1, int(spec.pool_pages * scale)) if spec.pool_pages else 0)
        return spec

    def _decode_impl(self) -> str:
        """Which decode implementation produces this run's rollout tokens."""
        if not self._engine_cfg.enabled:
            return "static"
        if not self._engine_cfg.paged:
            return "engine-contiguous"
        return f"engine-paged-{self._engine_cfg.paged_attention_impl}"

    def _get_engine_fn(self, settings: SamplerSettings, shape: Tuple[int, int]):
        spec = self._engine_spec(shape[0])
        key = (settings, shape, spec)
        if key not in self._engine_fns:
            logger.info("decode engine (%s) for a %s queue: %s", self._decode_impl(), shape, spec)
            self._engine_fns[key] = make_engine_fn(self.model.base, settings, spec)
        return self._engine_fns[key], spec

    def _engine_generate(self, input_ids, attention_mask, settings):
        """One generate() chunk through the decode engine: the chunk is the
        engine's prompt queue, and finished lanes refill from it. The output
        is the static sampler's plus `gen_stats`. The draft for speculative
        decoding is the frozen reference: the hydra Branch under the
        policy's trunk, the full frozen copy, or under an adapter a decode
        copy of the base with the adapter off."""
        if self._engine_cfg.spec_decode and getattr(self, "ref_params", None) is None:
            raise ValueError("method.gen_engine.spec_decode needs a frozen reference model to draft from")
        fn, spec = self._get_engine_fn(settings, tuple(input_ids.shape))
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator, device=self.device))
        draft = None
        if spec.spec_decode:
            ref = self.ref_params
            if isinstance(ref, AdapterOffReference):
                ref = ref.decode_copy(self.model.cfg.dtype)
            draft = compose_draft_params(self.model.cfg, self.model.base, ref)
        return fn(input_ids, attention_mask, seed, draft_params=draft)

    def decode(
        self,
        prompts,
        samples,
        prompt_sizes=None,
        append_eos_token: bool = False,
    ) -> Tuple[List[str], List[str], List[str]]:
        """Token arrays -> (str_samples, str_prompts, str_outputs): each
        output cut at the first occurrence of every stop sequence and
        right-stripped, and, when asked, the EOS string appended to outputs
        that were cut or ended on EOS/pad. A seq2seq sample is the decoder
        sequence alone (its output starts at 0), and its str_sample joins
        prompt and output with the tokenizer's sep_token."""
        if prompt_sizes is None:
            prompt_sizes = [np.shape(p)[-1] for p in prompts]
        str_samples, str_prompts, str_outputs = [], [], []
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        pad_id = getattr(self.tokenizer, "pad_token_id", None)
        eos_token = getattr(self.tokenizer, "eos_token", "") or ""
        sep = (getattr(self.tokenizer, "sep_token", "") or "") if self.seq2seq else ""
        for prompt, sample, prompt_size in zip(prompts, samples, prompt_sizes):
            prompt, sample = np.asarray(prompt), np.asarray(sample)
            output_start = 0 if self.seq2seq else int(prompt_size)
            str_prompt = self.tokenizer.decode(prompt[: int(prompt_size)], skip_special_tokens=True)
            str_output = self.tokenizer.decode(sample[output_start:], skip_special_tokens=True)
            trimmed = False
            for stop in self.stop_sequences:
                stop_ix = str_output.find(stop)
                if stop_ix >= 0:
                    str_output = str_output[:stop_ix].rstrip()
                    trimmed = True
            if append_eos_token and (trimmed or sample[-1] == eos_id or sample[-1] == pad_id):
                str_output += eos_token
            str_prompts.append(str_prompt)
            str_outputs.append(str_output)
            str_samples.append(str_prompt + sep + str_output)
        return str_samples, str_prompts, str_outputs

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def evaluate(self) -> Dict[str, Any]:
        """Sample the eval prompts and score them with reward_fn/metric_fn,
        sweeping a list-valued gen_kwarg if the config has one."""
        logger.info("Evaluating model")
        with self._phase("eval"):
            return self._evaluate()

    def _evaluate(self) -> Dict[str, Any]:
        if self.generate_sweep_kwarg is not None:
            sweep_arg, sweep_values = self.generate_sweep_kwarg
        else:
            sweep_arg, sweep_values = None, [None]
        stats: Dict[str, Any] = {}
        table_rows, columns = [], []
        for sweep_value in sweep_values:
            suffix = f"@{sweep_arg}={sweep_value}" if sweep_value is not None else ""
            all_samples, all_prompts, all_sizes = [], [], []
            all_metadata: Dict[str, list] = {}
            generate_time = time.time()
            for batch in self.eval_dataloader:
                kwargs = {sweep_arg: sweep_value} if sweep_value is not None else {}
                out = self.generate_eval(batch.input_ids, batch.attention_mask, **kwargs)
                sequences = out["sequences"].cpu().numpy()
                all_samples.extend(sequences)
                all_prompts.extend(batch.input_ids.numpy())
                all_sizes.extend([batch.input_ids.shape[1]] * len(sequences))
                for k, v in (batch.metadata or {}).items():
                    all_metadata.setdefault(k, []).extend(v)
            stats["time/generate"] = time.time() - generate_time

            str_samples, str_prompts, str_outputs = self.decode(all_prompts, all_samples, all_sizes)
            columns = ["prompt", "output"]
            columns_data = [str_prompts, str_outputs]
            if self.reward_fn:
                rewards = self._call_reward_fn(
                    samples=str_samples, prompts=str_prompts, outputs=str_outputs,
                    tokenizer=self.tokenizer, **all_metadata,
                )
                rewards = [float(np.sum(r)) if np.ndim(r) else float(r) for r in rewards]
                columns.append("reward")
                columns_data.append(rewards)
                stats[f"reward/mean{suffix}"] = float(np.mean(np.asarray(rewards, np.float32)))
            if self.metric_fn:
                metric_time = time.time()
                metrics = self.metric_fn(
                    samples=str_samples, prompts=str_prompts, outputs=str_outputs, **all_metadata,
                )
                stats["time/metric"] = time.time() - metric_time
                stats.update({
                    f"metrics/{k}{suffix}": float(np.mean(np.asarray(xs, np.float32)))
                    for k, xs in metrics.items()
                })
                for metric, values in metrics.items():
                    if not isinstance(values, float):
                        columns.append(metric)
                        columns_data.append(list(values))
            if sweep_arg is not None:
                columns.insert(0, sweep_arg)
                columns_data.insert(0, [sweep_value] * len(str_prompts))
            table_rows.extend(list(zip(*columns_data)))

        title = f"Evaluation #{self.nth_evaluation}"
        for k, x in stats.items():
            if k.startswith("reward") or k.startswith("metrics"):
                title += f" {k}: {significant(x)}"
        shown = table_rows[: max(8, len(sweep_values))]
        logger.info("\n%s", logging.format_table(
            title, columns, [[significant(x) for x in row] for row in shown]
        ))
        self.nth_evaluation += 1
        return stats

    # ------------------------------------------------------------------
    # the training loop
    # ------------------------------------------------------------------

    @contextmanager
    def _phase(self, name: str):
        """Add the wall time of the block, closed by a device sync, to
        `phase_seconds[name]`; a phase inside another counts as the outer
        one (evaluation's sampling is "eval", the reward call inside the
        experience pass is "experience")."""
        if self._active_phase is not None:
            yield
            return
        self._active_phase = name
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phase_seconds[name] += time.perf_counter() - t0
            self._active_phase = None

    def _response_logprobs(self, project, hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """log p(labels) from the hidden states that predict them, through
        fp32 logits, chunked when train.logit_chunks asks."""
        chunks = self.config.train.logit_chunks
        if chunks:
            return chunked_logprobs(project, hidden, labels, chunks)
        return logprobs_of_labels(project(hidden), labels)

    def _policy_and_reference_logprobs(self, tokens: torch.Tensor, attention_mask: torch.Tensor):
        """log p(tokens[:, 1:]) under the policy and under the full frozen
        reference `setup_policy_and_frozen_copy` made, [B, T - 1] each. The
        reference runs without a graph."""
        labels = tokens[:, 1:]
        out = self.model(tokens, attention_mask, compute_logits=False)
        logprobs = self._response_logprobs(self.model.logit_project_fn(), out["hidden_states"][:, :-1], labels)
        with torch.no_grad():
            ref_out = self.ref_params(tokens, attention_mask, compute_logits=False)
            ref_logprobs = self._response_logprobs(
                logit_projection(self.ref_params), ref_out["hidden_states"][:, :-1], labels
            )
        return logprobs, ref_logprobs

    @abstractmethod
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(batch) -> (scalar loss with a graph to the trainable
        parameters, {stat key: 0-dim tensor})."""

    def _sink_grad(self, p: torch.Tensor) -> None:
        """Post-accumulate hook under train.grads_dtype: the parameter's
        fp32 gradient of this backward, rounded to grads_dtype (the
        reference's per-microbatch gradient dtype), into the gradient tree
        (summed there in fp32 across microbatches), and `.grad` freed.
        Outside train_step a backward leaves `.grad` as it is."""
        if not self._grad_sink_on:
            return
        g = p.grad.to(self.grads_dtype)
        p.grad = None
        if self.num_mb == 1:
            self._grad_tree[p] = g
        elif p in self._grad_tree:
            self._grad_tree[p].add_(g.float())
        else:
            self._grad_tree[p] = g.float()

    def _pre_accum_batch(self, batch):
        """Hook on a minibatch that is split into accumulation microbatches:
        the memory doctor's place to precompute batch-statistic terms over
        the whole minibatch. Identity here; PPO and GRPO fill it once the
        doctor has split (without it they whiten and normalise per
        microbatch, as the reference does)."""
        return batch

    def _microbatches(self, batch) -> list:
        if self.num_mb == 1:
            return [batch]
        batch = self._pre_accum_batch(batch)
        mb = self.mb_size
        return [batch.map(lambda x, i=i: x[i * mb:(i + 1) * mb]) for i in range(self.num_mb)]

    def _step_grads(self) -> Dict[torch.Tensor, torch.Tensor]:
        """{parameter: its mean gradient over the microbatches}: the
        gradient tree in grads_dtype, or the parameters' fp32 `.grad`."""
        n = self.num_mb
        if self.grads_dtype is not None:
            grads = self._grad_tree
            if n > 1:
                grads = {p: (g / n).to(self.grads_dtype) for p, g in grads.items()}
            for p in self.trainable_params:  # parameters already in grads_dtype
                if p.grad is not None:
                    grads[p] = p.grad if n == 1 else p.grad / n
            return grads
        grads = {p: p.grad for p in self.trainable_params if p.grad is not None}
        if n > 1:
            torch._foreach_div_(list(grads.values()), float(n))
        return grads

    def _optimizer_step(self, grads: Dict[torch.Tensor, torch.Tensor]) -> None:
        if getattr(self.optimizer, "takes_grad_tree", False):
            self.optimizer.step(grads=grads)
            return
        for p, g in grads.items():  # torch's own optimizers read .grad
            if g is not p.grad:
                p.grad = g.to(p.dtype)
        self.optimizer.step()

    def train_step(self, batch) -> Tuple[float, Dict[str, float]]:
        """One optimizer step on one minibatch (the reference's
        `_step_update`): the minibatch split into train.batch_size /
        train.minibatch_size microbatches, each one's loss and backward, the
        gradients and stats summed in fp32 and averaged, the optimizer step,
        then the schedule advances. With train.skip_nan_updates (the
        default) a non-finite loss or gradient leaves the parameters AND
        the optimizer state (step count included) untouched, except under
        the fused 8-bit AdamW, which applies the step with zeroed gradients;
        either way the step returns a NaN loss, which `_guard_bad_loss`
        counts."""
        # a chaos-poisoned batch without float tensors (chaos.poison_batch)
        poisoned = getattr(batch, "nan_poisoned", False)
        with self._phase("train"):
            self.optimizer.zero_grad(set_to_none=True)
            self._grad_tree = {}
            mbs = self._microbatches(batch)
            loss_sum, stat_sums = None, {}
            self._grad_sink_on = self.grads_dtype is not None
            try:
                for mb in mbs:
                    loss, stats = self.loss(mb)
                    if poisoned:
                        loss = loss + float("nan")
                    loss.backward()
                    # summed in fp32 as the reference's scan carries them
                    loss_sum = loss.detach().float() if loss_sum is None else loss_sum + loss.detach().float()
                    for k, v in stats.items():
                        v = v.detach().float()
                        stat_sums[k] = v if k not in stat_sums else stat_sums[k] + v
            finally:
                self._grad_sink_on = False
            n = len(mbs)
            loss = loss_sum / n if n > 1 else loss_sum
            stats = {k: v / n for k, v in stat_sums.items()} if n > 1 else stat_sums
            grads = self._step_grads()
            norms = torch.stack(torch._foreach_norm(list(grads.values()))).float() if grads else None
            if norms is not None and self.guardrails.enabled and self.guardrails.cfg.grad_norm_max > 0:
                # the global gradient norm the guardrails watch
                stats = dict(stats, **{"losses/grad_norm": torch.sqrt((norms * norms).sum())})
            # one device->host read for the loss, the finiteness check and
            # every stat
            names = list(stats)
            health = norms.sum() if norms is not None else loss
            host = torch.stack([loss, health.float()] + [stats[k] for k in names]).cpu().tolist()
            good = not self.config.train.skip_nan_updates or all(np.isfinite(host[:2]))
            as_zero = getattr(self.optimizer, "applies_nonfinite_as_zero", False)
            if not good and as_zero:
                # the reference's fused branch: zeroed gradients, still applied
                for g in grads.values():
                    g.zero_()
            if good or as_zero:
                self._optimizer_step_torn = True
                self._optimizer_step(grads)
                self._optimizer_step_torn = False
                self.scheduler.step()
            self._grad_tree = {}  # frees a grads_dtype tree before anything else runs
        return (host[0] if good else float("nan")), dict(zip(names, host[2:]))

    def _epoch_perms(self, n: int) -> np.ndarray:
        """Stacked minibatch index rows [n_steps, batch_size] of every inner
        epoch: the orders `create_train_dataloader` draws (seed =
        train.seed + the iter_count each epoch's loader is created at), as
        the reference's fused scan consumes them."""
        from trlx_tpu_torch.pipeline import epoch_shuffle_order

        bs = self.config.train.batch_size
        n_batches = max(n // bs, 1)
        rows = []
        it = self.iter_count
        for _ in range(self.n_inner_epochs):
            order = epoch_shuffle_order(n, self.config.train.seed + it)
            rows.append(order[: n_batches * bs].reshape(n_batches, -1))
            it += n_batches
        return np.concatenate(rows, axis=0).astype(np.int64)

    @abstractmethod
    def prepare_learning(self) -> None:
        """Build the eval dataloader, set self.n_inner_epochs/total_steps."""

    @abstractmethod
    def create_train_dataloader(self):
        """Fresh (reshuffled) training dataloader."""

    def post_backward_callback(self) -> None:
        pass

    def post_epoch_callback(self) -> None:
        pass

    def _finish_rollout_stats(self) -> None:
        """Hook: log any stats the rollout phase held back."""

    def _cycle_steps(self) -> int:
        """The steps of this cycle's inner-epochs x minibatch run, cut at
        total_steps: the size of the reference's fused block."""
        n_batches = max(len(self.store) // self.config.train.batch_size, 1)
        return min(self.n_inner_epochs * n_batches, max(self.total_steps - self.iter_count, 1))

    def pre_optimization_hook(self, will_continue: bool) -> None:
        """Hook, called before the first step of each cycle where the
        reference dispatches its fused block (under
        `train.fused_inner_loop`); `will_continue` is False when the cycle
        reaches total_steps. PPO prefetches the next rollout chunk here
        (`method.overlap_rollouts`)."""

    def _abandon_prefetch(self) -> None:
        """Hook: drop an in-flight prefetch and rewind its data cursor;
        called when learn() ends or raises."""

    def _measure_forward(self, batch) -> float:
        """Seconds of a forward-only (no-grad) `loss` pass on `batch`,
        once per batch shape (`train.timing_split`): a warm pass, then a
        timed one, the device synchronised before each clock read. Under
        gradient accumulation the probe runs the first microbatch and
        scales by their number, as in the reference."""
        key = _batch_shape_key(batch)
        if key not in self._measured_forward_times:
            probe = batch.map(lambda x: x[: self.mb_size]) if self.num_mb > 1 else batch

            def forward():
                with torch.no_grad():
                    self.loss(probe)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

            forward()
            t0 = time.perf_counter()
            forward()
            self._measured_forward_times[key] = (time.perf_counter() - t0) * self.num_mb
        return self._measured_forward_times[key]

    def _log_stats(self, stats: Dict[str, Any], step: int) -> None:
        """Keep the stats in `stats_history` and send them to the tracker."""
        scalars = {k: to_scalar(v) for k, v in stats.items()}
        self.stats_history.append((step, scalars))
        self._tracker_log(scalars, step)

    # consecutive exhausted-retry tracker failures before the circuit opens:
    # a dead tracker must not charge the full backoff to every later step
    _TRACKER_CIRCUIT_LIMIT = 3

    def _tracker_log(self, stats: Dict[str, Any], step: int) -> None:
        """tracker.log with retry and backoff; an outage degrades to a
        logged error, never a dead run. After _TRACKER_CIRCUIT_LIMIT
        exhausted-retry failures in a row the circuit opens: one un-retried
        attempt a step, failures swallowed, until one succeeds."""
        train = self.config.train
        probing = not self._tracker_breaker.is_closed
        if not self._tracker_breaker.allow():  # unreachable at reset 0
            return
        try:
            if probing:
                self.tracker.log(stats, step=step)
            else:
                retry_call(self.tracker.log, stats, step=step, retries=train.external_retries,
                           base_delay=train.retry_base_delay, description="tracker.log")
        except Exception as e:
            self._tracker_breaker.record_failure()
            if not probing:
                logger.error("tracker.log failed after retries; continuing without logging step %d: %s%s", step, e,
                             " (circuit open: further steps attempt once, no backoff)"
                             if not self._tracker_breaker.is_closed else "")
            return
        if probing:
            logger.info("tracker recovered; resuming retried logging")
        self._tracker_breaker.record_success()

    def _call_reward_fn(self, **kwargs):
        """reward_fn with train.external_retries re-tries, backoff doubling
        from train.retry_base_delay (with jitter); the final failure
        raises."""
        train = self.config.train
        with self._phase("reward"):
            return retry_call(self._chaos_wrapped_reward, retries=train.external_retries,
                              base_delay=train.retry_base_delay, description="reward_fn", **kwargs)

    def _chaos_wrapped_reward(self, **kwargs):
        """reward_fn with the chaos harness's `nan_reward` site on its result
        (consulted once a call, retries included)."""
        out = self.reward_fn(**kwargs)
        if self.chaos is not None:
            out = self.chaos.reward_fault_post(out)
        return out

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _checkpoint_tag(self) -> str:
        return f"checkpoint_{self.iter_count:0{len(str(self.total_steps))}d}"

    # consecutive failed commits tolerated before the failure propagates:
    # a storage flake must not kill a run whose state is intact (the next
    # interval retries), a store that never takes a write must not fail
    # silently forever
    _CKPT_FAILURE_LIMIT = 3

    def _save_checkpoint(self, name: str, final: bool = False) -> None:
        """Commit a checkpoint atomically as `<checkpoint_dir>/<name>`:
        `state/` + `state.json` + `topology.json` when
        train.save_optimizer, and the `hf_model/` export either way. A
        failed commit leaves only a torn tmp_ directory; it is counted and
        training goes on, except on the way out (`final`) or after
        _CKPT_FAILURE_LIMIT failures in a row, where it raises.

        Health-gated: with guardrails on, a commit is skipped while the
        monitor considers the run unhealthy, so a bad step never becomes
        the "last good checkpoint" a rollback restores."""
        if self.guardrails.enabled and not self.guardrails.commit_ok():
            logger.warning("guardrails: run unhealthy (%s) — skipping checkpoint commit %r so the last good "
                           "checkpoint stays good", self.guardrails.state_summary(), name)
            return
        logger.info("Saving checkpoint into %s", os.path.join(self.config.train.checkpoint_dir, name))

        def write(tmp_dir: str) -> None:
            if self.chaos is not None and self.chaos.consult("ckpt_fail"):
                raise ChaosFault("chaos: injected checkpoint write failure")
            if self.config.train.save_optimizer:
                self.save(tmp_dir)
            self.save_pretrained(os.path.join(tmp_dir, "hf_model"))

        try:
            final_path = self.ckpt_manager.commit(name, write)
        except Exception as e:
            self._ckpt_commit_failures += 1
            if final or self._ckpt_commit_failures >= self._CKPT_FAILURE_LIMIT:
                raise
            logger.error("checkpoint commit %r failed (%d/%d consecutive before the failure propagates): %s; "
                         "training continues, the next checkpoint interval retries", name,
                         self._ckpt_commit_failures, self._CKPT_FAILURE_LIMIT, e)
            return
        self._ckpt_commit_failures = 0
        if self.chaos is not None and self.chaos.consult("ckpt_corrupt"):
            # silent post-commit storage corruption: the integrity manifest
            # quarantines it at the next load
            self.chaos.corrupt_checkpoint(final_path)

    def _commit_final_checkpoint(self, reason: str) -> None:
        """Commit this step's checkpoint before the run exits, unless it is
        already committed (a preemption right after an interval save). The
        steps are compared as numbers: the name's zero padding follows
        total_steps, which a resume may change."""
        ckpts = self.ckpt_manager.step_checkpoints()
        if ckpts and ckpts[-1][0] == self.iter_count:
            logger.info("%s: step %d checkpoint already committed", reason, self.iter_count)
            return
        self._save_checkpoint(self._checkpoint_tag(), final=True)
        logger.info("%s: checkpoint committed at step %d", reason, self.iter_count)

    def _preemption_exit(self) -> None:
        self._commit_final_checkpoint("preemption; exiting cleanly")

    def _should_stop(self) -> bool:
        """A preemption was requested (one process: the local flag)."""
        return self.preemption.requested()

    def _maybe_save_best(self, stats: Dict[str, Any]) -> None:
        if not self.config.train.save_best:
            return
        reward = stats.get("reward/mean", stats.get("metrics/reward", -float("inf")))
        if reward > self.best_reward:
            self.best_reward = reward
            logger.info("Saving best checkpoint")
            self._save_checkpoint("best_checkpoint")

    def _extra_state(self) -> Dict[str, Any]:
        """Hook: the subclass's resumable host state for state.json."""
        return {}

    def _restore_extra_state(self, state: Dict[str, Any]) -> None:
        """Hook: restore what `_extra_state` saved."""

    def _resumable_sampler_state(self) -> torch.Tensor:
        """The sampler generator's state a resume continues from."""
        return self.generator.get_state()

    def _random_streams(self) -> Dict[str, Any]:
        """Every random stream besides the sampler's, as JSON: python's and
        numpy's global generators and torch's default generators (CPU, and
        the card's), which `set_seed` seeds."""
        py_state, np_state = random.getstate(), np.random.get_state()
        streams = {
            "python": [py_state[0], list(py_state[1]), py_state[2]],
            "numpy": [np_state[0], np_state[1].tolist(), int(np_state[2]), int(np_state[3]), float(np_state[4])],
            "torch_cpu": torch.get_rng_state().tolist(),
        }
        if self.device.type == "cuda":
            streams["torch_cuda"] = torch.cuda.get_rng_state(self.device).tolist()
        return streams

    def _restore_random_streams(self, streams: Dict[str, Any]) -> None:
        if "python" in streams:
            version, internal, gauss = streams["python"]
            random.setstate((version, tuple(internal), gauss))
        if "numpy" in streams:
            name, keys, pos, has_gauss, cached = streams["numpy"]
            np.random.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss, cached))
        if "torch_cpu" in streams:
            torch.set_rng_state(torch.tensor(streams["torch_cpu"], dtype=torch.uint8))
        if "torch_cuda" in streams and self.device.type == "cuda":
            torch.cuda.set_rng_state(torch.tensor(streams["torch_cuda"], dtype=torch.uint8), self.device)

    def _resume_state_dict(self) -> Dict[str, Any]:
        """state.json: what the run needs to continue rather than replay.
        The reference's keys (`rng_key` is the sampler's torch.Generator
        state as ints), the other random streams, the loop's position in
        its pass over the data, then the subclass's `_extra_state`. After
        a preemption truncated the rollout store, the total_steps derived
        from it understates the budget: the restored values are carried."""
        state = {
            "iter_count": self.iter_count,
            "best_reward": self.best_reward if np.isfinite(self.best_reward) else None,
            "nth_evaluation": self.nth_evaluation,
            "rng_key": self._resumable_sampler_state().tolist(),
            "lr_scale": self._lr_scale,
            "total_steps": self._restored_total_steps if self._rollout_abandoned else self.total_steps,
            "config_total_steps": (self._restored_config_total_steps if self._rollout_abandoned
                                   else self.config.train.total_steps),
            "random_streams": self._random_streams(),
            "loop_position": dict(self._loop_position),
        }
        if self.memdoctor.enabled:
            # the degradation, so a resume starts degraded instead of
            # re-OOMing at the sizes that already OOMed
            state["memory_degrade"] = self.memdoctor.degrade_state()
        if self.guardrails.enabled:
            state["guardrail_trips"] = self.guardrails.trip_tail()
        state.update(self._extra_state())
        return state

    def save(self, directory: Optional[str] = None) -> None:
        """The full training state: `state/` (the model's state dict, value
        heads and ILQL's Q and target heads included, and the optimizer's
        and the scheduler's), `state.json` (`_resume_state_dict`) and
        `topology.json`. Each file is whole or absent after a crash."""
        directory = os.path.abspath(directory or self.config.train.checkpoint_dir)
        state_dir = os.path.join(directory, "state")
        os.makedirs(state_dir, exist_ok=True)
        state_dicts = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                       "scheduler": self.scheduler.state_dict()}
        for key, sd in state_dicts.items():
            tmp = os.path.join(state_dir, STATE_FILES[key] + ".tmp")
            torch.save(sd, tmp)
            os.replace(tmp, os.path.join(state_dir, STATE_FILES[key]))
        atomic_json_write(os.path.join(directory, "state.json"), self._resume_state_dict())
        atomic_json_write(os.path.join(directory, TOPOLOGY_MANIFEST), self._topology_manifest())

    def _topology_manifest(self) -> Dict[str, Any]:
        """The run that saved: one device, the global batch, and the shape
        and dtype of every model tensor and of every parameter the
        optimizer holds, in its order (the optimizer's moments take their
        parameter's shape, and exist only after the first step)."""
        leaves = {f"model/{k}": {"shape": list(v.shape), "dtype": str(v.dtype)}
                  for k, v in self.model.state_dict().items()}
        for g, group in enumerate(self.optimizer.param_groups):
            for i, p in enumerate(group["params"]):
                leaves[f"optimizer/{g}/{i}"] = {"shape": list(p.shape), "dtype": str(p.dtype)}
        return {"format": 1, "mesh": {}, "process_count": 1, "data_group_count": 1,
                "device": self.device.type, "global_batch_size": int(self.config.train.batch_size),
                "leaves": leaves}

    def _validate_topology(self, directory: str) -> None:
        """The architecture gate of `load`, before any state changes: every
        saved tensor's shape and dtype must equal the live one's (a
        mismatch is another model or another freeze set, and raises). A
        checkpoint saved on another device type loads through
        map_location, with a warning."""
        fp = os.path.join(directory, TOPOLOGY_MANIFEST)
        if not os.path.isfile(fp):
            logger.info("checkpoint %s has no topology manifest: resuming without topology validation", directory)
            return
        with open(fp) as f:
            saved = json.load(f)
        live = self._topology_manifest()
        saved_leaves = saved.get("leaves", {})
        mismatched = []
        for key, meta in live["leaves"].items():
            got = saved_leaves.get(key)
            if got is None:
                mismatched.append(f"{key}: missing from checkpoint")
            elif list(got["shape"]) != meta["shape"] or got["dtype"] != meta["dtype"]:
                mismatched.append(f"{key}: checkpoint {got['shape']}/{got['dtype']} vs "
                                  f"live {meta['shape']}/{meta['dtype']}")
        extra = set(saved_leaves) - set(live["leaves"])
        if extra:
            mismatched.append(f"checkpoint-only leaves: {sorted(extra)[:4]}")
        if mismatched:
            raise ValueError(f"checkpoint {directory} does not match the live model ARCHITECTURE "
                             f"({len(mismatched)} leaf mismatches; first: {mismatched[0]})")
        if saved.get("device") not in (None, live["device"]):
            logger.warning("checkpoint %s was saved on %s: loading it onto %s", directory, saved["device"],
                           live["device"])
        if saved.get("global_batch_size") != live["global_batch_size"]:
            logger.warning("resume: global batch size changed (%s -> %s); iter_count-derived schedules keep "
                           "their step semantics but cover different sample counts",
                           saved.get("global_batch_size"), live["global_batch_size"])

    def load(self, directory: Optional[str] = None, quarantine_corrupt: bool = True) -> None:
        """Restore a checkpoint `save` wrote: the integrity manifest first
        (a mismatch quarantines the directory, unless quarantine_corrupt is
        off, and raises CheckpointCorruptError), then the architecture,
        then the state. The tensors are copied into the module's own
        parameters and buffers and into optimizer state on the parameters'
        device (the trainer's: the files are read through map_location)."""
        directory = os.path.abspath(directory or self.config.train.checkpoint_dir)
        if self.elastic.verify_integrity:
            verify_or_quarantine(directory, do_quarantine=quarantine_corrupt)
        self._validate_topology(directory)
        state_dir = os.path.join(directory, "state")

        def read(key, map_location):
            return torch.load(os.path.join(state_dir, STATE_FILES[key]), map_location=map_location,
                              weights_only=True)

        self.model.load_state_dict(read("model", self.device))
        # the optimizer places each moment on its parameter's device and
        # keeps AdamW's step a host tensor, as its own steps leave them
        self.optimizer.load_state_dict(read("optimizer", "cpu"))
        init_optimizer_state(self.optimizer)  # a checkpoint written before a parameter first stepped
        for st in self.optimizer.state.values():
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and v.device.type == "cpu" and k != "step":
                    st[k] = v.clone()
        self.scheduler.load_state_dict(read("scheduler", "cpu"))
        state_fp = os.path.join(directory, "state.json")
        if not os.path.exists(state_fp):
            logger.warning("checkpoint %s has no state.json: the weights and optimizer state were restored, "
                           "but iter_count and best_reward are unknown; treating it as step 0", directory)
            return
        with open(state_fp) as f:
            state = json.load(f)
        self.iter_count = state.get("iter_count", 0)
        best = state.get("best_reward")
        self.best_reward = float(best) if best is not None else -float("inf")
        self.nth_evaluation = state.get("nth_evaluation", 0)
        scale = float(state.get("lr_scale", 1.0))
        if scale != self._lr_scale:
            self._lr_scale = scale
            self._rebuild_optimizer()
        if state.get("rng_key") is not None:
            self.generator.set_state(torch.tensor(state["rng_key"], dtype=torch.uint8))
        self._restore_random_streams(state.get("random_streams") or {})
        self._restored_total_steps = state.get("total_steps")
        self._restored_config_total_steps = state.get("config_total_steps")
        if state.get("loop_position") is not None:
            self._resume_position = dict(state["loop_position"])
        self._restore_memory_degrade(state.get("memory_degrade"))
        self.guardrails.load_trip_tail(state.get("guardrail_trips"))
        self._restore_extra_state(state)

    def _restore_memory_degrade(self, saved: Optional[Dict[str, Any]]) -> None:
        """Adopt a checkpoint's memory-doctor degradation. A degraded
        checkpoint exists because the original sizes already OOMed:
        resuming it with the doctor off would re-OOM at those sizes, so
        that raises unless `train.memory.accept_undegrade` asserts they fit
        now. The merge is by max: a rollback never un-degrades."""
        if not saved or not is_degraded_record(saved):
            return
        if self.memdoctor.cfg.accept_undegrade:
            logger.warning("memory doctor: checkpoint carries degradation (%s) but train.memory.accept_undegrade "
                           "is set — resuming at the ORIGINAL sizes; you are asserting they fit now", saved)
            return
        if not self.memdoctor.enabled:
            raise ValueError(
                "this checkpoint was committed DEGRADED by the memory doctor "
                f"({saved}) — the original sizes already OOMed — but train.memory is disabled in the resuming "
                "config, which would silently un-degrade it and re-OOM. Enable train.memory.enabled to resume "
                "degraded, or set train.memory.accept_undegrade: true to assert the original sizes fit now "
                "(e.g. after moving to larger devices)")
        self.memdoctor.restore(saved)
        self._apply_degradation()
        logger.warning("memory doctor: resumed degraded — %s", self.memdoctor.describe())

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def _guard_bad_loss(self, loss: float) -> bool:
        """Returns True when the step's update was skipped (non-finite
        loss); aborts after `max_bad_steps` consecutive skipped steps."""
        if not self.config.train.skip_nan_updates or np.isfinite(loss):
            self._bad_steps = 0
            return False
        self._bad_steps += 1
        logger.warning(
            "non-finite loss %s at step %d: update skipped (%d/%d consecutive bad steps before abort)",
            loss, self.iter_count, self._bad_steps, self.config.train.max_bad_steps,
        )
        if self._bad_steps >= self.config.train.max_bad_steps:
            if self.guardrails.enabled and any(a != "log" for a in self.guardrails.cfg.ladder):
                # the ladder owns escalation: a requeue, an LR cut or a
                # rollback must not be pre-empted by a run-fatal abort (a
                # log-only ladder cannot intervene, so the abort stays)
                logger.warning("%d consecutive non-finite losses (max_bad_steps=%d); deferring the abort to the "
                               "guardrails escalation ladder", self._bad_steps, self.config.train.max_bad_steps)
                return True
            raise RuntimeError(
                f"aborting: {self._bad_steps} consecutive non-finite losses "
                f"(train.max_bad_steps={self.config.train.max_bad_steps}); the model "
                "state has diverged — restart with a lower lr / tighter clipping"
            )
        return True

    # -- guardrails (the divergence watchdog's ladder) -------------------

    def _run_guardrail_ladder(self) -> bool:
        """Consume this step's verdict and execute the ladder action.
        Returns True when the step's data source is gone (the batch was
        requeued or the state rolled back); raises on abort."""
        action = self.guardrails.pending_action()
        if action is None or action == "log":
            return False  # pending_action logged the trip
        if action == "requeue":
            return self._requeue_poisoned_batch()
        if action == "lr_cut":
            self._apply_lr_cut(self.guardrails.cfg.lr_cut_factor)
            return False
        if action == "rollback":
            return self._rollback_to_last_good()
        raise RuntimeError(
            f"guardrails abort: escalation ladder exhausted ({self.guardrails.state_summary()}); the run did not "
            "recover — relaunch resumes from the last good checkpoint")

    def _requeue_poisoned_batch(self) -> bool:
        """Hook: discard the poisoned training batch and replay its source.
        Offline trainers have no requeue-able store."""
        return False

    def _reset_data_stream(self) -> None:
        """Hook: rebuild the training data stream from position zero, so the
        load() of a rollback can fast-forward it to an earlier cursor."""

    def _apply_lr_cut(self, factor: float) -> None:
        """Multiply the whole LR schedule by `factor` (cumulative in
        `_lr_scale`, persisted in state.json); the optimizer's state
        carries over."""
        self._lr_scale *= float(factor)
        self._rebuild_optimizer()
        logger.warning("guardrails: learning rate cut by %g (cumulative scale %g)", factor, self._lr_scale)

    def _rebuild_optimizer(self) -> None:
        """The schedule rebuilt at `_lr_scale` (the peak lr and the schedule's
        floor scaled, as in the reference) on the live optimizer and
        LambdaLR: the moments and the step count stay as they are."""
        from trlx_tpu_torch.utils import get_scheduler_class

        okw, skw = dict(self.config.optimizer.kwargs), dict(self.config.scheduler.kwargs)
        lr = okw["lr"] * self._lr_scale
        for k in ("eta_min", "final_lr"):
            if k in skw:
                skw[k] = skw[k] * self._lr_scale
        factor = get_scheduler_class(self.config.scheduler.name)(lr, **skw)
        groups = self.optimizer.param_groups
        self.scheduler.base_lrs = [lr] * len(groups)
        self.scheduler.lr_lambdas = [factor] * len(groups)
        for group in groups:
            group["initial_lr"] = lr
            group["lr"] = lr * factor(self.scheduler.last_epoch)
        self.schedule = lambda step: lr * factor(step)
        init_optimizer_state(self.optimizer)

    def _rollback_to_last_good(self) -> bool:
        """Restore the newest committed resumable checkpoint in-process, as a
        relaunch would (weights, optimizer, iter_count, random streams,
        cursors, the KL controller); commits are health-gated, so it is
        the last good one. A corrupt target is quarantined by load() and
        the one before taken. Returns False when nothing is restorable."""
        path = self.ckpt_manager.latest_resumable()
        if path is None:
            logger.error("guardrails: rollback requested but no resumable checkpoint exists under %s — continuing "
                         "without rollback (the ladder escalates if the run stays unhealthy)",
                         self.config.train.checkpoint_dir)
            return False
        self._abandon_prefetch()
        self._reset_data_stream()
        while True:
            logger.warning("guardrails: auto-rollback to %s (discarding the diverged live state at step %d)",
                           path, self.iter_count)
            try:
                self.load(path)
                break
            except CheckpointCorruptError as e:
                logger.error("guardrails: rollback target was corrupt and has been quarantined (%s); falling "
                             "back to the previous committed checkpoint", e)
                path = self.ckpt_manager.latest_resumable()
                if path is None:
                    logger.error("guardrails: no earlier resumable checkpoint remains after quarantine — "
                                 "continuing without rollback; the prompt stream was rebuilt from zero")
                    return False
        # the loop continues from the restored step, not from a saved
        # position inside a pass
        self._resume_position = None
        self._bad_steps = 0
        self._optimizer_step_torn = False
        self.guardrails.notify_rollback(self.iter_count)
        return True

    # -- the memory doctor (preflight, watermarks, the OOM ladder) --------

    def _extra_plan_items(self) -> List:
        """Hook: extra memdoctor.PlanItem rows for the preflight plan (PPO
        adds its experience forward)."""
        return []

    def _memory_preflight(self) -> None:
        """Admission control at the top of learn(), before any rollout: the
        per-step plan's peak phase against the budget. `enforce` raises
        MemoryPlanError with the itemized report, `warn` logs it."""
        md = self.memdoctor
        if not md.enabled or md.cfg.preflight == "off":
            return
        plan = estimate_plan(self)
        self._hbm_plan = plan
        logger.info("memory doctor preflight:\n%s", plan.report())
        if plan.over_budget():
            msg = ("memory doctor: preflight REJECTED this config — the HBM plan exceeds the admitted budget:\n"
                   + plan.report())
            if md.cfg.preflight == "enforce":
                raise MemoryPlanError(msg, plan)
            logger.warning(msg)

    def _check_memory_watermark(self) -> None:
        """Consume a latched watermark trip (and run the `hbm_creep` chaos
        site) once a step: creeping residency raises the `memory` guardrail
        signal, or a loud log with the guardrails off."""
        if not self.memdoctor.enabled:
            return
        sampler = self.memdoctor.sampler
        if self.chaos is not None and self.chaos.consult("hbm_creep"):
            # sampled inline, so the trip lands on this step
            sampler.inject_creep()
            for _ in range(self.memdoctor.cfg.watermark_window):
                sampler.sample()
        detail = sampler.consume_trip()
        if detail:
            if self.guardrails.enabled:
                self.guardrails.trip(MEMORY_SIGNAL, detail)
            else:
                logger.warning("memory doctor: %s — logged only (enable train.guardrails for the escalation "
                               "ladder)", detail)

    def _oom_retry_budget(self) -> int:
        """Attempts of an OOM envelope: every rung the ladder could walk, plus
        slack (the ladder itself ends in abort)."""
        cfg = self.memdoctor.cfg
        return cfg.max_splits + cfg.max_pool_shrinks + 4

    def _oom_caps(self) -> Dict[str, bool]:
        """What the ladder can do in this run: shrinking the pool needs the
        decode engine, a split an even microbatch that still divides the
        batch, remat only escalates past the configured policy."""
        half = self.mb_size // 2
        return {
            "shrink_pool": self._engine_cfg.enabled,
            "split_microbatch": (self.mb_size % 2 == 0 and half >= 1
                                 and self.config.train.batch_size % (self.num_mb * 2) == 0),
            "remat": remat_strength(self.memdoctor.cfg.remat_escalation)
            > remat_strength(self.config.train.remat_policy),
            "rollback": True,
        }

    def _state_buffers_valid(self) -> bool:
        """False after an OOM inside the optimizer step (kernel 9's fused
        step included): some parameters moved and others not, so retrying
        would apply the step twice to some of them."""
        return not self._optimizer_step_torn

    def _handle_oom(self, event: OOMEvent) -> str:
        """One rung of the degradation ladder for a classified OOM. Returns
        "retry" when the failed dispatch should be re-attempted degraded,
        "skip" when a rollback consumed the step; raises the itemized
        MemoryAbortError when the ladder is exhausted. Called after the
        envelope's `except` block has ended."""
        md = self.memdoctor
        self.guardrails.trip(MEMORY_SIGNAL, event.summary())
        action = md.decide(event, self._oom_caps())
        if action in ("shrink_pool", "split_microbatch", "remat") and not self._state_buffers_valid():
            logger.warning("memory doctor: %s, but it struck inside the optimizer step — escalating to rollback",
                           event.summary())
            action = "rollback"
        md.note(event, action)
        if action == "abort":
            raise MemoryAbortError(md.abort_report(event, self._hbm_plan))
        if action == "shrink_pool":
            # the next generate() resolves the spec at the new pool scale
            self._engine_fns.clear()
            return "retry"
        if action == "split_microbatch":
            self._apply_accum_factor()
            return "retry"
        if action == "remat":
            self._escalate_remat(md.cfg.remat_escalation)
            return "retry"
        if self._rollback_to_last_good():
            return "skip"
        raise MemoryAbortError(md.abort_report(event, self._hbm_plan))

    def _release_failed_step(self) -> None:
        """After an OOM: the failed step's partial sums (fp32 `.grad`, the
        grads_dtype tree) zeroed and the allocator's cached blocks returned,
        so the retry fails on size, if at all, not on fragmentation."""
        self._grad_sink_on = False
        self._grad_tree = {}
        self.optimizer.zero_grad(set_to_none=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _train_step_under_doctor(self, batch):
        """`train_step` in the memory doctor's envelope (the `oom_fused_block`
        chaos site consults once an attempt): an OOM walks the ladder and
        retries the same batch degraded. Returns (loss, stats), or None when
        a rollback consumed the step."""
        if not self.memdoctor.enabled:
            return self.train_step(batch)
        for _attempt in range(self._oom_retry_budget()):
            event = None
            try:
                if self.chaos is not None:
                    self.chaos.oom("oom_fused_block")
                return self.train_step(batch)
            except Exception as e:
                if not is_oom(e):
                    raise
                event = classify_oom(e, "train_step")
            # the exception and its traceback are gone here
            self._release_failed_step()
            if self._handle_oom(event) == "skip":
                return None
        raise RuntimeError("memory doctor: train step still out of memory after exhausting the degradation "
                           "retry budget")

    def _generate_rollout(self, input_ids, attention_mask):
        """generate() in the memory doctor's envelope (the `oom_prefill` chaos
        site consults once an attempt): an OOM walks the shrink_pool rung
        and the same chunk retries with a smaller pool."""
        if not self.memdoctor.enabled:
            return self.generate(input_ids, attention_mask)
        for _attempt in range(self._oom_retry_budget()):
            event = None
            try:
                if self.chaos is not None:
                    self.chaos.oom("oom_prefill")
                return self.generate(input_ids, attention_mask)
            except Exception as e:
                if not is_oom(e):
                    raise
                event = classify_oom(e, "rollout_prefill")
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self._handle_oom(event)  # a rollout OOM retries or aborts
        raise RuntimeError("memory doctor: rollout generation still out of memory after exhausting the "
                           "pool-shrink budget")

    def _dispatch_experience(self, fn, *args):
        """A teacher-forced scoring forward in the doctor's classification
        envelope: no rung relieves it at run time (train.logit_chunks is the
        config-time fix), so an OOM there ends in the itemized abort."""
        if not self.memdoctor.enabled:
            return fn(*args)
        event = None
        try:
            return fn(*args)
        except Exception as e:
            if not is_oom(e):
                raise
            event = classify_oom(e, "experience")
        self._handle_oom(event)
        raise AssertionError("unreachable: an experience OOM always aborts")

    def _apply_accum_factor(self) -> None:
        """Re-derive num_mb / mb_size from the configured microbatch and the
        doctor's accumulation factor (the same global batch, summed in
        fp32)."""
        base_mb = self.config.train.minibatch_size or self.config.train.batch_size
        mb = max(base_mb // self.memdoctor.accum_factor, 1)
        if self.config.train.batch_size % mb:
            logger.error("memory doctor: accumulation factor %d does not divide cleanly (batch %d, base mb %d) — "
                         "keeping the current microbatch", self.memdoctor.accum_factor,
                         self.config.train.batch_size, base_mb)
            return
        if base_mb < self.config.train.batch_size:
            logger.warning("memory doctor: config already used microbatch accumulation (minibatch_size=%d) — the "
                           "split switches batch-statistic loss terms (PPO advantage whitening) from "
                           "per-microbatch to full-batch scope", base_mb)
        self.mb_size = mb
        self.num_mb = self.config.train.batch_size // mb
        logger.warning("memory doctor: train microbatch split to %d rows (x%d gradient accumulation; global batch "
                       "unchanged)", mb, self.num_mb)

    def _escalate_remat(self, policy: str) -> None:
        """Switch the run to a stronger activation-checkpoint policy (never
        weakens one the user set)."""
        self.config.train.remat_policy = policy
        self.memdoctor.note_remat(policy)
        self.model.base.remat = resolve_remat(policy)
        self._drop_traced_fns()
        logger.warning("memory doctor: activation checkpointing escalated to %r — backward recomputes instead "
                       "of keeping residuals", policy)

    def _drop_traced_fns(self) -> None:
        """Drop the cached functions built for the old configuration (the
        decode engine's)."""
        self._engine_fns.clear()

    def _apply_degradation(self) -> None:
        """Re-apply a restored degradation to the live trainer: pool scale,
        accumulation factor, remat policy."""
        md = self.memdoctor
        if md.pool_shrinks:
            self._engine_fns.clear()
        if md.accum_factor > 1:
            self._apply_accum_factor()
        if md.remat_policy is not None and (
                remat_strength(md.remat_policy) > remat_strength(self.config.train.remat_policy)):
            self.config.train.remat_policy = md.remat_policy
            self.model.base.remat = resolve_remat(md.remat_policy)
            self._drop_traced_fns()

    def learn(self):
        """The training loop (the reference's per-step `_learn`), with the
        preemption handler and the memory doctor's watermark sampler
        installed for its duration. The memory doctor's admission control
        runs first, before any rollout: an over-budget config dies here
        with the itemized plan."""
        self._memory_preflight()
        self.preemption.install()
        self.memdoctor.sampler.start()
        try:
            return self._learn()
        finally:
            self.memdoctor.sampler.stop()
            self.preemption.uninstall()
            # a rollout's held-back stats reach the log even when learn()
            # ends right after it
            self._finish_rollout_stats()
            # a prefetched chunk never trains once learn() exits: its
            # prompts go back to the stream's cursor
            self._abandon_prefetch()
            # last among the metric consumers: close() drains what the
            # flushes above missed, then closes the backends
            self.tracker.close()

    def _restored_run_done(self) -> bool:
        """The restored step already covers the budget: the config's, or
        the run-derived one of state.json (store-limited PPO) when the
        config's total is unchanged."""
        train = self.config.train
        restored_done = (self._restored_total_steps is not None
                         and self.iter_count >= self._restored_total_steps
                         and train.total_steps == self._restored_config_total_steps)
        return self.iter_count > 0 and (self.iter_count >= train.total_steps or restored_done)

    def _take_resume_position(self) -> Optional[Dict[str, int]]:
        """The restored loop position the loop continues from (once)."""
        pos, self._resume_position = self._resume_position, None
        return pos

    def _learn(self):
        logger.info("Starting training")
        # a relaunch of a completed run bails before prepare_learning, which
        # for an online trainer would pay a whole rollout for nothing
        if self._restored_run_done():
            logger.info("restored iter_count %d already covers the step budget (total_steps=%d%s); nothing to train",
                        self.iter_count, self.config.train.total_steps,
                        "" if self._restored_total_steps is None else f", run-derived={self._restored_total_steps}")
            return {}
        self.prepare_learning()
        if self._should_stop():
            # preempted during prepare_learning (an online trainer's first
            # rollout): checkpoint and exit before the initial evaluation
            self._preemption_exit()
            return {}
        if self.iter_count > 0:
            # a resumed run continues from the restored step; the initial
            # evaluation is skipped, so tracker steps stay monotonic
            logger.info("Resuming training at step %d/%d (best_reward=%s)", self.iter_count, self.total_steps,
                        significant(self.best_reward))
            results: Dict[str, Any] = {}
            if self.iter_count >= self.total_steps:
                return results
        else:
            results = self.evaluate()
            self._log_stats(results, step=self.iter_count)
        train = self.config.train
        pos = self._take_resume_position() or {}
        clock = Clock()
        for epoch in range(pos.get("epoch", 0), train.epochs):
            # a preemption during the last rollout or evaluation
            if self._should_stop():
                self._preemption_exit()
                return results
            if train.fused_inner_loop:
                self.pre_optimization_hook(self.iter_count + self._cycle_steps() < self.total_steps)
            for inner in range(pos.get("inner", 0), self.n_inner_epochs):
                # a restored position mid-pass: the same loader, its
                # consumed batches skipped
                self._loader_iter = pos.get("loader_iter", self.iter_count)
                skip = pos.get("batches", 0)
                pos = {}
                self._loop_position = {"epoch": epoch, "inner": inner, "loader_iter": self._loader_iter,
                                       "batches": skip}
                loader = self.create_train_dataloader()
                # an interval checkpoint on the pass's last step waits for
                # its callback, so that a resume continues after it
                end_save = False
                guard_break = False  # a ladder action consumed this pass's data
                for b, batch in enumerate(loader):
                    if b < skip:
                        continue
                    if self._should_stop():
                        self._preemption_exit()
                        return results
                    if self.chaos is not None and self.chaos.consult("nan_loss"):
                        batch = poison_batch(batch)
                    clock.tick()
                    out = self._train_step_under_doctor(batch)
                    if out is None:
                        # an OOM rollback consumed the step's data source
                        guard_break = True
                        break
                    loss, stats = out
                    step_time = clock.tick()
                    self._loop_position["batches"] = b + 1
                    if self.chaos is not None and self.chaos.consult("sigterm"):
                        # a preemption landing right after a step
                        import signal

                        os.kill(os.getpid(), signal.SIGTERM)
                    bad = self._guard_bad_loss(loss)
                    self._check_memory_watermark()
                    if self.guardrails.enabled:
                        # the per-step loop: one step is one watchdog cycle
                        self.guardrails.observe_train(step=self.iter_count, loss=loss,
                                                      grad_norm=stats.get("losses/grad_norm"))
                        if self._run_guardrail_ladder():
                            # requeue or rollback: this loader's source is
                            # gone, the cycle starts over
                            guard_break = True
                            break
                    if bad:
                        # the skipped step does not advance the step index
                        # and logs nothing
                        continue
                    stats["time/step"] = step_time
                    # the first step of a batch shape is skipped, as in the
                    # reference (there it holds the step's compile)
                    shape_key = _batch_shape_key(batch)
                    if train.timing_split and shape_key in self._seen_step_shapes:
                        with self._phase("train"):
                            fwd_time = self._measure_forward(batch)
                        stats["time/forward"] = fwd_time
                        stats["time/backward"] = max(step_time - fwd_time, 0.0)
                    self._seen_step_shapes.add(shape_key)
                    stats["learning_rate_group_0"] = float(self.schedule(self.iter_count))
                    self.iter_count += 1
                    done = self.iter_count >= self.total_steps
                    save = self.iter_count % train.checkpoint_interval == 0
                    if done:
                        # the run's last checkpoint, before its evaluation
                        # as in the reference
                        self._save_checkpoint(self._checkpoint_tag())
                    if self.iter_count % train.eval_interval == 0 or done:
                        results = self.evaluate()
                        stats.update(results)
                        self._maybe_save_best(stats)
                    logger.info("[step %d/%d] %s", self.iter_count, self.total_steps, " | ".join(
                        f"{k}: {v:.2f}" for k, v in stats.items() if k.startswith("losses/")
                    ))
                    # held-back rollout stats carry an earlier step index:
                    # flush them first so logged steps stay monotonic
                    self._finish_rollout_stats()
                    self._log_stats(stats, step=self.iter_count)
                    if done:
                        return results
                    # an interval checkpoint holds the step as a whole:
                    # its evaluation and its logs included
                    if save and b + 1 < len(loader):
                        self._save_checkpoint(self._checkpoint_tag())
                    end_save = save and b + 1 == len(loader)
                if guard_break:
                    break
                self.post_backward_callback()
                self._loop_position = {"epoch": epoch, "inner": inner + 1, "loader_iter": self.iter_count,
                                       "batches": 0}
                if end_save:
                    self._save_checkpoint(self._checkpoint_tag())
            self.post_epoch_callback()
            self._loop_position = {"epoch": epoch + 1, "inner": 0, "loader_iter": self.iter_count, "batches": 0}
        # the epochs can run out below total_steps (NaN-skipped steps, small
        # datasets): commit what exists
        if self.iter_count > 0:
            self._commit_final_checkpoint("epoch budget exhausted")
        return results


class TPUOnlineTrainer(TPUBaseTrainer):
    """The online experience core: the prompt stream and its cursor, the
    chunked rollout loop with one-chunk lookahead generation, the
    cross-cycle prefetch (`method.overlap_rollouts`), the reward running
    moments, the rollout accounting and the rollout export
    (`train.rollout_logging_dir`). Subclasses provide
    `_score_and_assemble`, `loss` and `setup_model`."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.store = self._make_store()
        self.running_moments = running_moments_init(self.device)
        self.ref_mean = getattr(config.method, "ref_mean", None)
        self.ref_std = getattr(config.method, "ref_std", None)
        # prompt chunks pulled off the (deterministically shuffled) stream,
        # and the restored cursor the stream is fast-forwarded to
        self._prompt_batches_consumed = 0
        self._resume_prompt_cursor = 0
        # rollout stats staged until the next flush: (stats, step, meta)
        self._deferred_rollout = DeferredStats()
        # the next cycle's first chunk (batch, generate() output, seconds),
        # generated before the current cycle's steps, and the cursor to
        # rewind to if it never trains
        self._prefetched_gen: Optional[Tuple[PromptBatch, Dict[str, Any], float]] = None
        self._prefetch_cursor_start: Optional[int] = None
        self._prefetch_sampler_state: Optional[torch.Tensor] = None
        self.log_rollouts = config.train.rollout_logging_dir is not None
        if self.log_rollouts:
            self.setup_rollout_logging(config)
        # phase_seconds as each rollout cycle began: a cycle's split is the
        # difference of two marks (the last one against phase_seconds)
        self.phase_marks: List[Dict[str, float]] = []

    def _make_store(self):
        from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage

        return PPORolloutStorage(pad_token_id=self.generate_settings.pad_token_id)

    def _inner_epochs(self) -> int:
        raise NotImplementedError

    @abstractmethod
    def _score_and_assemble(self, batch: PromptBatch, gen_out, stats: Dict[str, Any],
                            iter_count: int, clock: Clock):
        """Decode + reward_fn + the algorithm's experience assembly for one
        generated chunk (stats mutated into `stats`). Returns
        `(rollout_batch, rows)`."""

    def _rollout_stage_meta(self):
        """Metadata held with each cycle's rollout stats."""
        return None

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0) -> None:
        """Collect `num_rollouts` rollouts into the store. Generation of
        chunk i+1 is issued before chunk i is scored, as in the reference
        (there it overlaps the host's scoring with the device's sampling;
        the port's eager sampler runs it in order). The first chunk is the
        prefetched one when `pre_optimization_hook` generated it: it is
        scored now, with the weights the last cycle's steps left."""
        logger.info("Collecting rollouts")
        self.phase_marks.append(dict(self.phase_seconds))
        self._rollout_abandoned = False
        # an abandoned (preempted) rollout never trains, so the cursor
        # rewinds to here; a cycle that starts from a prefetched chunk
        # rewinds to before that chunk's pull
        prompt_cursor_start = (self._prefetch_cursor_start if self._prefetched_gen is not None
                               else self._prompt_batches_consumed)
        # the sampler's stream rewinds with it, so that the replayed chunks
        # draw what the abandoned ones drew
        sampler_start = self._resumable_sampler_state()
        # a guardrail `requeue` rewinds to here: the whole cycle's prompts
        # replay when its rollout batch turns out poisoned
        self._cycle_cursor_start = prompt_cursor_start
        self._finish_rollout_stats()
        clock = Clock()
        n_collected = 0
        accumulated: List[Dict[str, Any]] = []

        if self._prefetched_gen is not None:
            next_batch, next_gen, next_gen_time = self._prefetched_gen
            self._prefetched_gen = None
            self._prefetch_cursor_start = None
            self._prefetch_sampler_state = None
        else:
            next_batch, next_gen, next_gen_time = self._pull_and_generate()
        chunk_rows = len(next_batch.input_ids)
        while n_collected < num_rollouts:
            # a preemption must not wait out the remaining chunks: abandon
            # the rollout, and learn() checkpoints and exits
            if self._should_stop():
                logger.warning("preemption during rollout collection: abandoning after %d/%d rollouts",
                               n_collected, num_rollouts)
                self._rollout_abandoned = True
                self._prompt_batches_consumed = prompt_cursor_start
                self.generator.set_state(sampler_start)
                break
            stats: Dict[str, Any] = {"time/rollout_generate": next_gen_time}
            batch, gen_out = next_batch, next_gen
            if n_collected + chunk_rows < num_rollouts:
                next_batch, next_gen, next_gen_time = self._pull_and_generate()
            with self._phase("experience"):
                rollout_batch, rows = self._score_and_assemble(batch, gen_out, stats, iter_count, clock)
            accumulated.append(stats)
            self.push_to_store(rollout_batch)
            n_collected += rows
            logger.info("[rollout %d / %d]", n_collected, num_rollouts)
        if not accumulated:  # abandoned before its first chunk
            return
        agg = {k: sum(xs[k] for xs in accumulated) / len(accumulated) for k in accumulated[-1]}
        # one stacked device->host copy for every tensor stat, read at the
        # next flush
        self._deferred_rollout.stage(agg, step=iter_count, meta=self._rollout_stage_meta())

    def _pull_and_generate(self) -> Tuple[PromptBatch, Dict[str, Any], float]:
        """The next prompt chunk, its generate() output and the seconds it
        took."""
        batch = self._next_prompt_batch()
        t0 = time.time()
        gen = self._generate_rollout(batch.input_ids, batch.attention_mask)
        return batch, gen, time.time() - t0

    # -- the cross-cycle prefetch (method.overlap_rollouts) ---------------

    def pre_optimization_hook(self, will_continue: bool) -> None:
        """Generate the next cycle's first chunk now, with the weights the
        cycle's steps are about to change. `make_experience` scores it
        with the updated weights, so its stored logprobs belong to the
        policy that trains on them; its samples are one update stale,
        which the clipped surrogate absorbs. Nothing is prefetched for a
        cycle that will not run (`will_continue` False)."""
        if not getattr(self.config.method, "overlap_rollouts", False) or not will_continue:
            return
        if self._prefetched_gen is not None or not hasattr(self, "prompt_iterator"):
            return
        cursor0, sampler0 = self._prompt_batches_consumed, self.generator.get_state()
        self._prefetched_gen = self._pull_and_generate()
        self._prefetch_cursor_start = cursor0
        self._prefetch_sampler_state = sampler0

    def _abandon_prefetch(self) -> None:
        """Drop an in-flight prefetched chunk and rewind the prompt cursor
        and the sampler's stream to before it: its rollouts never train."""
        if self._prefetched_gen is None:
            return
        self._prefetched_gen = None
        self._prompt_batches_consumed = self._prefetch_cursor_start
        self.generator.set_state(self._prefetch_sampler_state)
        self._prefetch_cursor_start = None
        self._prefetch_sampler_state = None

    def _resumable_sampler_state(self) -> torch.Tensor:
        """Before an in-flight prefetch, as the saved cursor is."""
        if self._prefetched_gen is not None:
            return self._prefetch_sampler_state
        return self.generator.get_state()

    # -- the rollout export (train.rollout_logging_dir) -------------------

    def setup_rollout_logging(self, config) -> None:
        """A fresh `run-<uuid>` directory under train.rollout_logging_dir
        (which must exist) with the run's config.json; each cycle's store
        is exported there before it is cleared."""
        import uuid

        if not os.path.isdir(config.train.rollout_logging_dir):
            raise FileNotFoundError(f"train.rollout_logging_dir={config.train.rollout_logging_dir!r} is not a directory")
        self.run_id = f"run-{uuid.uuid4()}"
        self.rollout_logging_dir = os.path.join(config.train.rollout_logging_dir, self.run_id)
        os.mkdir(self.rollout_logging_dir)
        with open(os.path.join(self.rollout_logging_dir, "config.json"), "w") as f:
            f.write(json.dumps(config.to_dict(), indent=2))

    def _retokenize_outputs(self, str_outputs, batch: PromptBatch, sequences: torch.Tensor, N: int):
        """The response tokens rebuilt from the stop-trimmed outputs (the
        reference's host-scored path): each output re-tokenised without
        specials and cut to N, right-padded; the sequences re-joined from
        the prompt (seq2seq: the decoder start token). Returns (response_ids,
        response_mask, sequences) on the device."""
        outputs = self.tokenizer(str_outputs, add_special_tokens=False)["input_ids"]
        response_ids = np.full((len(outputs), N), self.generate_settings.pad_token_id, np.int64)
        response_mask = np.zeros((len(outputs), N), np.int32)
        for i, o in enumerate(outputs):
            o = o[:N]
            response_ids[i, : len(o)] = o
            response_mask[i, : len(o)] = 1
        ids = torch.as_tensor(response_ids, dtype=sequences.dtype, device=self.device)
        head = sequences[:, :1] if self.seq2seq else torch.as_tensor(batch.input_ids, device=self.device)
        return ids, torch.as_tensor(response_mask, device=self.device), torch.cat([head.to(ids.dtype), ids], dim=1)

    def _update_reward_moments(self, scores: np.ndarray, scores_mask: np.ndarray, stats):
        """Fold one chunk's scores into the running reward moments and pick
        the reward-scaling divisor (`method.scale_reward`). A chunk with
        non-finite score sums leaves the moments as they were. Returns the
        divisor as a tensor."""
        method = self.config.method
        score_sums = torch.as_tensor((scores * scores_mask).sum(axis=1), device=self.device)
        if self.ref_mean is None:
            self.ref_mean = float(score_sums.mean())
            self.ref_std = float(score_sums.std(unbiased=False))
        new, scores_mean, scores_std = running_moments_update(self.running_moments, score_sums)
        keep = torch.isfinite(score_sums).all()
        self.running_moments = type(new)(**{
            f.name: torch.where(keep, getattr(new, f.name), getattr(self.running_moments, f.name))
            for f in dataclasses.fields(new)
        })
        stats["rollout_scores/mean"] = scores_mean
        stats["rollout_scores/std"] = scores_std
        stats["rollout_scores/running_mean"] = self.running_moments.mean
        stats["rollout_scores/running_std"] = self.running_moments.std
        scale_reward = getattr(method, "scale_reward", None)
        if scale_reward == "running":
            return self.running_moments.std
        one = torch.ones((), dtype=torch.float32, device=self.device)
        if scale_reward == "ref":
            return one * max(self.ref_std, 1e-8)
        return one

    @staticmethod
    def _rollout_accounting_stats(response_ids: np.ndarray, response_mask: np.ndarray,
                                  eos_id: int, stats, gen_stats: Optional[Dict[str, Any]] = None) -> None:
        """Mask-weighted real tokens, batch occupancy and the truncation
        rate (rows that ran to max_new_tokens without an EOS), plus the
        decode engine's per-chunk ledger when `gen_stats` rode along."""
        if gen_stats is not None:
            g = {k: float(v) for k, v in gen_stats.items()}
            stats["rollout/engine_occupancy"] = g.get("occupancy", 0.0)
            stats["rollout/engine_refills"] = g.get("refills", 0.0)
            stats["rollout/engine_decode_steps"] = g.get("decode_steps", 0.0)
            # prompt pages that held only left padding, released at refill
            stats["rollout/engine_reclaimed_pages"] = g.get("reclaimed_pages", 0.0)
            if "drafted" in g:
                stats["rollout/spec_accept_rate"] = g["accepted"] / max(g["drafted"], 1.0)
            if g.get("oom_truncated") or g.get("unserved"):
                logger.warning(
                    "gen_engine: page pool exhausted (%d lanes truncated, %d prompts unserved): "
                    "raise method.gen_engine.pool_pages",
                    int(g.get("oom_truncated", 0)), int(g.get("unserved", 0)),
                )
        n_resp = response_mask.shape[1]
        real = float(response_mask.sum())
        stats["rollout/real_tokens"] = real
        stats["rollout/token_occupancy"] = real / max(response_mask.shape[0] * n_resp, 1)
        full_rows = response_mask.sum(axis=1) >= n_resp
        hit_eos = (
            ((response_ids == eos_id) & (response_mask > 0)).any(axis=1)
            if eos_id >= 0 else np.zeros(len(full_rows), bool)
        )
        stats["rollout/truncation_rate"] = float((full_rows & ~hit_eos).mean()) if len(full_rows) else 0.0

    def _observe_rollout(self, stats: Dict[str, Any], kl_target: Optional[float] = None) -> None:
        """Feed the guardrails a flushed rollout's health signals."""
        if not self.guardrails.enabled:
            return
        kl = stats.get("policy/sqrt_kl")
        self.guardrails.observe_rollout(
            kl=None if kl is None else float(kl) ** 2,
            kl_target=kl_target,
            reward_mean=stats.get("rollout_scores/mean"),
            running_mean=stats.get("rollout_scores/running_mean"),
            running_std=stats.get("rollout_scores/running_std"),
            truncation_rate=stats.get("rollout/truncation_rate"),
        )

    def _finish_rollout_stats(self) -> None:
        """Log the deferred rollout stats, feeding the guardrails their
        signals. Idempotent."""
        for stats, step, meta in self._deferred_rollout.flush():
            if meta is not None:
                stats["kl_coef"] = float(meta)
            self._observe_rollout(stats)
            self._log_stats(stats, step=step)

    # -- the prompt stream ----------------------------------------------

    def add_prompt_pipeline(self, pipeline) -> None:
        self._prompt_pipeline = pipeline
        self._build_prompt_iterator()
        self._fast_forward_prompts()

    def _prompt_chunk_rows(self) -> int:
        return self.config.method.chunk_size

    def _build_prompt_iterator(self) -> None:
        """(Re)create the prompt stream from position zero: one shuffle
        stream over the whole prompt list (seeded by train.seed), chunked
        at chunk_size with the ragged tail dropped; a prompt list smaller
        than one chunk gives one kept-ragged chunk."""
        pipeline = self._prompt_pipeline
        chunk, drop_last = self._prompt_chunk_rows(), True
        if len(pipeline) < chunk:
            chunk, drop_last = len(pipeline), False
        loader = pipeline.create_loader(
            chunk, shuffle=True, drop_last=drop_last, seed=self.config.train.seed
        )
        self.prompt_iterator = infinite_loader(loader)
        self._prompt_batches_consumed = 0

    def _next_prompt_batch(self) -> PromptBatch:
        batch = next(self.prompt_iterator)
        self._prompt_batches_consumed += 1
        return batch

    def _rewind_prompt_stream(self, cursor: int) -> None:
        """Rebuild the stream so the next pull is chunk `cursor` (host-side
        pulls only)."""
        self._build_prompt_iterator()
        for _ in range(cursor):
            next(self.prompt_iterator)
        self._prompt_batches_consumed = cursor

    def _reset_data_stream(self) -> None:
        """The rollback's hook: the stream back to zero; the load() that
        follows fast-forwards it to the checkpoint's cursor."""
        if getattr(self, "_prompt_pipeline", None) is None:
            return
        self._resume_prompt_cursor = 0
        self._build_prompt_iterator()

    def _requeue_poisoned_batch(self) -> bool:
        """The guardrails' `requeue` rung: drop the poisoned rollout store and
        rewind the prompt stream to the cycle's start, so the same prompts
        are collected again with the current policy."""
        start = getattr(self, "_cycle_cursor_start", None)
        if len(self.store) == 0 or start is None:
            return False
        self._abandon_prefetch()
        self.store.clear_history()
        self._rewind_prompt_stream(start)
        logger.warning("guardrails: discarded the poisoned rollout batch; prompt stream rewound to chunk %d for "
                       "replay", start)
        return True

    def _fast_forward_prompts(self) -> None:
        """Resume: advance the prompt stream to the restored cursor by
        replaying its host-side pulls (collation only), which reproduces
        the loader's shuffle stream as the killed run would have gone on."""
        skip = self._resume_prompt_cursor - self._prompt_batches_consumed
        if skip <= 0 or not hasattr(self, "prompt_iterator"):
            return
        logger.info("resume: fast-forwarding the prompt stream by %d chunks", skip)
        for _ in range(skip):
            next(self.prompt_iterator)
        self._prompt_batches_consumed += skip

    # -- resumable state -------------------------------------------------

    def _extra_state(self) -> Dict[str, Any]:
        """The reward normalisation and the prompt cursor. An in-flight
        prefetched chunk has not trained: the cursor from before its pull
        is saved, so a resume replays those prompts."""
        rm = self.running_moments
        return {
            "ref_mean": None if self.ref_mean is None else float(self.ref_mean),
            "ref_std": None if self.ref_std is None else float(self.ref_std),
            "running_moments": {"mean": float(rm.mean), "var": float(rm.var), "std": float(rm.std),
                                "count": float(rm.count)},
            "prompt_batches_consumed": (self._prefetch_cursor_start if self._prefetched_gen is not None
                                        else self._prompt_batches_consumed),
            "prompt_stream": "global-chunks-v1",
        }

    def _restore_extra_state(self, state: Dict[str, Any]) -> None:
        self.ref_mean = state.get("ref_mean", self.ref_mean)
        self.ref_std = state.get("ref_std", self.ref_std)
        rm = state.get("running_moments")
        if rm:
            self.running_moments = type(self.running_moments)(**{
                k: torch.tensor(rm[k], dtype=torch.float32, device=self.device) for k in ("mean", "var", "std", "count")
            })
        self._resume_prompt_cursor = state.get("prompt_batches_consumed", 0)
        self._fast_forward_prompts()

    def _take_resume_position(self) -> Optional[Dict[str, int]]:
        """A resumed online run collects a fresh store in prepare_learning.
        Saved after its cycle's last pass, that rollout is the one the
        cycle's end was about to collect, and the loop goes on with the
        next cycle; saved inside a pass, the old store is gone, and the
        cycle starts over on the new one (as in the reference)."""
        pos = super()._take_resume_position()
        if pos is None:
            return None
        return {"epoch": pos["epoch"] + int(pos["inner"] >= self.n_inner_epochs)}

    # -- loop hooks ------------------------------------------------------

    def prepare_learning(self) -> None:
        self.eval_dataloader = self.eval_pipeline.create_loader(max(self.config.method.chunk_size, 1))
        self.make_experience(self.config.method.num_rollouts, self.iter_count)
        self.n_inner_epochs = self._inner_epochs()
        n_batches = len(self.store) // self.config.train.batch_size
        self.total_steps = min(
            self.config.train.epochs * self.n_inner_epochs * max(n_batches, 1),
            self.config.train.total_steps,
        )

    def create_train_dataloader(self):
        return self.store.create_loader(
            self.config.train.batch_size, shuffle=True, drop_last=True,
            seed=self.config.train.seed + self._loader_iter,
        )

    def post_backward_callback(self) -> None:
        self._finish_rollout_stats()

    def post_epoch_callback(self) -> None:
        if self.log_rollouts:
            self.store.export_history(self.rollout_logging_dir, self.tokenizer)
        self.store.clear_history()
        self.make_experience(self.config.method.num_rollouts, self.iter_count)
