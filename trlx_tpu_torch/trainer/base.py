"""Trainer base: model/optimizer setup, generation, evaluation and the
per-step `learn()` loop (port of the parts of trlx_tpu.trainer.base that
online PPO runs: `TPUBaseTrainer` and the `TPUOnlineTrainer` experience
core).

What the port does differently, and why:
- Freezing. The reference masks the optimizer's UPDATES of frozen leaves
  (`make_freeze_mask`: the embeddings and the blocks below `branch_at`).
  Here frozen parameters get `requires_grad_(False)` and stay out of the
  optimizer; the parameters come out identical. Frozen leaves then have no
  optimizer moments, which matters only for checkpoint parity (ROADMAP
  queue 4).
- The inner loop. `train.fused_inner_loop` (default on) makes the
  reference scan all `ppo_epochs` x minibatch steps in one device call
  over `_epoch_perms`, which are by construction the per-epoch loader
  orders (`pipeline.epoch_shuffle_order` with seed train.seed +
  iter_count). The port accepts the knob and always runs the per-step
  loop over those same permutations, with the per-step loop's cadence of
  evaluation, stats and callbacks; a CUDA graph of the step is its
  analogue of the fused scan.
- One process, one device: no mesh, no row padding for sharding, no
  deferred device->host stats copies (the rollout stats are held until
  the next train-step flush, as in the reference, but read eagerly).
- The decode engine (`method.gen_engine`) takes rollout and evaluation
  sampling as in the reference, with one lane group; its speculative
  draft is the frozen reference (the hydra Branch under the policy's
  trunk, or the full copy).
- The robustness, transport, fleet, serving and checkpoint tiers are not
  ported yet; each knob that would turn one on raises NotImplementedError
  naming its ROADMAP queue, and `_save_checkpoint` only warns.
"""

from __future__ import annotations

import dataclasses
import time
from abc import abstractmethod
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data import PromptBatch
from trlx_tpu_torch.data.configs import TRLConfig
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
from trlx_tpu_torch.models.seq2seq import Seq2SeqConfig, generate_seq2seq
from trlx_tpu_torch.models.transformer import TransformerConfig
from trlx_tpu_torch.ops.common import running_moments_init, running_moments_update
from trlx_tpu_torch.trainer import BaseRLTrainer
from trlx_tpu_torch.utils import (
    Clock,
    build_optimizer,
    infinite_loader,
    logging,
    significant,
    to_scalar,
)
from trlx_tpu_torch.utils.device import resolve_device
from trlx_tpu_torch.utils.tokenizers import load_tokenizer

logger = logging.get_logger(__name__)

# TransformerConfig knobs that tune execution, not architecture: their
# presence alone does not select the random-init path
_RUNTIME_TRANSFORMER_KEYS = frozenset({
    "attention_impl", "kv_cache_quant", "decode_weights_quant",
    "pp_microbatches", "pp_schedule",
})

LEFT_OUT = "ROADMAP queue 1, item 2: left out of slice 2"


def _unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({where})")


def _enabled(section: Any) -> bool:
    return bool(section) and bool(dict(section).get("enabled", False))


def check_ported(config: TRLConfig) -> None:
    """Raise NotImplementedError for every knob that would turn on a part
    of the reference the port has not reached, rather than training
    without it."""
    train, method, model = config.train, config.method, config.model
    mb = train.minibatch_size
    checks = [
        (mb is not None and mb != train.batch_size,
         f"train.minibatch_size={mb} (gradient accumulation)", "ROADMAP queue 9"),
        (train.grads_dtype is not None, f"train.grads_dtype={train.grads_dtype!r}", "ROADMAP queue 9"),
        (train.remat_policy != "none", f"train.remat_policy={train.remat_policy!r}", "ROADMAP queue 9"),
        (_enabled(train.memory), "train.memory (the memory doctor)", "ROADMAP queue 9"),
        (_enabled(train.guardrails), "train.guardrails", "ROADMAP queue 10"),
        (_enabled(train.watchdog), "train.watchdog", "ROADMAP queue 10"),
        (_enabled(train.obs), "train.obs (the flight recorder)", "ROADMAP queue 10"),
        (train.chaos is not None, "train.chaos", "ROADMAP queue 10"),
        (bool(train.resilient_io), "train.resilient_io", "ROADMAP queue 10"),
        (train.profile_dir is not None, "train.profile_dir", "ROADMAP queue 10"),
        (train.timing_split, "train.timing_split", LEFT_OUT),
        (bool(train.elastic), "train.elastic", "ROADMAP queue 4"),
        (train.rollout_logging_dir is not None, "train.rollout_logging_dir (rollout export)", LEFT_OUT),
        (_enabled(train.serve), "train.serve", "ROADMAP queue 11"),
        (any(int(v) not in (-1, 1) for v in train.mesh.values()),
         f"train.mesh={train.mesh} (one device only)", "ROADMAP queue 12"),
        (getattr(method, "overlap_rollouts", False), "method.overlap_rollouts", LEFT_OUT),
        (_enabled(getattr(method, "exp", None)), "method.exp (the experience transport)", "ROADMAP queue 11"),
        (_enabled(getattr(method, "fleet", None)), "method.fleet", "ROADMAP queue 11"),
        (int(dict(getattr(method, "gen_engine", None) or {}).get("data_groups", 1)) > 1,
         "method.gen_engine.data_groups > 1 (engine lane groups)", "ROADMAP queue 12"),
        (bool(getattr(method, "num_value_layers_unfrozen", 0)), "method.num_value_layers_unfrozen (the value branch)", LEFT_OUT),
        (model.model_arch_type not in ("causal", "seq2seq"),
         f"model.model_arch_type={model.model_arch_type!r}", "ROADMAP queue 7"),
        (model.peft_config is not None, "model.peft_config", "ROADMAP queue 7"),
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
        if self.stop_sequences:
            raise _unported("stop_sequences", LEFT_OUT)
        train = config.train
        self.device = resolve_device(device)
        self.seq2seq = config.model.model_arch_type == "seq2seq"
        self.tokenizer = load_tokenizer(config.tokenizer)
        if train.tracker is not None:
            logger.warning(
                "train.tracker=%r is not ported yet (ROADMAP queue 4): stats are "
                "logged and kept in trainer.stats_history", train.tracker,
            )
        # the sampler's random stream (the reference splits a jax PRNG key
        # per call; the two streams differ, greedy decoding does not)
        self.generator = torch.Generator(device=self.device).manual_seed(train.seed)
        # the continuous-batching decode engine (method.gen_engine.*) behind
        # the same generate() seam; off by default
        self._engine_cfg = GenEngineConfig.from_dict(getattr(config.method, "gen_engine", None))
        self._engine_fns: Dict[Tuple, Callable] = {}

        self.setup_model()
        self.freeze_parameters()
        self.trainable_params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer, self.scheduler, self.schedule = build_optimizer(
            self.trainable_params, config.optimizer, config.scheduler
        )

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

        self.iter_count = 0
        self.nth_evaluation = 0
        self.best_reward = -float("inf")
        self.total_steps = train.total_steps
        self._bad_steps = 0  # consecutive non-finite-loss steps
        self._warned_checkpoint = False
        # every logged stats dict as (step, {key: float}): the port's
        # in-memory tracker until the tracker backends are ported
        self.stats_history: List[Tuple[int, Dict[str, float]]] = []
        # wall seconds by phase (generate / experience / train / eval /
        # reward), each closed by a device sync; readers reset it at will
        self.phase_seconds: Dict[str, float] = defaultdict(float)
        self._active_phase: Optional[str] = None

    # ------------------------------------------------------------------
    # model setup
    # ------------------------------------------------------------------

    def load_base_model(self) -> TransformerConfig:
        """The architecture from `model.model_extra_configs["transformer"]`
        with random weights: `model_path="random"` or architecture keys
        select it, as in the reference. Loading a checkpoint (HF or the
        reference's native one) is ROADMAP queues 7 and 4."""
        mc, train = self.config.model, self.config.train
        extra = dict((mc.model_extra_configs or {}).get("transformer", {}))
        if mc.model_path != "random" and not set(extra) - _RUNTIME_TRANSFORMER_KEYS:
            raise _unported(f"loading model_path={mc.model_path!r}", "ROADMAP queues 7 and 4")
        extra.setdefault("vocab_size", getattr(self.tokenizer, "vocab_size", 258))
        extra.setdefault("dtype", train.compute_dtype)
        extra.setdefault("param_dtype", train.param_dtype)
        cfg = TransformerConfig(**extra)
        self._check_token_ids(cfg.vocab_size)
        return cfg

    def load_seq2seq_base(self) -> Seq2SeqConfig:
        """The T5 architecture from `model.model_extra_configs["seq2seq"]`
        with random weights, as the reference's random-init branch of
        `_load_seq2seq_base`: the vocabulary from the tokenizer when not
        given, and the decoder start token its pad token (the HF T5
        convention). Loading a checkpoint is ROADMAP queues 7 and 4."""
        mc, train = self.config.model, self.config.train
        extra = dict((mc.model_extra_configs or {}).get("seq2seq", {}))
        if mc.model_path != "random" and not set(extra) - _RUNTIME_TRANSFORMER_KEYS:
            raise _unported(f"loading model_path={mc.model_path!r}", "ROADMAP queues 7 and 4")
        extra.setdefault("vocab_size", getattr(self.tokenizer, "vocab_size", 258))
        pad = getattr(self.tokenizer, "pad_token_id", None)
        if pad is not None:
            extra.setdefault("decoder_start_token_id", int(pad))
        extra.setdefault("dtype", train.compute_dtype)
        extra.setdefault("param_dtype", train.param_dtype)
        cfg = Seq2SeqConfig(**extra)
        self._check_token_ids(cfg.vocab_size)
        return cfg

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
        decoder's final norm, an untied head and the value head do."""
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

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def generate(self, input_ids, attention_mask=None, settings=None, **kwargs):
        """Sample continuations of left-padded prompts with the policy.
        kwargs override SamplerSettings fields; HF generate kwargs the
        sampler does not implement are dropped with a warning; anything
        else is an error. Returns generate()'s dict plus `prompt_mask`."""
        settings = settings or self.generate_experience_settings
        fields = {f.name for f in dataclasses.fields(SamplerSettings)}
        dropped = set(kwargs) & HF_GEN_KWARGS_UNIMPLEMENTED
        if dropped:
            logger.warning("generate(): ignoring HF gen_kwargs this sampler does not implement: %s",
                           sorted(dropped))
        unknown = set(kwargs) - fields - HF_GEN_KWARGS_UNIMPLEMENTED
        if unknown:
            raise TypeError(f"generate() got kwargs {sorted(unknown)} that SamplerSettings does not accept")
        kwargs = {k: v for k, v in kwargs.items() if k in fields}
        if kwargs:
            settings = dataclasses.replace(settings, **kwargs)
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = (torch.ones_like(ids) if attention_mask is None
                else torch.as_tensor(attention_mask, device=self.device)).to(torch.int32)
        with self._phase("generate"):
            if self.seq2seq:
                out = generate_seq2seq(self.model.base, ids, mask, self.generator, settings)
            elif self._engine_cfg.enabled and self._engine_eligible():
                out = self._engine_generate(ids, mask, settings)
            else:
                out = generate(self.model.base, ids, mask, self.generator, settings)
        return dict(out, prompt_mask=mask)

    def generate_eval(self, input_ids, attention_mask=None, **kwargs):
        return self.generate(input_ids, attention_mask, settings=self.generate_settings, **kwargs)

    # -- the rollout decode engine (method.gen_engine.*) -----------------

    def _engine_eligible(self) -> bool:
        """The engine's envelope: a causal LM (never seq2seq, whose rollouts
        take `generate_seq2seq`) without prompt or prefix adapters (the port
        has no logits processor on this path, and one data group by
        `check_ported`)."""
        return not self.seq2seq and self.config.model.peft_config is None

    def _engine_spec(self, batch: int):
        """The engine spec for a call's batch width. With speculative
        decoding, a hydra reference (its top-k branch) gives the draft's
        shared trunk depth, whose KV the pool holds once."""
        spec = self._engine_cfg.resolve(batch, self.model.cfg)
        if spec.spec_decode:
            shared = hydra_shared_trunk_layers(self.model.cfg.n_layer, len(self.ref_params.blocks))
            if shared:
                spec = dataclasses.replace(spec, draft_shared_layers=shared)
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
        policy's trunk, or the full frozen copy."""
        if self._engine_cfg.spec_decode and getattr(self, "ref_params", None) is None:
            raise ValueError("method.gen_engine.spec_decode needs a frozen reference model to draft from")
        fn, spec = self._get_engine_fn(settings, tuple(input_ids.shape))
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator, device=self.device))
        draft = None
        if spec.spec_decode:
            draft = compose_draft_params(self.model.cfg, self.model.base, self.ref_params)
        return fn(input_ids, attention_mask, seed, draft_params=draft)

    def decode(
        self,
        prompts,
        samples,
        prompt_sizes=None,
        append_eos_token: bool = False,
    ) -> Tuple[List[str], List[str], List[str]]:
        """Token arrays -> (str_samples, str_prompts, str_outputs), with
        the EOS string appended to outputs that ended on EOS/pad when
        asked (stop-sequence trimming is left out of this slice). A seq2seq
        sample is the decoder sequence alone (its output starts at 0), and
        its str_sample joins prompt and output with the tokenizer's
        sep_token."""
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
            if append_eos_token and (sample[-1] == eos_id or sample[-1] == pad_id):
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

    @abstractmethod
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(batch) -> (scalar loss with a graph to the trainable
        parameters, {stat key: 0-dim tensor})."""

    def train_step(self, batch) -> Tuple[float, Dict[str, float]]:
        """One optimizer step on one minibatch (the reference's
        `_step_update` for num_mb == 1): loss, backward, AdamW step, then
        the schedule advances. With train.skip_nan_updates (the default) a
        non-finite loss or gradient leaves the parameters AND the optimizer
        state (step count included) untouched and the step returns a NaN
        loss, which `_guard_bad_loss` counts."""
        with self._phase("train"):
            self.optimizer.zero_grad(set_to_none=True)
            loss, stats = self.loss(batch)
            loss.backward()
            grads = [p.grad for p in self.trainable_params if p.grad is not None]
            # one device->host read for the loss, the finiteness check and
            # every stat
            names = list(stats)
            health = torch.stack(torch._foreach_norm(grads)).sum() if grads else loss.detach()
            host = torch.stack(
                [loss.detach().float(), health.float()] + [stats[k].detach().float() for k in names]
            ).cpu().tolist()
            good = not self.config.train.skip_nan_updates or all(np.isfinite(host[:2]))
            if good:
                self.optimizer.step()
                self.scheduler.step()
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

    def _log_stats(self, stats: Dict[str, Any], step: int) -> None:
        self.stats_history.append((step, {k: to_scalar(v) for k, v in stats.items()}))

    def _call_reward_fn(self, **kwargs):
        """reward_fn with train.external_retries re-tries and doubling
        backoff from train.retry_base_delay; the final failure raises."""
        train = self.config.train
        for attempt in range(train.external_retries + 1):
            try:
                with self._phase("reward"):
                    return self.reward_fn(**kwargs)
            except Exception as e:
                if attempt >= train.external_retries:
                    logger.error("reward_fn failed after %d attempts: %s", attempt + 1, e)
                    raise
                delay = min(train.retry_base_delay * 2 ** attempt, 8.0)
                logger.warning("reward_fn failed (%s); retrying in %.2fs", e, delay)
                time.sleep(delay)

    def _checkpoint_tag(self) -> str:
        return f"checkpoint_{self.iter_count:0{len(str(self.total_steps))}d}"

    def _save_checkpoint(self, name: str, final: bool = False) -> None:
        """Checkpointing is ROADMAP queue 4: nothing is written; the first
        call says so once."""
        if not self._warned_checkpoint:
            logger.warning(
                "checkpoint %r not written: checkpointing is not ported yet "
                "(ROADMAP queue 4); no checkpoint of this run will be written", name,
            )
            self._warned_checkpoint = True

    def _maybe_save_best(self, stats: Dict[str, Any]) -> None:
        if not self.config.train.save_best:
            return
        reward = stats.get("reward/mean", stats.get("metrics/reward", -float("inf")))
        if reward > self.best_reward:
            self.best_reward = reward
            self._save_checkpoint("best_checkpoint")

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
            raise RuntimeError(
                f"aborting: {self._bad_steps} consecutive non-finite losses "
                f"(train.max_bad_steps={self.config.train.max_bad_steps}); the model "
                "state has diverged — restart with a lower lr / tighter clipping"
            )
        return True

    def learn(self):
        """The training loop (the reference's per-step `_learn`)."""
        try:
            return self._learn()
        finally:
            # a rollout's held-back stats reach the log even when learn()
            # ends right after it
            self._finish_rollout_stats()

    def _learn(self):
        logger.info("Starting training")
        self.prepare_learning()
        results = self.evaluate()
        self._log_stats(results, step=self.iter_count)
        train = self.config.train
        clock = Clock()
        for _ in range(train.epochs):
            for _ in range(self.n_inner_epochs):
                for batch in self.create_train_dataloader():
                    clock.tick()
                    loss, stats = self.train_step(batch)
                    step_time = clock.tick()
                    if self._guard_bad_loss(loss):
                        # the skipped step does not advance the step index
                        # and logs nothing
                        continue
                    stats["time/step"] = step_time
                    stats["learning_rate_group_0"] = float(self.schedule(self.iter_count))
                    self.iter_count += 1
                    if self.iter_count % train.checkpoint_interval == 0 or self.iter_count >= self.total_steps:
                        self._save_checkpoint(self._checkpoint_tag())
                    if self.iter_count % train.eval_interval == 0 or self.iter_count >= self.total_steps:
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
                    if self.iter_count >= self.total_steps:
                        return results
                self.post_backward_callback()
            self.post_epoch_callback()
        if self.iter_count > 0:
            self._save_checkpoint(self._checkpoint_tag(), final=True)
        return results


class TPUOnlineTrainer(TPUBaseTrainer):
    """The online experience core: the prompt stream and its cursor, the
    chunked rollout loop with one-chunk lookahead generation, the reward
    running moments and the rollout accounting. Subclasses provide
    `_score_and_assemble`, `loss` and `setup_model`."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.store = self._make_store()
        self.running_moments = running_moments_init(self.device)
        self.ref_mean = getattr(config.method, "ref_mean", None)
        self.ref_std = getattr(config.method, "ref_std", None)
        # prompt chunks pulled off the (deterministically shuffled) stream
        self._prompt_batches_consumed = 0
        # rollout stats held until the next flush: (stats, step, meta)
        self._pending_rollout: List[Tuple[Dict[str, Any], int, Any]] = []
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
        the port's eager sampler runs it in order)."""
        logger.info("Collecting rollouts")
        self.phase_marks.append(dict(self.phase_seconds))
        self._finish_rollout_stats()
        clock = Clock()
        n_collected = 0
        accumulated: List[Dict[str, Any]] = []

        def pull():
            batch = self._next_prompt_batch()
            t0 = time.time()
            gen = self.generate(batch.input_ids, batch.attention_mask)
            return batch, gen, time.time() - t0

        next_batch, next_gen, next_gen_time = pull()
        chunk_rows = len(next_batch.input_ids)
        while n_collected < num_rollouts:
            stats: Dict[str, Any] = {"time/rollout_generate": next_gen_time}
            batch, gen_out = next_batch, next_gen
            if n_collected + chunk_rows < num_rollouts:
                next_batch, next_gen, next_gen_time = pull()
            with self._phase("experience"):
                rollout_batch, rows = self._score_and_assemble(batch, gen_out, stats, iter_count, clock)
            accumulated.append(stats)
            self.push_to_store(rollout_batch)
            n_collected += rows
            logger.info("[rollout %d / %d]", n_collected, num_rollouts)
        agg = {k: sum(xs[k] for xs in accumulated) / len(accumulated) for k in accumulated[-1]}
        self._pending_rollout.append((agg, iter_count, self._rollout_stage_meta()))

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

    def _finish_rollout_stats(self) -> None:
        for stats, step, meta in self._pending_rollout:
            if meta is not None:
                stats["kl_coef"] = float(meta)
            self._log_stats(stats, step=step)
        self._pending_rollout = []

    # -- the prompt stream ----------------------------------------------

    def add_prompt_pipeline(self, pipeline) -> None:
        self._prompt_pipeline = pipeline
        self._build_prompt_iterator()

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
            seed=self.config.train.seed + self.iter_count,
        )

    def post_backward_callback(self) -> None:
        self._finish_rollout_stats()

    def post_epoch_callback(self) -> None:
        self.store.clear_history()
        self.make_experience(self.config.method.num_rollouts, self.iter_count)
