"""Memory doctor: HBM admission control, OOM classification and a
degrade-don't-die recovery ladder (port of trlx_tpu.utils.memdoctor).

  preflight admission control
      ``estimate_plan`` builds a per-phase plan of the device bytes of a
      live trainer: the state rows exact, from the tensors the trainer
      holds or will hold (fp32 masters, the optimizer's moments or kernel
      9's int8 moments and scales, the frozen reference, the gradient tree
      in train.grads_dtype, the sampler's decode copy with its int8
      weights); the activation, logit and page-pool rows analytic, with
      the reference's formulas. ``MemoryDoctor``'s trainer hook checks the
      peak phase against the budget and rejects an over-budget config
      with the itemized report before any rollout.
  runtime watermarks
      ``WatermarkSampler``: a daemon thread reads the caching allocator's
      counters (``torch.cuda.memory_stats``: host-side, no device sync) on
      a fixed cadence. "In use" is what tensors hold
      (``allocated_bytes.all.current``), not what the allocator reserved.
      Crossing ``high_watermark`` for ``watermark_window`` samples raises
      the ``memory`` guardrail signal.
  OOM recovery ladder
      ``classify_oom`` turns an allocation failure (``torch.cuda.
      OutOfMemoryError``, whose "Tried to allocate" text carries the
      size, a kernel wrapper's "out of memory" launch status, the chaos
      harness's simulated one) into an ``OOMEvent``; ``MemoryDoctor.
      decide`` picks the cheapest relief for that phase: shrink_pool,
      split_microbatch, remat, rollback, abort. Degradation is monotonic
      and persistent: ``degrade_state()`` rides state.json and
      ``restore()`` merges by max.

The budget is ``train.memory.hbm_bytes`` when set, else the card's total
memory times the process's memory fraction
(``torch.cuda.set_per_process_memory_fraction``; 1 when unset); a CPU
trainer has none, and the preflight only reports. The reference's
``cross_check`` reads XLA's compiled memory analysis; here it compares the
plan with the measured peak of a real step.

Host-side and device-agnostic: the sampler's stats and phase hooks are
injectable, so the CPU tests run it on a fake allocator.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

# the ladder rungs, cheapest relief first; a config may use an ordered subset
LADDER_ACTIONS = ("shrink_pool", "split_microbatch", "remat", "rollback", "abort")

# remat policies by increasing memory savings (ops/remat.py's table): the
# `remat` rung only escalates, never weakens a policy the user set
REMAT_STRENGTH = (
    "none", "dots_saveable", "save_attn", "dots_with_no_batch_dims",
    "offload", "full", "save_nothing",
)


def remat_strength(policy) -> int:
    """Ordinal memory-savings rank of a remat policy (unknown/False -> 0)."""
    name = policy if isinstance(policy, str) else ("full" if policy else "none")
    try:
        return REMAT_STRENGTH.index(name)
    except ValueError:
        return 0


def is_degraded_record(d) -> bool:
    """Is a persisted ``memory_degrade`` record (state.json) degraded?"""
    if not isinstance(d, dict):
        return False
    return bool(d.get("pool_shrinks") or int(d.get("accum_factor", 1) or 1) > 1 or d.get("remat_policy"))


class MemoryAbortError(RuntimeError):
    """The doctor's itemized abort (ladder exhausted). Its message quotes
    the classified OOM; `is_oom` excludes it by type, so an outer envelope
    never re-handles it."""


class MemoryPlanError(RuntimeError):
    """Preflight admission control rejected the config: the plan exceeds
    the budget. Carries the itemized plan."""

    def __init__(self, message: str, plan: "HBMPlan"):
        super().__init__(message)
        self.plan = plan


@dataclass
class MemoryConfig:
    """Parsed ``train.memory`` section (plain dict in YAML). The fields and
    defaults are the reference's; see trlx_tpu.utils.memdoctor.MemoryConfig."""

    enabled: bool = False
    preflight: str = "enforce"
    hbm_bytes: int = 0
    headroom: float = 0.9
    high_watermark: float = 0.92
    watermark_window: int = 3
    sample_interval_s: float = 0.5
    ladder: Tuple[str, ...] = LADDER_ACTIONS
    pool_shrink_factor: float = 0.5
    max_pool_shrinks: int = 2
    max_splits: int = 3
    remat_escalation: str = "dots_with_no_batch_dims"
    accept_undegrade: bool = False

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "MemoryConfig":
        d = dict(d or {})
        unknown = set(d) - set(cls.__dataclass_fields__)
        if unknown:
            raise ValueError(f"train.memory: unknown keys {sorted(unknown)} "
                             f"(known: {sorted(cls.__dataclass_fields__)})")
        if "ladder" in d:
            ladder = tuple(d["ladder"])
            bad = [a for a in ladder if a not in LADDER_ACTIONS]
            if bad:
                raise ValueError(f"train.memory.ladder: unknown actions {bad} (choose from {list(LADDER_ACTIONS)})")
            order = [LADDER_ACTIONS.index(a) for a in ladder]
            if order != sorted(order) or len(set(ladder)) != len(ladder):
                raise ValueError(f"train.memory.ladder must be an ordered subset of {list(LADDER_ACTIONS)}, "
                                 f"got {list(ladder)}")
            d["ladder"] = ladder
        cfg = cls(**d)
        if cfg.preflight not in ("off", "warn", "enforce"):
            raise ValueError(f"train.memory.preflight must be off/warn/enforce, got {cfg.preflight!r}")
        if not 0.0 < cfg.pool_shrink_factor < 1.0:
            raise ValueError(f"train.memory.pool_shrink_factor must be in (0, 1), got {cfg.pool_shrink_factor}")
        if cfg.remat_escalation not in REMAT_STRENGTH:
            raise ValueError(f"train.memory.remat_escalation={cfg.remat_escalation!r} not in {list(REMAT_STRENGTH)}")
        return cfg


# ---------------------------------------------------------------------------
# OOM classification
# ---------------------------------------------------------------------------

# the reference's markers (XLA's RESOURCE_EXHAUSTED and the chaos harness's
# message), and the CUDA allocation failures: the caching allocator's "CUDA
# out of memory", cudaErrorMemoryAllocation's "out of memory" status as a
# kernel wrapper reports it. A launch error or an illegal address never
# carries "out of memory".
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "OOM when allocating", "out of memory")

_BYTES_RE = re.compile(r"(?:allocat\w*)\s+(?:of\s+)?([\d.]+)\s*(GiB|MiB|KiB|G|M|K|bytes|B)\b", re.IGNORECASE)
_UNIT = {"gib": 1 << 30, "g": 1 << 30, "mib": 1 << 20, "m": 1 << 20, "kib": 1 << 10, "k": 1 << 10,
         "bytes": 1, "b": 1}

_COMPILE_MARKERS = ("while compiling", "during compilation", "buffer assignment", "constant allocation",
                    "compile time", "while lowering")


def is_oom(exc: BaseException) -> bool:
    """Is this exception an allocation failure on the device?"""
    if isinstance(exc, MemoryAbortError):
        return False
    oom_type = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _OOM_MARKERS)


@dataclass
class OOMEvent:
    """One classified allocation failure: the phase that dispatched the
    work, compile or runtime (always runtime on the card: there is no
    compile step), and the bytes the failed allocation wanted. Strings and
    ints only: the exception and its traceback (which hold the failed
    step's activations) are not kept."""

    phase: str
    stage: str
    bytes_requested: int
    detail: str

    def summary(self) -> str:
        want = f"{self.bytes_requested / (1 << 30):.2f} GiB" if self.bytes_requested else "unknown bytes"
        return f"RESOURCE_EXHAUSTED in phase {self.phase!r} ({self.stage}, wanted {want})"


def classify_oom(exc: BaseException, phase: str) -> OOMEvent:
    """Exception + the phase that dispatched it -> OOMEvent, the size parsed
    from the allocator's message ("Tried to allocate 20.00 MiB")."""
    text = str(exc)
    m = _BYTES_RE.search(text)
    nbytes = int(float(m.group(1)) * _UNIT[m.group(2).lower()]) if m else 0
    stage = "compile" if any(k in text.lower() for k in _COMPILE_MARKERS) else "runtime"
    return OOMEvent(phase=phase, stage=stage, bytes_requested=nbytes,
                    detail=text.splitlines()[0][:400] if text else type(exc).__name__)


# ---------------------------------------------------------------------------
# the HBM plan (preflight admission control)
# ---------------------------------------------------------------------------

@dataclass
class PlanItem:
    phase: str  # "steady" | "train" | "rollout" | "host"
    component: str
    bytes: int
    note: str = ""


@dataclass
class HBMPlan:
    """Itemized per-phase device accounting: ``steady`` items are resident
    in every phase, ``train`` and ``rollout`` items are phase-local, so
    the admission check is steady + max(train, rollout) against headroom x
    budget; ``host`` items are informational."""

    items: List[PlanItem] = field(default_factory=list)
    budget_bytes: int = 0
    headroom: float = 0.9

    def add(self, phase: str, component: str, nbytes: int, note: str = "") -> None:
        self.items.append(PlanItem(phase, component, int(nbytes), note))

    def total(self, phase: str) -> int:
        return sum(i.bytes for i in self.items if i.phase == phase)

    def row(self, component: str) -> int:
        """The bytes of the rows named `component` (0 when absent)."""
        return sum(i.bytes for i in self.items if i.component == component)

    def phase_totals(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for i in self.items:
            out[i.phase] = out.get(i.phase, 0) + i.bytes
        return out

    def peak_phase(self) -> Tuple[str, int]:
        """(phase, device bytes) of the worst phase."""
        steady = self.total("steady")
        peaks = {p: steady + t for p, t in self.phase_totals().items() if p not in ("steady", "host")} or {
            "steady": steady}
        worst = max(peaks, key=peaks.get)
        return worst, peaks[worst]

    def over_budget(self) -> bool:
        if self.budget_bytes <= 0:
            return False  # unknown budget: nothing to enforce against
        return self.peak_phase()[1] > self.headroom * self.budget_bytes

    def report(self) -> str:
        lines = ["HBM plan (per device):"]
        for phase in ("steady", "train", "rollout", "host"):
            items = [i for i in self.items if i.phase == phase]
            if not items:
                continue
            unit = "host RAM" if phase == "host" else "HBM"
            lines.append(f"  [{phase}] total {_fmt(sum(i.bytes for i in items))} ({unit})")
            for i in sorted(items, key=lambda x: -x.bytes):
                note = f"  — {i.note}" if i.note else ""
                lines.append(f"    {i.component:<28} {_fmt(i.bytes):>10}{note}")
        worst, peak = self.peak_phase()
        lines.append(f"  peak phase: {worst!r} at {_fmt(peak)} device-resident")
        if self.budget_bytes > 0:
            lines.append(f"  budget: {_fmt(self.budget_bytes)} x headroom {self.headroom:.0%} -> "
                         f"{_fmt(int(self.headroom * self.budget_bytes))} admitted; plan fills "
                         f"{peak / self.budget_bytes:.0%} of the device")
        else:
            lines.append("  budget: unknown (no card and train.memory.hbm_bytes is 0) — report only, "
                         "nothing enforced")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        worst, peak = self.peak_phase()
        return {
            "items": [{"phase": i.phase, "component": i.component, "bytes": i.bytes, "note": i.note}
                      for i in self.items],
            "phase_totals": self.phase_totals(),
            "peak_phase": worst,
            "peak_bytes": peak,
            "budget_bytes": self.budget_bytes,
            "headroom": self.headroom,
            "over_budget": self.over_budget(),
        }


def _fmt(nbytes: int) -> str:
    if abs(nbytes) >= 1 << 30:
        return f"{nbytes / (1 << 30):.2f}GiB"
    if abs(nbytes) >= 1 << 20:
        return f"{nbytes / (1 << 20):.2f}MiB"
    return f"{nbytes / 1024:.1f}KiB"


def tensor_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the distinct tensors (a tied weight counts once)."""
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def module_bytes(module: torch.nn.Module) -> int:
    """Bytes of a module's parameters and buffers."""
    return tensor_bytes(list(module.parameters()) + list(module.buffers()))


def _memory_fraction(device) -> float:
    get = getattr(torch.cuda, "get_per_process_memory_fraction", None)
    try:
        return float(get(device)) if get is not None else 1.0
    except Exception:
        return 1.0


def device_hbm_bytes(device=None) -> int:
    """The card's total memory times this process's memory fraction; 0 for
    the CPU (callers fall back to ``train.memory.hbm_bytes``)."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return 0
    if not torch.cuda.is_available():
        return 0
    device = device or torch.device("cuda", torch.cuda.current_device())
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * _memory_fraction(device))


def device_bytes_in_use(device=None) -> Optional[int]:
    """Bytes the tensors on the card hold (None off the card). Reads the
    caching allocator's host-side counters: no device sync."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.memory_stats(device).get("allocated_bytes.all.current", 0))


# activation residency coefficients by remat policy: saved residuals per
# layer in units of [rows, seq, hidden] activations (the reference's)
_ACT_COEFF = {"none": 14.0, "dots_saveable": 6.0, "save_attn": 3.0, "dots_with_no_batch_dims": 2.0,
              "offload": 2.0, "full": 2.0, "save_nothing": 2.0}


def _act_coeff(remat_policy) -> float:
    name = remat_policy if isinstance(remat_policy, str) else ("full" if remat_policy else "none")
    return _ACT_COEFF.get(name, 14.0)


def activation_bytes(rows_dev, seq, hidden, layers, remat_policy, csize) -> int:
    """Train-phase activation residency estimate (the live preflight and the
    offline CLI share it)."""
    return int(rows_dev * seq * hidden * layers * _act_coeff(remat_policy) * csize)


def logits_bytes(rows_dev, seq, vocab, chunks) -> int:
    """fp32 logits materialization (full, or per train.logit_chunks)."""
    chunks = max(int(chunks or 0), 0)
    rows = seq if chunks == 0 else -(-seq // chunks)
    return int(rows_dev * rows * vocab * 4)


def epoch_batch_bytes(n_rows, seq, ways) -> int:
    """The device-resident rollout store (~8 int32-sized fields a token)."""
    return int(n_rows * seq * 4 * 8 // max(ways, 1))


def _dtype_size(name: Optional[str]) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}.get(name or "float32", 4)


def engine_pool_bytes(spec, model_cfg, prompt_len: int, max_new: int) -> int:
    """Device bytes of the decode engine's policy page pool for a resolved
    EngineSpec (paged_kv.init_pool's shapes)."""
    from trlx_tpu_torch.ops import paged_kv

    K = spec.draft_k if spec.spec_decode else 0
    MP = paged_kv.pages_per_slot(prompt_len, max_new + K, spec.page_size)
    groups = max(getattr(spec, "data_groups", 1), 1)
    explicit = -(-spec.pool_pages // groups) if spec.pool_pages else 0
    NP = (explicit or (1 + spec.slots * MP)) if spec.paged else (1 + spec.slots * MP)
    head_dim = model_cfg.head_dim
    cells = model_cfg.n_layer * NP * spec.page_size * model_cfg.n_kv_head * head_dim
    if spec.kv_quant == "int8":
        per_pool = 2 * cells + 2 * (cells // head_dim) * 4
    else:
        itemsize = 2 if str(model_cfg.dtype) in ("bfloat16", "bf16", "torch.bfloat16") else 4
        per_pool = 2 * cells * itemsize
    return per_pool * groups


def draft_pool_bytes(pool_b: int, n_layer: int, shared_layers: int) -> int:
    """Bytes a speculative draft adds on top of the policy pool."""
    if shared_layers <= 0:
        return pool_b
    return pool_b * (n_layer - shared_layers) // n_layer


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """The device bytes the optimizer's state holds once every parameter
    has stepped (before the first step the state is empty: this predicts
    it from the parameters, as the optimizers create it). torch's AdamW and
    Adam: two moments shaped like the parameter (three with amsgrad); Lion
    and SGD with momentum: one; kernel 9's AdamW8bit: two int8 [blocks,
    256] payloads and two fp32 [blocks] scales. The 0-dim step counters are
    not counted (torch keeps them on the host)."""
    from trlx_tpu_torch.ops import adam8bit

    total = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            pb = p.numel() * p.element_size()
            if isinstance(optimizer, adam8bit.AdamW8bit):
                nb = adam8bit.n_blocks(p.numel())
                total += 2 * nb * adam8bit.BLOCK + 2 * nb * 4
            elif isinstance(optimizer, (torch.optim.AdamW, torch.optim.Adam)):
                total += (3 if group.get("amsgrad") else 2) * pb
            elif isinstance(optimizer, adam8bit.Lion):
                total += pb
            elif isinstance(optimizer, torch.optim.SGD):
                total += pb if group.get("momentum") else 0
            else:
                raise TypeError(f"no state-bytes rule for {type(optimizer).__name__}")
    return total


def decode_copy_bytes(model: torch.nn.Module, compute_dtype: torch.dtype) -> int:
    """The bytes `generation.cast_params_for_decode` allocates for the
    sampler's copy of `model`: nothing when no weight needs a cast,
    otherwise every parameter and buffer again, the matmul weights in the
    compute dtype, or int8 with an fp32 scale per output channel under
    `decode_weights_quant="int8"`."""
    from trlx_tpu_torch.models.generation import _quantized_projections

    quantized = _quantized_projections(model)
    lora = {id(m.kernel) for m in model.modules() if getattr(m.__dict__.get("lora"), "enabled", False)}
    held = {id(p) for m in model.modules() if m.__dict__.get("lora") is not None
            for p in m.__dict__["lora"].parameters()}
    needs_copy, total, seen = False, 0, set()
    for n, p in model.named_parameters():
        if id(p) in seen or id(p) in held:
            continue
        seen.add(id(p))
        cast = (n.rsplit(".", 1)[-1] in ("kernel", "wte", "wpe") and p.dtype.is_floating_point
                and p.dtype != compute_dtype)
        module = quantized.get(id(p))
        if module is not None:
            needs_copy = True
            total += p.numel() + p.shape[-1] * 4
        elif cast:
            needs_copy = True
            total += p.numel() * torch.empty((), dtype=compute_dtype).element_size()
        else:
            needs_copy = needs_copy or id(p) in lora
            total += p.numel() * p.element_size()
    if not needs_copy:
        return 0
    return total + tensor_bytes(model.buffers())


def estimate_plan(trainer) -> HBMPlan:
    """The per-phase plan of a live trainer:

      steady   the model's parameters and buffers (fp32 masters, heads,
               the adapter), the optimizer's state, the frozen reference
               where it is a copy (a hydra branch, a full copy; the base
               with the adapter off holds nothing of its own)
      train    the gradient tree handed to the optimizer (train.grads_dtype
               for the parameters of another dtype), activation residency
               of one microbatch, the logits, the rollout store
      rollout  the sampler's decode copy (int8 weights included), the
               decode engine's page pools or the static sampler's cache
    """
    cfg = trainer.config
    train = cfg.train
    md = getattr(trainer, "memdoctor", None)
    mcfg = md.cfg if md is not None else MemoryConfig()
    plan = HBMPlan(budget_bytes=mcfg.hbm_bytes or device_hbm_bytes(trainer.device), headroom=mcfg.headroom)
    model = trainer.model
    params_b = module_bytes(model)
    plan.add("steady", "params", params_b, "the model's parameters and buffers")
    plan.add("steady", "opt_state", optimizer_state_bytes(trainer.optimizer),
             f"{cfg.optimizer.name}, {len(trainer.trainable_params)} trainable tensors")
    ref = getattr(trainer, "ref_params", None)
    if isinstance(ref, torch.nn.Module):
        own = {id(t) for t in list(model.parameters()) + list(model.buffers())}
        ref_b = tensor_bytes(t for t in list(ref.parameters()) + list(ref.buffers()) if id(t) not in own)
        plan.add("steady", "ref_params", ref_b, "frozen reference (hydra branch or full copy)")

    gdt = trainer.grads_dtype
    grads_b = sum(p.numel() * (gdt.itemsize if gdt is not None and p.dtype != gdt else p.element_size())
                  for p in trainer.trainable_params)
    plan.add("train", "grads", grads_b, f"dtype {train.grads_dtype or train.param_dtype}"
             + ("; fp32 accumulator rides per-microbatch" if trainer.num_mb > 1 else ""))
    lm = model.base
    mc = lm.cfg
    E, L = int(getattr(mc, "hidden_size", getattr(mc, "d_model", 768))), int(mc.n_layer)
    V = int(mc.vocab_size)
    S = train.seq_length
    rows = trainer.mb_size
    plan.add("train", "activations",
             activation_bytes(rows, S, E, L, train.remat_policy, _dtype_size(train.compute_dtype)),
             f"{trainer.num_mb}x accumulation, mb_size {rows}, remat {train.remat_policy!r} "
             f"(coeff {_act_coeff(train.remat_policy):g})")
    chunks = max(int(train.logit_chunks or 0), 0)
    plan.add("train", "logits", logits_bytes(rows, S, V, chunks),
             "full materialization — set train.logit_chunks" if chunks == 0 else f"chunked x{chunks}")
    n_rows = int(getattr(cfg.method, "num_rollouts", train.batch_size))
    plan.add("train", "epoch_batch", epoch_batch_bytes(n_rows, S, 1), "device-resident rollout store")

    plan.add("rollout", "decode_params", decode_copy_bytes(lm, mc.dtype),
             "cast_params_for_decode copy" + (" (int8 block projections)"
                                             if getattr(mc, "decode_weights_quant", None) == "int8" else ""))
    try:
        engine_cfg = getattr(trainer, "_engine_cfg", None)
        chunk = int(getattr(cfg.method, "chunk_size", train.batch_size))
        if engine_cfg is not None and engine_cfg.enabled:
            max_new = trainer.generate_experience_settings.max_new_tokens
            spec = trainer._engine_spec(chunk)
            pool_b = engine_pool_bytes(spec, mc, max(S - max_new, 1), max_new)
            scaled = md is not None and md.enabled and md.pool_scale() < 1.0
            plan.add("rollout", "engine_kv_pool", pool_b,
                     f"{spec.slots} slots, page_size {spec.page_size}, quant {spec.kv_quant or 'none'}"
                     + (f", pool scaled x{md.pool_scale():g}" if scaled else ""))
            if spec.spec_decode:
                sh = spec.draft_shared_layers
                plan.add("rollout", "engine_draft_pool", draft_pool_bytes(pool_b, L, sh),
                         f"draft branch layers only ({sh} trunk layers share the policy pool)" if sh
                         else "speculative draft keeps its own pool (full copy)")
        else:
            kv_quant = getattr(mc, "kv_cache_quant", None)
            kv_size = 1 if kv_quant in ("int8", "int8_kernel") else _dtype_size(train.compute_dtype)
            kv_b = int(2 * L * chunk * S * mc.n_kv_head * mc.head_dim * kv_size)
            plan.add("rollout", "static_kv_cache", kv_b, f"whole-chunk cache, quant {kv_quant or 'none'}")
    except Exception as exc:
        plan.add("rollout", "kv_cache", 0, f"unestimated for this model family ({type(exc).__name__})")
    for item in trainer._extra_plan_items():
        plan.items.append(item)
    return plan


def cross_check(plan: HBMPlan, peak_bytes: int) -> Dict[str, Any]:
    """The plan against the measured peak of a real step
    (``torch.cuda.max_memory_allocated``): the reference reads XLA's
    compiled memory analysis instead, which has no torch counterpart."""
    worst, planned = plan.peak_phase()
    return {"plan_phase": worst, "plan_bytes": planned, "measured_peak_bytes": int(peak_bytes),
            "ratio": planned / peak_bytes if peak_bytes else None}


# ---------------------------------------------------------------------------
# runtime watermarks
# ---------------------------------------------------------------------------

class WatermarkSampler:
    """Host-side device-memory sampler: a daemon thread reads the bytes in
    use on a fixed cadence, attributes the reading to the phase in progress
    and latches a trip when the high watermark is crossed for
    ``watermark_window`` consecutive samples. The trainer consumes the trip
    at its next safe point (``consume_trip``) and forwards it as the
    ``memory`` guardrail signal.

    ``stats_fn`` returns (bytes_in_use, bytes_limit) or None; the default
    reads the caching allocator of `device` (None off the card).
    ``phase_fn`` names the current phase: the hang doctor is not ported,
    so it returns None and every reading lands under "run", as the
    reference's does with its watchdog off."""

    def __init__(self, config: MemoryConfig, stats_fn: Optional[Callable[[], Optional[Tuple[int, int]]]] = None,
                 phase_fn: Optional[Callable[[], str]] = None, device=None):
        self.cfg = config
        self.device = device
        self._stats_fn = stats_fn or self._default_stats
        self._phase_fn = phase_fn or (lambda: "run")
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.peaks: Dict[str, int] = {}
        self.samples = 0
        self._high_streak = 0
        self._trip_detail: Optional[str] = None
        self.watermark_trips = 0
        self._warned_no_stats = False
        self._creep_samples = 0

    def _default_stats(self) -> Optional[Tuple[int, int]]:
        used = device_bytes_in_use(self.device)
        if used is None:
            return None
        return used, device_hbm_bytes(self.device)

    def inject_creep(self, samples: Optional[int] = None) -> None:
        """Chaos ``hbm_creep``: the next `samples` readings saturate the
        watermark, as a silently leaking allocation would."""
        with self._lock:
            self._creep_samples += samples or self.cfg.watermark_window

    def sample(self) -> None:
        """One sampling step (the thread calls it on cadence; tests call it
        directly)."""
        stats = self._stats_fn()
        phase = self._phase_fn() or "run"
        with self._lock:
            creep = self._creep_samples > 0
            if creep:
                self._creep_samples -= 1
        if stats is None and not creep:
            if not self._warned_no_stats and self.samples == 0:
                self._warned_no_stats = True
                logger.info("memory doctor: no device memory stats (CPU) — runtime watermarks are inactive "
                            "(preflight and the OOM ladder still apply)")
            return
        if creep:
            limit = (stats[1] if stats else 0) or self.cfg.hbm_bytes or (1 << 30)
            used = limit
        else:
            used, limit = stats
            limit = limit or self.cfg.hbm_bytes
        with self._lock:
            self.samples += 1
            if not creep and used > self.peaks.get(phase, 0):
                # creep-forced readings drive the trip, never the peaks
                self.peaks[phase] = int(used)
            if limit and used >= self.cfg.high_watermark * limit:
                self._high_streak += 1
                if self._high_streak >= self.cfg.watermark_window and self._trip_detail is None:
                    self._trip_detail = (
                        f"HBM bytes-in-use {_fmt(int(used))} crossed the {self.cfg.high_watermark:.0%} watermark "
                        f"of {_fmt(int(limit))} for {self._high_streak} consecutive samples (phase {phase!r})"
                    )
            elif self._creep_samples == 0:
                self._high_streak = 0

    def consume_trip(self) -> Optional[str]:
        """The latched watermark trip, if any (one-shot)."""
        with self._lock:
            detail, self._trip_detail = self._trip_detail, None
            if detail is not None:
                self._high_streak = 0
                self.watermark_trips += 1
            return detail

    def peak_stats(self) -> Dict[str, float]:
        """``memory/peak_<phase>_mb`` scalars for the tracker."""
        with self._lock:
            return {f"memory/peak_{phase}_mb": round(b / (1 << 20), 2) for phase, b in self.peaks.items()}

    def start(self) -> None:
        if not self.cfg.enabled or self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run, name="hbm-watermark", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop_evt.wait(self.cfg.sample_interval_s):
            try:
                self.sample()
            except Exception:
                logger.exception("memory doctor: watermark sample failed")


# ---------------------------------------------------------------------------
# the recovery ladder
# ---------------------------------------------------------------------------

class MemoryDoctor:
    """The degrade-don't-die state machine: the monotonic degradation
    (pool shrinks, gradient-accumulation factor, remat escalation), the
    next ladder action for a classified OOM, and its state.json record.
    trainer/base.py executes the actions."""

    def __init__(self, config: MemoryConfig, device=None):
        self.cfg = config
        self.pool_shrinks = 0
        self.accum_factor = 1  # multiplier on the configured num_mb
        self.remat_policy: Optional[str] = None  # None = untouched
        self.rollbacks = 0
        self.events: List[Dict[str, Any]] = []
        self.sampler = WatermarkSampler(config, device=device)

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    @property
    def degraded(self) -> bool:
        return is_degraded_record(self.degrade_state())

    def pool_scale(self) -> float:
        return self.cfg.pool_shrink_factor ** self.pool_shrinks

    def decide(self, event: OOMEvent, caps: Dict[str, bool]) -> str:
        """The cheapest ladder action that can relieve `event`'s phase given
        the run's capabilities (`caps`); an exhausted, incapable or
        irrelevant rung is skipped. Falls through to abort."""
        if event.phase.startswith("rollout"):
            relevant = ("shrink_pool", "abort")
        elif event.phase == "experience":
            relevant = ("abort",)
        else:
            relevant = ("split_microbatch", "remat", "rollback", "abort")
        for action in self.cfg.ladder:
            if action not in relevant:
                continue
            if action == "shrink_pool":
                if caps.get("shrink_pool") and self.pool_shrinks < self.cfg.max_pool_shrinks:
                    return action
            elif action == "split_microbatch":
                if caps.get("split_microbatch") and self._splits < self.cfg.max_splits:
                    return action
            elif action == "remat":
                if caps.get("remat") and self.remat_policy is None:
                    return action
            elif action == "rollback":
                if caps.get("rollback"):
                    return action
            else:
                return "abort"
        return "abort"

    @property
    def _splits(self) -> int:
        return max(self.accum_factor.bit_length() - 1, 0)

    def note(self, event: OOMEvent, action: str) -> None:
        """Record the classified OOM and the action taken."""
        self.events.append({"phase": event.phase, "stage": event.stage,
                            "bytes_requested": event.bytes_requested, "action": action})
        if action == "shrink_pool":
            self.pool_shrinks += 1
        elif action == "split_microbatch":
            self.accum_factor *= 2
        elif action == "rollback":
            self.rollbacks += 1
        logger.warning("memory doctor: %s -> %s (degradation now: %s)", event.summary(), action, self.describe())

    def note_remat(self, policy: str) -> None:
        self.remat_policy = policy

    def describe(self) -> str:
        if not self.degraded:
            return "none"
        parts = []
        if self.pool_shrinks:
            parts.append(f"pool x{self.pool_scale():g} ({self.pool_shrinks} shrinks)")
        if self.accum_factor > 1:
            parts.append(f"grad-accum x{self.accum_factor}")
        if self.remat_policy is not None:
            parts.append(f"remat={self.remat_policy}")
        return ", ".join(parts)

    def abort_report(self, event: OOMEvent, plan: Optional[HBMPlan]) -> str:
        """The itemized abort message: what failed, what was tried, where the
        plan says the bytes go."""
        lines = [
            f"memory doctor: ladder exhausted — {event.summary()}",
            f"  degradation applied: {self.describe()}",
            f"  OOM history ({len(self.events)} events): "
            + "; ".join(f"{e['phase']}/{e['stage']}->{e['action']}" for e in self.events[-8:]),
        ]
        if plan is not None:
            lines.append(plan.report())
        lines.append("  next: lower method.chunk_size / train.batch_size, or move to a larger device — then "
                     "resume from the last committed checkpoint")
        return "\n".join(lines)

    def degrade_state(self) -> Dict[str, Any]:
        """The state.json payload (``memory_degrade``)."""
        return {"pool_shrinks": self.pool_shrinks, "accum_factor": self.accum_factor,
                "remat_policy": self.remat_policy, "rollbacks": self.rollbacks, "events": self.events[-16:]}

    def restore(self, state: Optional[Dict[str, Any]]) -> None:
        """Adopt a persisted degradation, merging by max per field: a
        rollback restoring an older state.json never un-degrades the run."""
        if not state:
            return
        self.pool_shrinks = max(self.pool_shrinks, int(state.get("pool_shrinks", 0)))
        self.accum_factor = max(self.accum_factor, int(state.get("accum_factor", 1)))
        saved = state.get("remat_policy")
        if saved is not None and (self.remat_policy is None
                                  or remat_strength(saved) > remat_strength(self.remat_policy)):
            self.remat_policy = saved
        self.rollbacks = max(self.rollbacks, int(state.get("rollbacks", 0)))
        if state.get("events"):
            saved_ev = list(state["events"])
            # an in-process rollback: the live list already holds them
            if self.events[: len(saved_ev)] != saved_ev:
                self.events = saved_ev + self.events


def build_memdoctor(train_config, device=None) -> MemoryDoctor:
    """TrainConfig -> doctor."""
    return MemoryDoctor(MemoryConfig.from_dict(getattr(train_config, "memory", None)), device=device)


# ---------------------------------------------------------------------------
# config-only analytic plan (python -m trlx_tpu_torch.tools.hbm_plan)
# ---------------------------------------------------------------------------

def analytic_param_count(tcfg: Dict[str, Any]) -> int:
    """Parameter count from transformer-config numbers alone (the reference's
    formula: embeddings + per-layer attention/MLP/norms + final norm)."""
    V = int(tcfg.get("vocab_size", 50257))
    E = int(tcfg.get("hidden_size", 768))
    L = int(tcfg.get("n_layer", 12))
    P = int(tcfg.get("n_positions", 1024))
    H = int(tcfg.get("n_head", 12))
    Hkv = int(tcfg.get("n_kv_head", H))
    D = int(tcfg.get("head_dim", E // max(H, 1)))
    I = int(tcfg.get("intermediate_size", 4 * E))  # noqa: E741
    attn = E * (H * D) + E * (2 * Hkv * D) + (H * D) * E + (H * D + 2 * Hkv * D + E)
    mlp = E * I + I * E + I + E
    norms = 4 * E
    return V * E + P * E + L * (attn + mlp + norms) + 2 * E


def analytic_plan(config, hbm_bytes: int = 0) -> HBMPlan:
    """Per-phase plan from a TRLConfig alone: no trainer, no device, no
    allocation. One process, one device: no mesh axes to resolve."""
    from trlx_tpu_torch.models.gen_engine import GenEngineConfig, hydra_shared_trunk_layers

    train = config.train
    mcfg = MemoryConfig.from_dict(getattr(train, "memory", None))
    tdict = dict((config.model.model_extra_configs or {}).get("transformer", {}))
    tdict.setdefault("n_positions", train.seq_length)
    n_params = analytic_param_count(tdict)
    E = int(tdict.get("hidden_size", 768))
    L = int(tdict.get("n_layer", 12))
    V = int(tdict.get("vocab_size", 50257))
    H = int(tdict.get("n_head", 12))
    Hkv = int(tdict.get("n_kv_head", H))
    D = int(tdict.get("head_dim", E // max(H, 1)))

    plan = HBMPlan(budget_bytes=hbm_bytes or mcfg.hbm_bytes or device_hbm_bytes(), headroom=mcfg.headroom)
    psize = _dtype_size(train.param_dtype)
    plan.add("steady", "params", n_params * psize, f"~{n_params / 1e6:.1f}M params (analytic)")
    opt_name = config.optimizer.name.lower()
    opt_mult = 3 if "8bit" in opt_name or "adam8" in opt_name else 8
    plan.add("steady", "opt_state", n_params * opt_mult,
             f"{config.optimizer.name} (x{opt_mult} bytes/param"
             + (": 2x int8 moments + block scales)" if opt_mult == 3 else ")"))
    unfrozen = config.model.num_layers_unfrozen
    mname = getattr(config.method, "name", "").lower()
    if mname in ("ppoconfig", "ppo"):
        ref_frac = 1.0 if unfrozen in (-1, None) else min(max(unfrozen, 0) / max(L, 1), 1.0)
        plan.add("steady", "ref_params", int(n_params * psize * ref_frac),
                 "frozen reference" + (" (hydra branch)" if ref_frac < 1 else ""))
    elif mname in ("grpoconfig", "grpo", "dpoconfig", "dpo"):
        plan.add("steady", "ref_params", n_params * psize, "frozen reference (full copy of the initial policy)")

    mb = train.minibatch_size or train.batch_size
    S = train.seq_length
    csize = _dtype_size(train.compute_dtype)
    plan.add("train", "activations", activation_bytes(mb, S, E, L, train.remat_policy, csize),
             f"mb_size {mb}, remat {train.remat_policy!r} (coeff {_act_coeff(train.remat_policy):g})")
    gsize = _dtype_size(train.grads_dtype or train.param_dtype)
    plan.add("train", "grads", n_params * gsize, f"dtype {train.grads_dtype or train.param_dtype}")
    chunks = max(int(train.logit_chunks or 0), 0)
    plan.add("train", "logits", logits_bytes(mb, S, V, chunks),
             "full materialization — set train.logit_chunks" if chunks == 0 else f"chunked x{chunks}")
    n_rows = int(getattr(config.method, "num_rollouts", train.batch_size))
    plan.add("train", "epoch_batch", epoch_batch_bytes(n_rows, S, 1), "device-resident rollout store")

    plan.add("rollout", "decode_params", n_params * 2, "bf16 decode cast copy")
    ge = dict(getattr(config.method, "gen_engine", None) or {})
    chunk = int(getattr(config.method, "chunk_size", train.batch_size))
    max_new = int(dict(getattr(config.method, "gen_kwargs", {}) or {}).get("max_new_tokens", 40))
    if ge.get("enabled"):
        class _MC:  # the fields resolve() and the pool bytes read
            n_layer = L
            n_kv_head = Hkv
            head_dim = D
            kv_cache_quant = tdict.get("kv_cache_quant")
            dtype = train.compute_dtype

        spec = GenEngineConfig.from_dict(ge).resolve(chunk, _MC)
        pool_b = engine_pool_bytes(spec, _MC, max(S - max_new, 1), max_new)
        plan.add("rollout", "engine_kv_pool", pool_b,
                 f"{spec.slots} slots, page_size {spec.page_size}, quant {spec.kv_quant or 'none'}")
        if spec.spec_decode:
            sh = hydra_shared_trunk_layers(L, int(getattr(config.model, "num_layers_unfrozen", -1)))
            plan.add("rollout", "engine_draft_pool", draft_pool_bytes(pool_b, L, sh),
                     f"draft branch layers only ({sh} trunk layers share the policy pool)" if sh
                     else "speculative draft pool (full copy)")
    else:
        kv_quant = tdict.get("kv_cache_quant")
        kv_size = 1 if kv_quant in ("int8", "int8_kernel") else 2
        plan.add("rollout", "static_kv_cache", int(2 * L * chunk * S * Hkv * D * kv_size),
                 f"whole-chunk cache, quant {kv_quant or 'none'}")
    return plan
