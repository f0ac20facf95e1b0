"""Host-side utilities of the port (after trlx_tpu.utils): seeding, the
tick clock, and the optimizer / scheduler registries on `torch.optim`.

The registries keep the reference's names and kwargs (torch-style `lr`,
`betas`, `eps`, `weight_decay`; `T_max`/`eta_min` for cosine) and its
numerics: AdamW decays every parameter it is given (one param group, as
optax.adamw does), and step k uses schedule(k) — the LambdaLR is stepped
after each optimizer step. `adamw_8bit_bnb`, `adamw_8bit_fused` and
`lion` are the port's own optimizers (`ops/adam8bit.py`); their `step`
takes a gradient tree of another dtype (`grads=`).
"""

from __future__ import annotations

import math
import random
import time
from enum import Enum
from numbers import Number
from typing import Any, Callable, Iterable, Iterator, Tuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1


def set_seed(seed: int) -> None:
    """Seed the host RNGs (python, numpy, torch's default generator)."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def significant(x: Any, ndigits: int = 2) -> Any:
    """Round a number to `ndigits` significant figures (for log display)."""
    if not isinstance(x, Number) or x == 0 or not math.isfinite(x):
        return x
    return round(x, ndigits - int(math.floor(math.log10(abs(x)))) - 1)


def infinite_loader(loader: Iterable) -> Iterator:
    """Cycle a dataloader forever (the prompt stream of the rollouts)."""
    while True:
        yield from loader


def to_scalar(x) -> float:
    """A tensor or number as a host float."""
    if isinstance(x, torch.Tensor):
        return float(x.detach().float().cpu())
    return float(x)


class Clock:
    """Wall-clock tick timer (feeds the `time/*` metrics)."""

    def __init__(self):
        self.start = time.time()

    def tick(self) -> float:
        """Seconds since the last tick (or since the clock was made)."""
        end = time.time()
        delta = end - self.start
        self.start = end
        return delta


# ---------------------------------------------------------------------------
# Optimizer / scheduler registries
# ---------------------------------------------------------------------------


class OptimizerName(str, Enum):
    ADAM = "adam"
    ADAMW = "adamw"
    ADAMW_8BIT_BNB = "adamw_8bit_bnb"
    ADAMW_8BIT_FUSED = "adamw_8bit_fused"
    SGD = "sgd"
    LION = "lion"


def get_optimizer_class(name: str) -> Callable:
    """A factory `(params, lr, **kwargs) -> torch.optim.Optimizer` for a
    registry name, taking the reference's torch-style kwargs."""
    name = OptimizerName(name.lower() if isinstance(name, str) else name)
    if name in (OptimizerName.ADAMW_8BIT_BNB, OptimizerName.ADAMW_8BIT_FUSED):
        from trlx_tpu_torch.ops.adam8bit import AdamW8bit

        fused = name == OptimizerName.ADAMW_8BIT_FUSED

        def make_adam8bit(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **kw):
            return AdamW8bit(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, fused=fused, **kw)

        return make_adam8bit
    if name == OptimizerName.LION:
        from trlx_tpu_torch.ops.adam8bit import Lion

        def make_lion(params, lr, betas=(0.9, 0.99), weight_decay=0.0, **kw):
            return Lion(params, lr=lr, betas=betas, weight_decay=weight_decay, **kw)

        return make_lion

    if name in (OptimizerName.ADAM, OptimizerName.ADAMW):
        # "adam" with weight decay is adamw in the reference (decoupled decay)
        def make_adam(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **kw):
            betas = tuple(betas)
            if name == OptimizerName.ADAM and not weight_decay:
                return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, **kw)
            return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                     weight_decay=weight_decay, **kw)

        return make_adam

    def make_sgd(params, lr, momentum=0.0, weight_decay=0.0, **kw):
        # the reference adds the decayed weights to the gradient before
        # the (optionally momentum) step: torch's coupled SGD decay
        return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0,
                               weight_decay=weight_decay, **kw)

    return make_sgd


class SchedulerName(str, Enum):
    COSINE_ANNEALING = "cosine_annealing"
    LINEAR = "linear"
    CONSTANT = "constant"


def _with_warmup(fn: Callable[[int], float], warmup_steps: int) -> Callable[[int], float]:
    """Linear 0 -> 1 over `warmup_steps`, then `fn` counted from the end of
    the warmup (optax.join_schedules)."""
    if not warmup_steps:
        return fn
    return lambda step: step / warmup_steps if step < warmup_steps else fn(step - warmup_steps)


def get_scheduler_class(name: str) -> Callable:
    """A factory `(lr, **kwargs) -> (step -> lr multiplier)`: the schedule
    as a fraction of the peak `lr`, for `LambdaLR`."""
    name = SchedulerName(name.lower() if isinstance(name, str) else name)

    if name == SchedulerName.COSINE_ANNEALING:
        def make_cos(lr, T_max, eta_min=0.0, warmup_steps: int = 0, **_):
            # reference configs ship T_max=1e12 ("effectively constant");
            # the reference clamps it to the largest int32 step, kept here
            decay_steps = int(min(max(int(T_max), 1), INT32_MAX))
            alpha = (eta_min / lr) if lr else 0.0

            def cos(step: int) -> float:
                frac = min(step, decay_steps) / decay_steps
                return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha

            return _with_warmup(cos, warmup_steps)

        return make_cos
    if name == SchedulerName.LINEAR:
        def make_lin(lr, total_steps, final_lr=0.0, warmup_steps: int = 0, **_):
            steps = int(min(max(int(total_steps), 1), INT32_MAX))
            end = (final_lr / lr) if lr else 0.0

            def lin(step: int) -> float:
                frac = min(step, steps) / steps
                return 1.0 + (end - 1.0) * frac

            return _with_warmup(lin, warmup_steps)

        return make_lin
    return lambda lr, **_: (lambda step: 1.0)


def build_optimizer(params, opt_cfg, sched_cfg) -> Tuple[torch.optim.Optimizer, Any, Callable[[int], float]]:
    """(OptimizerConfig, SchedulerConfig) -> (optimizer, LambdaLR, schedule)
    over `params` in ONE param group; `schedule(step)` is the learning rate
    of optimizer step `step` (step the LambdaLR after each optimizer
    step)."""
    opt_kwargs = dict(opt_cfg.kwargs)
    lr = opt_kwargs.pop("lr")
    factor = get_scheduler_class(sched_cfg.name)(lr, **dict(sched_cfg.kwargs))
    optimizer = get_optimizer_class(opt_cfg.name)(list(params), lr, **opt_kwargs)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return optimizer, scheduler, lambda step: lr * factor(step)


def _adam_zero_state(group: dict, p: torch.Tensor) -> dict:
    """torch Adam's and AdamW's state before p's first step, as their
    `_init_group` makes it: the count on the host unless the step is
    capturable or fused (then on p's device, fp32), the moments (and
    amsgrad's maximum) zeros like p."""
    on_device = group["capturable"] or group["fused"]
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 and not group["fused"] else torch.float32
    st = {"step": torch.zeros((), dtype=scalar, device=p.device if on_device else "cpu")}
    keys = ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if group["amsgrad"] else ())
    st.update({k: torch.zeros_like(p, memory_format=torch.preserve_format) for k in keys})
    return st


def init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Create the state of every parameter that has none yet, exactly as the
    optimizer's first step would (the reference's optax state exists from
    `opt.init`): the port's optimizers through their own `init_state(p)`
    (kernel 9's AdamW8bit its zero codes, Lion its moment), torch's Adam
    and AdamW their step count and moments. Then an OOM inside the first
    step finds the state whole, and the state's bytes are held from the
    start. Other optimizers (SGD: its first step stores the gradient
    itself as the momentum, which a zero buffer would not give with
    dampening) keep their lazy state."""
    if hasattr(optimizer, "init_state"):
        make = lambda group, p: optimizer.init_state(p)  # noqa: E731
    elif isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        make = _adam_zero_state
    else:
        return
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not optimizer.state[p]:
                optimizer.state[p].update(make(group, p))
