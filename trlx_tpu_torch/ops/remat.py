"""Activation-checkpointing policies (port of trlx_tpu.ops.remat).

The reference wraps its scanned layer body in `jax.checkpoint` with a
policy; here each block of a pass that records a graph runs under
`torch.utils.checkpoint` (non-reentrant), one checkpoint a block, and
the policy decides what the forward keeps for the backward:

  none          no checkpoint: every activation kept
  full          the block recomputed from its input in the backward
                (`save_nothing` is an alias)
  dots_saveable the outputs of every matrix product kept (selective
                checkpointing), the rest recomputed
  dots_with_no_batch_dims
                the outputs of the weight products (2-D `mm` / `addmm`)
                kept, the batched attention products recomputed
  offload       as dots_with_no_batch_dims, the kept outputs copied to
                pinned host memory in the forward and back in the
                recompute
  save_attn     the whole block recomputed except the flash kernel's
                out, m and l (`saved_attention`): the recompute re-runs
                the projections but not the attention kernel

The attention kernels are opaque to a selective policy (one ctypes launch
per call), so under `dots_saveable` they are recomputed like any other
op; `save_attn` names their outputs explicitly, as the reference's
`save_only_these_names("flash_out", "flash_m", "flash_l")` does. A
recompute re-launches every kernel of the block it re-runs, and the
kernels' launch counters count those launches.

Passes without a graph (rollouts, experience passes, evaluation) are never
checkpointed: `checkpoint_block` runs the block as it is when grad mode is
off.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

RematArg = Union[bool, str]

_POLICY_NAMES = (
    "none",
    "full",
    "save_nothing",
    "dots_saveable",
    "dots_with_no_batch_dims",
    "offload",
    "save_attn",
)


def resolve_remat(policy: RematArg) -> RematArg:
    """Validate a config `remat_policy` and normalise it: False for "none"
    (so `if remat:` checks stay right), the policy name otherwise. Bools
    pass through."""
    if isinstance(policy, bool):
        return policy
    if policy not in _POLICY_NAMES:
        raise ValueError(f"remat_policy={policy!r} not in {_POLICY_NAMES}")
    return False if policy == "none" else policy


_aten = torch.ops.aten
# every matrix product, and the weight products alone (a [B, T, E] x [E, F]
# projection reaches aten as a 2-D mm of the flattened rows)
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default})
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})


def _save_ops(ops, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


class _OffloadSave(TorchDispatchMode):
    """The forward: each weight product's output also copied to (pinned,
    on a card) host memory, in order."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _NO_BATCH_DOTS:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=out.is_cuda)
            host.copy_(out, non_blocking=True)
            self.store.append((host, out.device))
        return out


class _OffloadReplay(TorchDispatchMode):
    """The recompute: each weight product's output comes back from host
    memory instead of being recomputed."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _NO_BATCH_DOTS:
            host, device = self.store.pop(0)
            return host.to(device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    store: list = []
    return _OffloadSave(store), _OffloadReplay(store)


# save_attn: where the attention wrappers' outputs go ("record", list) in a
# checkpointed forward and come from ("replay", list) in its recompute
_ATTN = threading.local()


def saved_attention(compute: Callable):
    """The attention kernel's (out, m, l): computed (and recorded under a
    save_attn forward) or, in a save_attn recompute, the recorded ones."""
    mode = getattr(_ATTN, "mode", None)
    if mode is None:
        return compute()
    kind, store = mode
    if kind == "replay":
        return store.pop(0)
    out = compute()
    store.append(out)
    return out


@contextlib.contextmanager
def _attn_mode(kind: str, store: list):
    prev = getattr(_ATTN, "mode", None)
    _ATTN.mode = (kind, store)
    try:
        yield
    finally:
        _ATTN.mode = prev


def _attn_contexts():
    store: list = []
    return _attn_mode("record", store), _attn_mode("replay", store)


_CONTEXTS = {
    "dots_saveable": functools.partial(create_selective_checkpoint_contexts,
                                       functools.partial(_save_ops, _DOTS)),
    "dots_with_no_batch_dims": functools.partial(create_selective_checkpoint_contexts,
                                                 functools.partial(_save_ops, _NO_BATCH_DOTS)),
    "offload": _offload_contexts,
    "save_attn": _attn_contexts,
}


def checkpoint_block(fn: Callable, remat: RematArg, *args, **kwargs):
    """`fn(*args, **kwargs)`, checkpointed with the resolved policy `remat`
    when grad mode is on; as it is otherwise or for "none"/False."""
    if not remat or remat == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    extra = {}
    if remat in _CONTEXTS:
        extra["context_fn"] = _CONTEXTS[remat]
    # no block draws random numbers: no RNG state to stash
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **extra, **kwargs)
