"""The continuous-batching rollout decode engine: paged (optionally int8)
KV pools, slot refills and speculative decoding (port of
trlx_tpu.models.gen_engine).

A fixed set of `slots` decode lanes is fed from a prompt queue. Whenever
a lane finishes (EOS or its token budget), the next iteration's refill
prefills the next queued prompts into free lanes, so the step batch stays
dense until the queue drains. Lanes index fixed-size pages of one pool
through a page table (ops/paged_kv.py): a finished lane's pages return to
a free stack, response pages are taken lazily, and prompt pages that hold
only left padding are released right after the prefill. With
`spec_decode`, the frozen reference drafts `draft_k` tokens, the policy
verifies them in one T = draft_k forward, and rejection sampling keeps
every emitted token's distribution the policy's (greedy: accept iff the
draft is the policy's argmax, so greedy output is the non-speculative
stream). A hydra draft (the policy's trunk under the frozen branch)
shares the trunk's KV pages with the policy: the pool's layer axis grows
by the branch depth only, and page lifetimes run through reference
counts (two holders a page).

RNG contract: every draw is keyed on (queue row, response index, event
kind), never on the slot or the step (models/generation.py, per-lane
sampling), so a prompt's continuation does not depend on the batch, the
slot geometry or whether speculative decoding is on.

What differs from the reference, and why:
- Control flow. The reference runs one `lax.while_loop` on the device;
  here a Python loop runs the same `cond` and `body`. The allocator and
  the lane state stay device tensors with the reference's integers; each
  iteration reads its `cond` and `need` flags together in one
  device->host copy, and an iteration that starts with every lane idle
  and refills reads once more whether any refilled lane is live.
- In place. The pools are written in place by the model's forward, where
  the reference threads them through the loop as a carry.
- Left out: serving mode (`warm`, `q_pin`, `q_ready`, `q_rng_row`,
  `rng_space`, `kv_state`; ROADMAP queue 11) and engine lane groups
  (`data_groups > 1`; ROADMAP queue 12). Each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from trlx_tpu_torch.models.generation import (
    SamplerSettings,
    cast_params_for_decode,
    categorical_lanes,
    lane_gumbel,
    lane_keys,
    lane_uniform,
    process_logits,
    sample_token_lanes,
)
from trlx_tpu_torch.models.transformer import Branch, TransformerLM, logit_projection
from trlx_tpu_torch.ops import paged_kv


@dataclass(frozen=True)
class GenEngineConfig:
    """`method.gen_engine.*`, the user-facing engine configuration (a plain
    dict in YAML, parsed here so unknown keys fail at config load).

    enabled       route rollout generation through the engine.
    slots         decode lanes per step; 0 = the generate() call's batch.
    page_size     tokens per KV page.
    paged         False = a contiguous per-slot layout (no indirection,
                  no lazy allocation).
    pool_pages    total pages in the pool; 0 = the worst case
                  (slots * pages_per_slot + the null page).
    refill_width  prompts prefilled per refill event; 0 = slots.
    spec_decode   draft with the frozen reference, verify with the policy.
    draft_k       drafted tokens per speculative round.
    kv_quant      "int8" | "none"; None follows the model's kv_cache_quant.
    paged_attention_impl  "xla" (gather, plain math) | "pallas" (the paged
                  kernel); the contiguous layout always gathers.
    data_groups   independent engine lane groups (> 1 not ported yet).
    """

    enabled: bool = False
    slots: int = 0
    page_size: int = 128
    paged: bool = True
    pool_pages: int = 0
    refill_width: int = 0
    spec_decode: bool = False
    draft_k: int = 4
    kv_quant: Optional[str] = None
    paged_attention_impl: str = "xla"
    data_groups: int = 1

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "GenEngineConfig":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"ppo.gen_engine: unknown keys {sorted(unknown)} (known: {sorted(known)})"
            )
        cfg = cls(**d)
        if cfg.page_size < 1:
            raise ValueError("ppo.gen_engine.page_size must be >= 1")
        if cfg.draft_k < 1:
            raise ValueError("ppo.gen_engine.draft_k must be >= 1")
        if cfg.kv_quant not in (None, "none", "int8"):
            raise ValueError(f"ppo.gen_engine.kv_quant must be none/int8, got {cfg.kv_quant!r}")
        if cfg.paged_attention_impl not in ("xla", "pallas"):
            raise ValueError(
                f"ppo.gen_engine.paged_attention_impl must be xla/pallas, got {cfg.paged_attention_impl!r}"
            )
        if cfg.data_groups < 1:
            raise ValueError("ppo.gen_engine.data_groups must be >= 1")
        return cfg

    def resolve(self, batch: int, model_cfg) -> "EngineSpec":
        """Concretize against a call's batch width and the model."""
        quant = self.kv_quant
        if quant is None:
            quant = "int8" if model_cfg.kv_cache_quant in ("int8", "int8_kernel") else "none"
        slots = self.slots or batch
        if batch:
            slots = min(slots, batch)
        groups = self.data_groups
        if batch:
            groups = max(1, min(groups, batch))
        return EngineSpec(
            slots=slots,
            page_size=self.page_size,
            paged=self.paged,
            pool_pages=self.pool_pages,
            refill_width=self.refill_width or slots,
            spec_decode=self.spec_decode,
            draft_k=self.draft_k,
            kv_quant=None if quant == "none" else quant,
            paged_attention_impl=self.paged_attention_impl,
            data_groups=groups,
        )


@dataclass(frozen=True)
class EngineSpec:
    """Static engine geometry. `draft_shared_layers` is derived, not user
    config: with a hydra speculative draft the draft's bottom layers are
    the policy's trunk, and the engine stores their KV once. Valid only
    for a draft from `compose_draft_params`; a full copy shares nothing."""

    slots: int
    page_size: int = 128
    paged: bool = True
    pool_pages: int = 0
    refill_width: int = 0
    spec_decode: bool = False
    draft_k: int = 4
    kv_quant: Optional[str] = None
    paged_attention_impl: str = "xla"
    data_groups: int = 1
    draft_shared_layers: int = 0


def hydra_shared_trunk_layers(n_layer: int, ref_branch_layers) -> int:
    """Trunk layers a composed hydra draft shares with the policy pool:
    L - k for a top-k branch reference (0 < k < L), else 0."""
    k = ref_branch_layers
    if k is None or k <= 0 or k >= n_layer:
        return 0
    return n_layer - k


def _round_up(x: int, to: int) -> int:
    return x + (-x) % to


def compose_draft_params(cfg, policy: TransformerLM, ref_params: nn.Module) -> TransformerLM:
    """The speculative draft = the frozen PPO reference. A full-copy
    reference is a standalone model and is returned as it is. A hydra
    `Branch` holds only the top k blocks: the draft is a model made of the
    policy's trunk blocks (shared, not copied) under the branch's blocks,
    with the branch's final norm, embedding and untied lm_head (if any)."""
    if not isinstance(ref_params, Branch):
        return ref_params
    k = len(ref_params.blocks)
    draft = TransformerLM.__new__(TransformerLM)
    nn.Module.__init__(draft)
    draft.cfg = cfg
    draft.embed = ref_params.embed
    draft.blocks = nn.ModuleList(list(policy.blocks[: cfg.n_layer - k]) + list(ref_params.blocks))
    draft.ln_f = ref_params.ln_f
    draft.lm_head = ref_params.lm_head
    return draft


def _drop_set(x: torch.Tensor, rows: torch.Tensor, value, cols=None) -> torch.Tensor:
    """A copy of `x` with x[rows(, cols)] = value, where a row index outside
    [0, len(x)) is dropped (the reference's scatter mode="drop"), without
    a device->host read: such writes land in a spare row cut off after."""
    n = x.shape[0]
    ext = torch.cat([x, x[:1]])
    rows = torch.where((rows >= 0) & (rows < n), rows, n).long()
    if cols is None:
        ext[rows] = value
    else:
        ext[rows, cols] = value
    return ext[:n]


@torch.no_grad()
def engine_generate(
    model: TransformerLM,
    q_ids: torch.Tensor,  # [Q, P] LEFT-padded prompt queue
    q_mask: torch.Tensor,  # [Q, P]
    seed: int,
    settings: SamplerSettings,
    spec: EngineSpec,
    draft_params: Optional[nn.Module] = None,
    row_budget: Optional[torch.Tensor] = None,  # [Q] per-row max_new (<= N)
    warm=None,
    q_pin=None,
    q_ready=None,
    q_rng_row=None,
    rng_space=None,
) -> Dict[str, Any]:
    """Generate a continuation for every queue row through the engine.

    Returns the static sampler's contract (sequences [Q, P+N],
    response_ids [Q, N], response_mask [Q, N]) plus `gen_stats`, a dict of
    Python numbers with the reference's keys: decode_steps, refills,
    real_tokens, occupancy (real tokens / (decode_steps * slots)),
    truncated, oom_truncated, reclaimed_pages, unserved; free_pages when
    paged, held_pages when refcounted (paged spec decoding), and
    spec_rounds / drafted / accepted with spec decoding. `seed` is the
    base of every draw (per-lane sampling in models/generation.py)."""
    if any(x is not None for x in (warm, q_pin, q_ready, q_rng_row, rng_space)):
        raise NotImplementedError(
            "gen_engine serving mode (warm pools, pins, shared prefixes, request RNG ids) "
            "is not ported yet (ROADMAP queue 11)"
        )
    if spec.data_groups > 1:
        raise NotImplementedError("gen_engine.data_groups > 1 is not ported yet (ROADMAP queue 12)")
    Q, P = q_ids.shape
    N = settings.max_new_tokens
    if N < 1:
        raise ValueError("max_new_tokens must be >= 1")
    cfg = model.cfg
    dev = q_ids.device
    SLOTS = max(1, min(spec.slots, Q))
    PS = spec.page_size
    K = spec.draft_k if spec.spec_decode else 0
    # speculative rounds may draft past a lane's budget before the verify
    # truncates: K slack positions keep those writes in real slots
    MP = paged_kv.pages_per_slot(P, N + K, PS)
    S = MP * PS
    PP = -(-P // PS)  # prompt pages per refill (pads included)
    NP = (spec.pool_pages or (1 + SLOTS * MP)) if spec.paged else (1 + SLOTS * MP)
    if NP < 1 + SLOTS * PP:
        raise ValueError(
            f"pool_pages={NP} cannot hold {SLOTS} slots' prompts ({PP} pages each + null page)"
        )
    R = max(1, min(spec.refill_width or SLOTS, SLOTS))
    quant = spec.kv_quant
    eos, pad = settings.eos_token_id, settings.pad_token_id
    if spec.spec_decode and draft_params is None:
        raise ValueError("spec_decode needs draft_params (the reference)")
    shared = spec.draft_shared_layers if spec.spec_decode else 0
    if shared:
        if not 0 < shared < cfg.n_layer:
            raise ValueError(f"draft_shared_layers={shared} must be in (0, n_layer={cfg.n_layer})")
        KB = cfg.n_layer - shared  # draft branch layers stored past L
        draft_layer_ixs = list(range(shared)) + [cfg.n_layer + i for i in range(KB)]
    else:
        KB = 0
        draft_layer_ixs = None
    pool_layers = cfg.n_layer + KB
    # spec-decode pages are held by both streams (policy and draft): +2 at
    # allocation, two decrements at release
    refcounted = spec.spec_decode and spec.paged

    model = cast_params_for_decode(model, cfg.dtype)
    if draft_params is not None:
        draft_params = cast_params_for_decode(draft_params, cfg.dtype)
    q_ids = q_ids.long()
    q_mask = q_mask.to(torch.int32)
    if row_budget is None:
        row_budget = torch.full((Q,), N, dtype=torch.int64, device=dev)
    row_budget = torch.clamp(row_budget.to(dev).long(), 1, N)

    # RNG id spaces: token draws at r*N + j; acceptance and residual draws
    # in disjoint ranges above them
    OFF_ACC = (Q + 1) * N
    OFF_RES = 2 * (Q + 1) * N
    # the reference's flash prefill rounds its temporary cache to 128 slots;
    # mirrored so both packages compute over equal shapes
    Pc = _round_up(P, 128) if (cfg.attention_impl == "pallas" and P % 8 == 0) else P

    ar_slots = torch.arange(SLOTS, device=dev)
    ar_r = torch.arange(R, device=dev)
    ar_k = torch.arange(K, device=dev)

    def scalar(v: int = 0) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int64, device=dev)

    def init_state() -> Dict[str, Any]:
        state: Dict[str, Any] = {
            "pool": paged_kv.init_pool(pool_layers, NP, PS, cfg.n_kv_head, cfg.head_dim, quant, cfg.dtype, dev)
        }
        if spec.spec_decode and not shared:
            # full-copy draft: nothing is shared, it keeps its own full-depth
            # pool over the same page ids
            state["dpool"] = paged_kv.init_pool(
                cfg.n_layer, NP, PS, cfg.n_kv_head, cfg.head_dim, quant, cfg.dtype, dev
            )
        if spec.paged:
            state["free"], state["ntop"] = paged_kv.init_alloc(NP, dev)
            state["table"] = torch.zeros((SLOTS, MP), dtype=torch.int32, device=dev)
            if refcounted:
                state["refcnt"] = paged_kv.init_refcounts(NP, dev)
        else:
            state["table"] = (1 + torch.arange(SLOTS * MP, dtype=torch.int32, device=dev)).reshape(SLOTS, MP)
        zeros = torch.zeros(SLOTS, dtype=torch.int64, device=dev)
        state.update(
            pos=zeros, npad=zeros, new=zeros, budget=torch.ones_like(zeros),
            active=torch.zeros(SLOTS, dtype=torch.bool, device=dev), pidx=zeros, cur=zeros,
            kmask=torch.zeros((SLOTS, S), dtype=torch.int32, device=dev),
            qnext=scalar(),
            resp_ids=torch.full((Q, N), pad, dtype=torch.int64, device=dev),
            resp_mask=torch.zeros((Q, N), dtype=torch.int32, device=dev),
            decode_steps=scalar(), lane_steps=scalar(), refills=scalar(), emitted=scalar(), truncated=scalar(),
            oom=scalar(), reclaimed=scalar(), rounds=scalar(), drafted=scalar(), accepted=scalar(),
        )
        return state

    def paged_cache(pool, state, slot_pos, key_mask, draft=False) -> Dict[str, Any]:
        cache = dict(pool, page_table=state["table"], slot_pos=slot_pos, key_mask=key_mask,
                     lane_valid=state["active"])
        if not spec.paged:
            cache["contiguous"] = True
        elif spec.paged_attention_impl != "xla":
            cache["attn_impl"] = spec.paged_attention_impl
        if draft and shared:
            # the draft's trunk layers use the policy's trunk slots, its
            # branch layers the extension slots
            cache["layer_ixs"] = draft_layer_ixs
        return cache

    def draft_pool(state):
        return state["pool"] if shared else state["dpool"]

    def note_alloc(state, ids):
        """Fresh pages enter with refcount 2 in spec mode (one hold per stream)."""
        if not refcounted:
            return state
        return dict(state, refcnt=state["refcnt"].index_add(
            0, ids.long(), 2 * (ids > 0).to(torch.int32)))

    def free_slot_pages(state, pages, is_real):
        """Return pages to the free stack; spec mode releases both stream
        holds through the refcounts, so `free + held == pool` balances."""
        if refcounted:
            free, ntop, rc = paged_kv.release_refcounted(
                state["free"], state["ntop"], state["refcnt"], pages, is_real)
            free, ntop, rc = paged_kv.release_refcounted(free, ntop, rc, pages, is_real)
            return dict(state, free=free, ntop=ntop, refcnt=rc)
        free, ntop = paged_kv.push_free(state["free"], state["ntop"], pages, is_real)
        return dict(state, free=free, ntop=ntop)

    def prefill_into_slots(lm, pool, state, ids, mask, posns, slot, do, branch_only=False):
        """Dense prefill of [R, P] prompts into a temporary cache, scattered
        into `slot`'s pages (rows not in `do` write the null page).
        `branch_only` (the trunk-sharing draft) writes just the draft's
        branch layers into the extension slots. Returns the last hidden
        state [R, E]."""
        key_mask = torch.cat([mask, torch.zeros((R, Pc - P), dtype=torch.int32, device=dev)], 1) \
            if Pc != P else mask
        tmp = lm.init_cache(R, Pc, key_mask)
        out = lm(ids, mask, positions=posns, cache=tmp, compute_logits=False)
        ck = out["cache"]["k"][:, :, :P]  # [L, R, P, Hkv, D]
        cv = out["cache"]["v"][:, :, :P]
        lsel = None
        if branch_only:
            ck, cv = ck[cfg.n_layer - KB:], cv[cfg.n_layer - KB:]
            lsel = cfg.n_layer + torch.arange(KB, device=dev)
        elif shared:
            lsel = torch.arange(cfg.n_layer, device=dev)
        tbl = state["table"][slot.clamp(0, SLOTS - 1)]
        prompt_pos = torch.arange(P, device=dev)[None, :].expand(R, P)
        pids, offs = paged_kv.write_positions(tbl, prompt_pos, PS, lane_valid=do)
        if quant == "int8":
            kq, ks = paged_kv.quantize_rows(ck)
            vq, vs = paged_kv.quantize_rows(cv)
            leaves = (("pk", kq), ("pv", vq), ("pk_scale", ks), ("pv_scale", vs))
        else:
            leaves = (("pk", ck), ("pv", cv))
        for name, x in leaves:
            paged_kv.scatter_prefill(pool[name], pids, offs, x, layer_ixs=lsel)
        return out["hidden_states"][:, -1]

    def release_pages(state, lanes):
        """Return `lanes`' pages to the free stack the moment they finish."""
        if not spec.paged:
            return state
        rows = state["table"]
        state = free_slot_pages(state, rows.reshape(-1), lanes.repeat_interleave(MP))
        return dict(state, table=torch.where(lanes[:, None], torch.zeros_like(rows), rows))

    def refill(state):
        active, qnext = state["active"], state["qnext"]
        cand = torch.argsort(active.to(torch.int32), stable=True)[:R]
        navail = torch.minimum(torch.minimum((~active).sum(), Q - qnext), scalar(R))
        if spec.paged:
            navail = torch.minimum(navail, state["ntop"].long() // PP)
        do = ar_r < navail
        slot = torch.where(do, cand, SLOTS)
        qrow = torch.where(do, qnext + ar_r, Q)
        qc = qrow.clamp(0, Q - 1)
        ids, mask = q_ids[qc], q_mask[qc]
        pgrid = torch.arange(PP, device=dev)[None, :]
        if spec.paged:
            # return the refilled slots' old pages, then take fresh prompt pages
            old = state["table"][slot.clamp(0, SLOTS - 1)]
            state = free_slot_pages(state, old.reshape(-1), do.repeat_interleave(MP))
            table = _drop_set(state["table"], slot, 0)
            got, free, ntop = paged_kv.pop_pages(state["free"], state["ntop"], do.repeat_interleave(PP))
            table = _drop_set(table, slot[:, None], got.reshape(R, PP), cols=pgrid)
            state = note_alloc(dict(state, free=free, ntop=ntop, table=table), got)

        posns = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
        h_last = prefill_into_slots(model, state["pool"], state, ids, mask, posns, slot, do)
        if spec.spec_decode:
            prefill_into_slots(draft_params, draft_pool(state), state, ids, mask, posns, slot, do,
                               branch_only=bool(shared))

        if spec.paged:
            # prompt-pad page compaction: a prompt page holding only pad KV
            # is never read under the key mask again: release it now
            mask_pp = torch.cat([mask, torch.zeros((R, PP * PS - P), dtype=torch.int32, device=dev)], 1) \
                if PP * PS != P else mask
            page_has_real = mask_pp.reshape(R, PP, PS).sum(2) > 0
            rows_tbl = state["table"][slot.clamp(0, SLOTS - 1)][:, :PP]
            dead = ~page_has_real & do[:, None] & (rows_tbl > 0)
            state = free_slot_pages(state, rows_tbl.reshape(-1), dead.reshape(-1))
            table = _drop_set(state["table"], slot[:, None], torch.where(dead, 0, rows_tbl), cols=pgrid)
            state = dict(state, table=table, reclaimed=state["reclaimed"] + dead.sum())

        logits0 = logit_projection(model)(h_last)
        tok0 = sample_token_lanes(lane_keys(seed, qc * N), logits0, settings)
        bud = row_budget[qc]
        eos0 = tok0 == eos
        fin0 = eos0 | (bud <= 1)
        npad = P - mask.sum(1).long()
        state = dict(
            state,
            pos=_drop_set(state["pos"], slot, P),
            npad=_drop_set(state["npad"], slot, npad),
            new=_drop_set(state["new"], slot, 1),
            budget=_drop_set(state["budget"], slot, bud),
            active=_drop_set(state["active"], slot, ~fin0),
            pidx=_drop_set(state["pidx"], slot, qc),
            cur=_drop_set(state["cur"], slot, tok0),
            kmask=_drop_set(state["kmask"], slot, torch.cat(
                [mask, torch.zeros((R, S - P), dtype=torch.int32, device=dev)], 1)),
            resp_ids=_drop_set(state["resp_ids"], qrow, tok0, cols=0),
            resp_mask=_drop_set(state["resp_mask"], qrow, 1, cols=0),
            qnext=qnext + navail,
            refills=state["refills"] + navail,
            emitted=state["emitted"] + navail,
            truncated=state["truncated"] + (do & fin0 & ~eos0).sum(),
        )
        # lanes that finish at refill (instant EOS / budget 1) release their
        # fresh pages at once, or idle lanes could park every page and the
        # refill gate would close the queue
        fin_lanes = _drop_set(torch.zeros(SLOTS, dtype=torch.bool, device=dev), slot, do & fin0)
        return release_pages(state, fin_lanes)

    def ensure_page(state, position):
        """Lazy response-page allocation for each active lane's write at
        `position` [SLOTS]; lanes the pool cannot serve are force-finished
        (counted as oom_truncated)."""
        if not spec.paged:
            return state
        active = state["active"]
        pi = torch.clamp(torch.div(position, PS, rounding_mode="floor"), 0, MP - 1)
        have = torch.gather(state["table"], 1, pi[:, None])[:, 0]
        miss = active & (have == 0)
        got, free, ntop = paged_kv.pop_pages(state["free"], state["ntop"], miss)
        table = state["table"].clone()
        table[ar_slots, pi] = torch.where(miss & (got > 0), got, have)
        starve = miss & (got == 0)
        n_starve = starve.sum()
        state = note_alloc(dict(
            state, free=free, ntop=ntop, table=table, active=active & ~starve,
            oom=state["oom"] + n_starve, truncated=state["truncated"] + n_starve,
        ), got)
        return release_pages(state, starve)

    def decode_step(state):
        state = ensure_page(state, state["pos"])
        active = state["active"]
        p = state["pos"].clamp(0, S - 1)
        km = state["kmask"].clone()
        km[ar_slots, p] = torch.maximum(km[ar_slots, p], active.to(torch.int32))
        cache = paged_cache(state["pool"], state, p, km)
        out = model(state["cur"][:, None], positions=torch.clamp(p - state["npad"], min=0)[:, None],
                    cache=cache)
        j = state["new"].clamp(0, N - 1)
        tok = sample_token_lanes(lane_keys(seed, state["pidx"] * N + j), out["logits"][:, -1], settings)
        eos_hit = tok == eos
        budget_hit = state["new"] + 1 >= state["budget"]
        fin = eos_hit | budget_hit
        wrow = torch.where(active, state["pidx"], Q)
        na = active.sum()
        state = dict(
            state,
            kmask=km,
            resp_ids=_drop_set(state["resp_ids"], wrow, tok, cols=j),
            resp_mask=_drop_set(state["resp_mask"], wrow, 1, cols=j),
            pos=state["pos"] + active,
            new=state["new"] + active,
            cur=torch.where(active, tok, state["cur"]),
            active=active & ~fin,
            decode_steps=state["decode_steps"] + 1,
            lane_steps=state["lane_steps"] + na,
            emitted=state["emitted"] + na,
            truncated=state["truncated"] + (active & budget_hit & ~eos_hit).sum(),
        )
        return release_pages(state, active & fin)

    def spec_round(state):
        # pages for the whole draft window [pos, pos + K)
        for j in range(K):
            state = ensure_page(state, state["pos"] + j)
        active = state["active"]
        p = state["pos"].clamp(0, S - K)
        window = p[:, None] + ar_k[None, :]
        km = state["kmask"].clone()
        km[ar_slots[:, None], window] = torch.maximum(
            km[ar_slots[:, None], window], active.to(torch.int32)[:, None].expand(SLOTS, K))
        base_pos = torch.clamp(p - state["npad"], min=0)
        rid = state["pidx"] * N + state["new"]

        # draft: K single-token steps off the reference
        dpool = draft_pool(state)
        tok_in, xs, qprobs = state["cur"], [], []
        for j in range(K):
            cache = paged_cache(dpool, state, p + j, km, draft=True)
            out = draft_params(tok_in[:, None], positions=(base_pos + j)[:, None], cache=cache)
            ql = process_logits(out["logits"][:, -1], settings)
            if settings.do_sample:
                x = torch.argmax(ql + lane_gumbel(lane_keys(seed, rid + j), ql.shape[-1]), dim=-1)
            else:
                x = torch.argmax(ql, dim=-1)
            xs.append(x)
            qprobs.append(torch.softmax(ql, dim=-1))
            tok_in = x
        xs = torch.stack(xs, dim=1)  # [SLOTS, K]

        # verify: ONE policy forward over the K drafted inputs (on the
        # post-draft pool: with trunk sharing the draft has written its
        # branch layers there, and its trunk writes equal the verify's)
        ver_in = torch.cat([state["cur"][:, None], xs[:, : K - 1]], dim=1)
        cache = paged_cache(state["pool"], state, p, km)
        out = model(ver_in, positions=base_pos[:, None] + ar_k[None, :], cache=cache)
        pprobs = torch.softmax(process_logits(out["logits"], settings), dim=-1)  # [SLOTS, K, V]

        # rejection sampling: the marginal of every emitted token is the
        # policy's
        still = active
        fin = torch.zeros_like(active)
        m = torch.zeros_like(state["pos"])
        last = state["cur"]
        resp_ids, resp_mask = state["resp_ids"], state["resp_mask"]
        truncated, drafted = state["truncated"], state["drafted"]
        accepted, emitted = state["accepted"], state["emitted"]
        for j in range(K):
            xj, pj, qj = xs[:, j], pprobs[:, j], qprobs[j]
            if settings.do_sample:
                u = lane_uniform(lane_keys(seed, OFF_ACC + rid + j), 1)[:, 0]
                px = torch.gather(pj, 1, xj[:, None])[:, 0]
                qx = torch.gather(qj, 1, xj[:, None])[:, 0]
                acc = u * qx <= px
                res = torch.clamp(pj - qj, min=0.0)
                rs = res.sum(dim=-1, keepdim=True)
                res = torch.where(rs > 1e-12, res / torch.clamp(rs, min=1e-30), pj)
                tok_rej = categorical_lanes(lane_keys(seed, OFF_RES + rid + j), res)
            else:
                am = torch.argmax(pj, dim=-1)
                acc = xj == am
                tok_rej = am
            tok = torch.where(acc, xj, tok_rej)
            emit = still
            wrow = torch.where(emit, state["pidx"], Q)
            wcol = (state["new"] + j).clamp(0, N - 1)
            resp_ids = _drop_set(resp_ids, wrow, tok, cols=wcol)
            resp_mask = _drop_set(resp_mask, wrow, 1, cols=wcol)
            eos_hit = tok == eos
            budget_hit = state["new"] + j + 1 >= state["budget"]
            fin_now = emit & (eos_hit | budget_hit)
            m = m + emit
            last = torch.where(emit, tok, last)
            truncated = truncated + (fin_now & ~eos_hit).sum()
            drafted = drafted + emit.sum()
            accepted = accepted + (emit & acc).sum()
            emitted = emitted + emit.sum()
            still = still & acc & ~fin_now
            fin = fin | fin_now

        # the draft window keeps only consumed inputs attendable: the first
        # m positions; stale slots of rejected drafts are cleared
        keep = (ar_k[None, :] < m[:, None]) & active[:, None]
        km[ar_slots[:, None], window] = keep.to(torch.int32)
        state = dict(
            state,
            kmask=km, resp_ids=resp_ids, resp_mask=resp_mask,
            pos=state["pos"] + m, new=state["new"] + m, cur=last,
            active=active & ~fin,
            decode_steps=state["decode_steps"] + K + 1,
            lane_steps=state["lane_steps"] + (K + 1) * active.sum(),
            rounds=state["rounds"] + 1,
            emitted=emitted, truncated=truncated, drafted=drafted, accepted=accepted,
        )
        return release_pages(state, active & fin)

    step_fn = spec_round if spec.spec_decode else decode_step

    def can_refill(state) -> torch.Tensor:
        ok = (~state["active"]).any() & (state["qnext"] < Q)
        if spec.paged:
            ok = ok & (state["ntop"] >= PP)
        return ok

    state = init_state()
    while True:
        # the loop's cond and the body's refill flag, in one read
        any_active, need = torch.stack([state["active"].any(), can_refill(state)]).tolist()
        if not (any_active or need):
            break
        if need:
            state = refill(state)
            # refilling never retires a lane that was live, so only an
            # iteration that began idle needs to ask again
            if not any_active and not bool(state["active"].any()):
                continue
        state = step_fn(state)

    resp_ids = torch.where(state["resp_mask"] > 0, state["resp_ids"], torch.full_like(state["resp_ids"], pad))
    names = ["decode_steps", "refills", "emitted", "lane_steps", "truncated", "oom", "reclaimed", "qnext"]
    if spec.paged:
        names.append("ntop")
    if spec.spec_decode:
        names += ["rounds", "drafted", "accepted"]
    held = [(state["refcnt"] > 0).sum()] if refcounted else []
    host = torch.stack([state[n].long() for n in names] + held).tolist()
    got = dict(zip(names, host))
    stats: Dict[str, Any] = {
        "decode_steps": got["decode_steps"],
        "refills": got["refills"],
        "real_tokens": got["emitted"],
        "occupancy": got["lane_steps"] / (max(got["decode_steps"], 1) * SLOTS),
        "truncated": got["truncated"],
        "oom_truncated": got["oom"],
        "reclaimed_pages": got["reclaimed"],
        "unserved": Q - got["qnext"],
    }
    if spec.paged:
        # with every lane finished: free_pages == pool - 1 (the null page)
        stats["free_pages"] = got["ntop"]
    if refcounted:
        # free_pages + held_pages + 1 == pool, always
        stats["held_pages"] = host[-1]
    if spec.spec_decode:
        stats.update(spec_rounds=got["rounds"], drafted=got["drafted"], accepted=got["accepted"])
    return {
        "sequences": torch.cat([q_ids, resp_ids], dim=1),
        "response_ids": resp_ids,
        "response_mask": state["resp_mask"],
        "gen_stats": stats,
    }


def engine_generate_grouped(
    model: TransformerLM,
    q_ids: torch.Tensor,
    q_mask: torch.Tensor,
    seed: int,
    settings: SamplerSettings,
    spec: EngineSpec,
    draft_params: Optional[nn.Module] = None,
    row_budget: Optional[torch.Tensor] = None,
    group_sharding=None,
) -> Dict[str, Any]:
    """The engine as `spec.data_groups` independent lane groups. One group
    passes straight through to `engine_generate`; more are ROADMAP queue 12."""
    if spec.data_groups > 1 or group_sharding is not None:
        raise NotImplementedError("gen_engine.data_groups > 1 is not ported yet (ROADMAP queue 12)")
    return engine_generate(model, q_ids, q_mask, seed, settings, spec,
                           draft_params=draft_params, row_budget=row_budget)


def make_engine_fn(model: TransformerLM, settings: SamplerSettings, spec: EngineSpec):
    """`(q_ids, q_mask, seed, draft_params=None, row_budget=None) -> outputs`
    engine closure over the model (its parameters are read at call time)."""

    def fn(q_ids, q_mask, seed, draft_params=None, row_budget=None):
        return engine_generate_grouped(model, q_ids, q_mask, seed, settings, spec,
                                       draft_params=draft_params, row_budget=row_budget)

    return fn
