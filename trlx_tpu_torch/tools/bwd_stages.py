"""Where the fused attention backward kernels, the short-route flash and
bias forwards and both routes of the paged and int8 decode kernels spend
their time.

    python3 -m trlx_tpu_torch.tools.bwd_stages [--kernel bias|plain|fwd|bias_fwd|paged|decode|all] [--seed N] [--out FILE]

Builds variants of a kernel's source that return after each of its
stages, and one without its register bounds, into `build/stages/`, then
times each on the card at the shapes of the paths that run it, as
`chip_smoke.py` times kernels: median device time of one call by CUDA
events, the L2 flushed before each. A stage's cost is the difference
between the cut after it and the cut before it; the cut "start" is an
empty kernel with the same launch. Each variant's CTAs an SM come from
the CUDA occupancy API.

- `bias`: `flash_bias_bwd_fused_kernel` of `csrc/flash_bias_bwd.cu`
  (stages: operand loads, the query-major phase, the key-major phase, the
  arrival, the dbias sum) at T5's shapes (B12 H12 D64: the encoder's
  T = S = 32, the decoder's T = S = 65, causal);
- `plain`: `flash_bwd_fused_kernel` of `csrc/flash_bwd.cu` (stages:
  operand loads, the query-major phase, the key-major phase) at GPT-2's
  train shape (B32 H12 D64, T = S = 64, causal) and T5's cross-attention
  (B12 H12, T = 65 queries over S = 32 keys, not causal, scale 1);
- `fwd`: `flash_fwd_short_kernel` of `csrc/flash_fwd.cu` (stages: the
  loads of Q, the mask row, K and V; the scores and softmax with the m
  and l writes; P V with the output writes) at the rollout path's
  teacher-forced shape (B64 H12 D64, T = S = 72, causal) and GPT-2's
  train shape (B32 H12, T = S = 64, causal);
- `bias_fwd`: `flash_bias_fwd_short_kernel` of `csrc/flash_bias_fwd.cu`
  (stages: the mask row and its ballot, with Q and the bias tile, issued
  while the mask arrives, landed; K; V; the scores plus the bias and the
  softmax with the m and l writes; P V with the output writes) at T5's
  encoder (B12 H12 D64, T = S = 32), decoder (T = S = 65, causal) and the
  T5 path's B64 decoder shape, and one (b, h) alone at the decoder's
  lengths (`decoder_one_cta`: one CTA's latency), with three whole-kernel
  variants: `ballot_first` (Q and the bias tile issued after the ballot,
  not while the mask row arrives), `paired_strips` (past four causal
  strips, or six, warps take two strips each, as the short flash forward
  does) and `no_bias` (the bias tile neither read nor added);
- `paged` (or either half alone, `paged_long` / `paged_short`): both
  kernels of `csrc/paged_attention.cu` at the engine's shapes in the
  training workload (32 lanes, H12 D64, 16-token int8 pages, 5 pages a
  lane, ragged depths 33-75): the decode step (T = 1) and the speculative
  verify (T = 4). `paged_attention_kernel`, the long route (stages: the
  query rows into shared memory; the scores of the first 128-slot chunk:
  table, K rows, scales, bias; the online-softmax update; P V with the
  output writes); `paged_attention_short_kernel`, the short route
  (stages: the table, query rows and bias rows; the K and V burst; the
  scores with their row maxima; the softmax; P V with the output
  writes). The timed call is the kernel's wrapper on
  the same inputs for both;
- `decode` (or either half alone, `decode_long` / `decode_short`): both
  kernels of `csrc/decode_int8.cu` at the rollout path's shape (L12 B64
  H12 D64, a 128-slot cache, 72 slots written, random left pads of up to
  35 slots, layer 5 attended). `decode_int8_kernel`, the long route
  (stages: the query rows into shared memory; the scores of the first
  128-slot chunk: mask, K rows, K scales; the online-softmax update; P V
  with the output writes); `decode_int8_short_kernel`, the short route
  (stages: trip 1, the q, mask, K-scale and V-scale rows; the mask
  ballot; the K and V burst; the scores with their row maxima; the
  softmax; P V with the output writes), and three whole-kernel variants
  whose results are not checked: `burst_issue_only` (every burst copy
  zero-filled: the burst's issue without its bytes), `burst_none` (no
  burst: the rest of the kernel without its loads) and `tma_burst` (the
  burst as one `cp.async.bulk` copy a run of slots, on mbarriers). The
  timed call is the route's wrapper on the same inputs for both.

Prints one JSON line per (kernel, shape, variant) and the card's name and
power limit; `--out` writes the lines too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

# each variant runs `cut` (by default a return) just before the text its
# stage names (every thread of the CTA, so no barrier waits)
START = "  const int TP = (T + 15) & ~15;\n  const int n_strips"
RETURN = "  if (true) return;\n"
DECODE_KEEP = ("  if (S < 0) out[tid] = __float2bfloat16_rn(q_s[0][tid % D] + p_s[0][tid] + l_s[0]);\n"
               + RETURN)
# The short decode kernel's K/V burst by the Tensor Memory Accelerator: one
# thread for K and one for V issue a bulk copy (cp.async.bulk) for each run
# of consecutive slots that takes weight (split at 32-slot words), each
# completing on its own mbarrier; the masked slots inside the span are left
# unwritten (a product with them is discarded or weighed 0).
DECODE_TMA_HELPERS = r"""__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// a wait that never ends traps instead (after about a second)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile("{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\nselp.u32 %0, 1, 0, P1;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (i > (1 << 20)) __trap();
  }
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

"""
DECODE_TMA_INIT = r"""  const uint32_t kbar = static_cast<uint32_t>(__cvta_generic_to_shared(smem + at.bits + SHORT_SLOTS / 8));
  const uint32_t vbar = kbar + 8;
  if (tid == 0) {
    mbar_init(kbar, 1);
    mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
"""
DECODE_TMA_BURST = r"""  if (tid == 0 || tid == 32) {
    const bool is_v = tid == 32;
    const uint32_t bar = is_v ? vbar : kbar;
    const uint32_t dst0 = static_cast<uint32_t>(__cvta_generic_to_shared(is_v ? v_s : k_s));
    const int8_t* src0 = is_v ? vb : kb;
    int total = 0;
    for (int w = lo >> 5; w <= (hi - 1) >> 5; ++w) {
      const unsigned bits = (is_v && !any) ? (S >= (w + 1) * 32 ? ~0u : (S <= w * 32 ? 0u : (1u << (S - w * 32)) - 1u))
                                           : bits_s[w];
      total += __popc(bits);
    }
    mbar_expect_tx(bar, total * HD);
    for (int w = lo >> 5; w <= (hi - 1) >> 5; ++w) {
      const unsigned bits = (is_v && !any) ? (S >= (w + 1) * 32 ? ~0u : (S <= w * 32 ? 0u : (1u << (S - w * 32)) - 1u))
                                           : bits_s[w];
      unsigned starts = bits & ~(bits << 1), ends = bits & ~(bits >> 1);
      while (starts != 0u) {
        const int s0 = __ffs(starts) - 1, e0 = __ffs(ends) - 1;
        starts &= starts - 1u;
        ends &= ends - 1u;
        const int j = w * 32 + s0;
        bulk_g2s(dst0 + j * HD, src0 + static_cast<long long>(j) * HD, (e0 - s0 + 1) * HD, bar);
      }
    }
  }
"""
DECODE_CP_ASYNC_BURST = """  for (int x = lo * NPC + tid; x < hi * NPC; x += SNT) {
    const int j = x / NPC;
    const bool att = (bits_s[j >> 5] >> (j & 31)) & 1u;
    cp_async16(&k_s[x], kb + (att ? x * 16 : 0), att);
  }
  cp_async_commit();
  for (int x = lo * NPC + tid; x < hi * NPC; x += SNT) {
    const int j = x / NPC;
    const bool need = any ? ((bits_s[j >> 5] >> (j & 31)) & 1u) != 0u : j < S;
    cp_async16(&v_s[x], vb + (need ? x * 16 : 0), need);
  }
  cp_async_commit();
"""
DECODE_SHORT_BOUNDS = "__launch_bounds__(SNT, REP == 1 ? (HD == 64 ? 8 : 6) : (REP <= 3 ? 4 : 2))"
DECODE_TMA = [
    ("  o += SHORT_SLOTS / 8;\n", "  o += SHORT_SLOTS / 8 + 16;\n"),
    ("template <int REP, int HD>\n__global__ void " + DECODE_SHORT_BOUNDS,
     DECODE_TMA_HELPERS + "template <int REP, int HD>\n__global__ void " + DECODE_SHORT_BOUNDS),
    ("  for (int x = tid; x < HD / 4; x += SNT) cp_async16(&vs_s[4 * x]",
     DECODE_TMA_INIT + "  for (int x = tid; x < HD / 4; x += SNT) cp_async16(&vs_s[4 * x]"),
    (DECODE_CP_ASYNC_BURST, DECODE_TMA_BURST),
    ("  cp_async_wait_group<1>();\n  __syncthreads();\n  float mx[REP];", "  mbar_wait(kbar, 0);\n  float mx[REP];"),
    ("  cp_async_wait_group<0>();\n  __syncthreads();\n  const int c4", "  mbar_wait(vbar, 0);\n  __syncthreads();\n  const int c4"),
]

# the short bias forward's ballot, which `ballot_first` moves ahead of the
# Q and bias copies
BIAS_FWD_BALLOT = """  // 3. the ballot
  unsigned bits[NW];  // bit r of word w: slot 32 w + r is attendable
  int first = S;      // the first attendable slot (S: none)
#pragma unroll
  for (int w = NW - 1; w >= 0; --w) {
    bits[w] = __ballot_sync(0xffffffffu, w * 32 + lane < S && mk[w] > 0);
    if (bits[w] != 0u) first = w * 32 + __ffs(bits[w]) - 1;
  }
  // rows fully masked (every score -1e30) are the first ones: row t is when
  // no slot is attendable, or when causal and t < first
  const bool any_dead = first >= S || (causal && first > 0);

"""
BIAS_FWD_Q_BIAS = "  // 2. while it arrives: Q (zero-filled past T)"
# paired_strips: past four causal strips (six without causality) ceil(n/2)
# warps take the strips in pairs, as flash_fwd_short_kernel does: warp w
# strip n-1-w, then strip n-2W+w after the barrier that waits for V
BIAS_FWD_PAIRS = "(n_strips <= 4 || (!causal && n_strips <= 6) ? n_strips : (n_strips + 1) / 2)"
BIAS_FWD_PAIRED = [
    ("  const int nthreads = 2 * TP;  // a warp a 16-row strip\n",
     f"  const int n_strips = TP / 16;\n  const int W = {BIAS_FWD_PAIRS};\n  const int nthreads = 32 * W;\n"),
    ("  // 6. the strip of warp w: rows 16 w..\n  const int r_base = warp * 16;\n",
     "  for (int pass = 0; pass < 2; ++pass) {\n  const int st = pass == 0 ? n_strips - 1 - warp : n_strips - 2 * W + warp;\n"
     "  if (st < 0) continue;\n  const int r_base = st * 16;\n"),
    ("  cp_async_wait_all();\n  __syncthreads();  // V is in shared memory (and every Q fragment read)\n",
     "  if (pass == 0) {\n    cp_async_wait_all();\n    __syncthreads();\n  }\n  __syncwarp();\n"),
    ("          *reinterpret_cast<const uint4*>(&o_s[row * LDS + col]);\n    }\n  }\n}\n",
     "          *reinterpret_cast<const uint4*>(&o_s[row * LDS + col]);\n    }\n  }\n  }\n}\n"),
    ("inline int short_threads(int T) { return 2 * ((T + 15) & ~15); }",
     f"inline int short_threads(int T, int causal) {{\n  const int n_strips = ((T + 15) & ~15) / 16;\n"
     f"  return 32 * {BIAS_FWD_PAIRS};\n}}"),
    ("<<<B * H, short_threads(T),", "<<<B * H, short_threads(T, causal),"),
    ("int short_occupancy(int T, int S, int* ctas_per_sm,", "int short_occupancy(int T, int S, int causal, int* ctas_per_sm,"),
    ("  *threads = short_threads(T);", "  *threads = short_threads(T, causal);"),
    ("short_occupancy<NK>(T, S, ctas_per_sm,", "short_occupancy<NK>(T, S, causal, ctas_per_sm,"),
]
# no_bias: the bias tile neither read (its copies zero-filled) nor added
BIAS_FWD_NO_BIAS = [
    ("    cp_async4(&b_s[mis + e], bb + e, true);", "    cp_async4(&b_s[mis + e], bb + e, false);"),
    ("cp_async16(&b_s[mis + head + 4 * i], bb + head + 4 * i, true);",
     "cp_async16(&b_s[mis + head + 4 * i], bb + head + 4 * i, false);"),
    ("s[n][e] = s[n][e] * sm_scale + brow[e >> 1][n * 8 + c * 2 + (e & 1)];", "s[n][e] = s[n][e] * sm_scale;"),
    ("x = s[n][e] * sm_scale + brow[e >> 1][col];", "x = s[n][e] * sm_scale;"),
]

KERNELS = {
    "bias": dict(
        source="flash_bias_bwd.cu",
        stages=(("start", START), ("loads", "  // 2a. query-major"), ("query_major", "  // 2b. key-major"),
                ("key_major", "  // 3. dbias: the last")),
        # the arrival without the dbias sum: the last CTA resets its counter
        extra={"arrival": ("  if (!last_s) return;\n  __threadfence();\n",
                           "  if (!last_s) return;\n  if (tid == 0) arrivals[h] = 0;\n  return;\n")},
        bounds="__launch_bounds__(NK == 5 ? 192 : (NK > 4 ? 32 * NK : 128), NK <= 5 ? 2 : 1)",
        shapes={"encoder": (12, 12, 32, 32, False), "decoder": (12, 12, 65, 65, True)},  # B, H, T, S, causal
    ),
    "plain": dict(
        source="flash_bwd.cu",
        stages=(("start", START), ("loads", "    // 2a. query-major"), ("query_major", "    // 2b. key-major")),
        extra={},
        bounds=("__launch_bounds__(NK == 5 ? 192 : (NK > 4 ? 32 * NK : 128),\n"
                "                                  D == 64 ? (NK <= 4 ? 3 : (NK == 5 ? 2 : 1)) : (NK <= 4 ? 2 : 1))"),
        shapes={"train": (32, 12, 64, 64, True), "t5_cross": (12, 12, 65, 32, False)},
    ),
    "fwd": dict(
        source="flash_fwd.cu",
        # the loads cut waits for every copy; the softmax cut ends each strip
        # after its m and l writes and the wait for V
        stages=(("start", START), ("loads", "  // 3. the strips", "  cp_async_wait_all();\n" + RETURN),
                ("softmax", "    // 4. O = P V", "    if (true) continue;\n")),
        extra={},
        bounds="__launch_bounds__(NK <= 5 ? 192 : 256, D == 64 ? (NK <= 4 ? 4 : (NK == 5 ? 3 : 2)) : 2)",
        shapes={"teacher_forced": (64, 12, 72, 72, True), "train": (32, 12, 64, 64, True)},
    ),
    "bias_fwd": dict(
        source="flash_bias_fwd.cu",
        # copies in flight are waited for before a cut returns; the mask cut
        # keeps the ballot (first is never < 0); the softmax cut ends each
        # strip after its m and l writes and the wait for V
        stages=(("start", "  // 1. the mask row, at clamped addresses"),
                ("mask", "  // 4. K of the attendable slots",
                 "  cp_async_wait_all();\n  if (first < 0) m_out[0] = 0.f;\n" + RETURN),
                ("k", "  // 5. V of the slots K was read for", "  cp_async_wait_all();\n" + RETURN),
                ("v", "  // 6. the strip of warp w", "  cp_async_wait_all();\n" + RETURN),
                ("softmax", "  // 7. O = P V, a half")),
        extra={"ballot_first": [(BIAS_FWD_BALLOT, ""), (BIAS_FWD_Q_BIAS, BIAS_FWD_BALLOT + BIAS_FWD_Q_BIAS)],
               "paired_strips": BIAS_FWD_PAIRED, "no_bias": BIAS_FWD_NO_BIAS},
        bounds="__launch_bounds__(256, NK <= 5 ? 2 : 1)",
        # decoder_one_cta: one (b, h) alone, the latency of one CTA's path
        shapes={"encoder": (12, 12, 32, 32, False), "decoder": (12, 12, 65, 65, True),
                "b64_decoder": (64, 12, 65, 65, True), "decoder_one_cta": (1, 1, 65, 65, True)},
    ),
    "paged_long": dict(
        source="paged_attention.cu",
        stages=(("start", "  // the group's query rows: row r"),
                ("q_loaded", "  for (int c0 = 0; c0 < S; c0 += NT) {"),
                ("scores", "    // online-softmax update:"), ("softmax", "    // P.V: thread (half, d_own)")),
        extra={},
        bounds=None,
        shapes={"decode": (32, 1, 12, 16, 5), "verify": (32, 4, 12, 16, 5)},  # B, T, H, PS, MP
    ),
    "paged_short": dict(
        source="paged_attention.cu",
        # copies still in flight are waited for before a cut returns
        stages=(("start", "  // 1. loads that depend on nothing"),
                ("q_loaded", "  // 2. one burst"),
                ("kv_loaded", "  // 3. scores once K is in", "  cp_async_wait_all();\n" + RETURN),
                ("scores", "  // 4. softmax", "  cp_async_wait_all();\n" + RETURN),
                ("softmax", "  // 5. P.V", "  cp_async_wait_all();\n" + RETURN)),
        extra={},
        bounds="__launch_bounds__(SNT, RMAX <= 8 ? 4 : 3)",
        shapes={"decode": (32, 1, 12, 16, 5), "verify": (32, 4, 12, 16, 5)},
    ),
    "decode_long": dict(
        source="decode_int8.cu",
        # stores to static shared memory that nothing reads are deleted
        # with the loads that feed them: each cut keeps them (S is never < 0)
        stages=(("start", "  for (int i = tid; i < REP * D; i += NT) {  // rows past `rows` are zero\n    q_s[i / D][i % D]"),
                ("q_loaded", "  for (int c0 = 0; c0 < S; c0 += NT) {", DECODE_KEEP),
                ("scores", "    // online-softmax update: warp w owns rows", DECODE_KEEP),
                ("softmax", "    // P.V: thread (sg, piece) accumulates", DECODE_KEEP)),
        extra={},
        bounds=None,
        shapes={"rollout": (64, 12, 128, 72)},  # B, H, S, written
    ),
    "decode_short": dict(
        source="decode_int8.cu",
        # copies still in flight are waited for before a cut returns
        stages=(("start", "  // 1. trip 1: q rows"),
                ("trip1", "  // 2. the mask ballot"),
                ("mask", "  // 3. the K/V burst"),
                ("kv_loaded", "  // 4. scores once K is in", "  cp_async_wait_all();\n" + RETURN),
                ("scores", "  // 5. softmax over the whole row", "  cp_async_wait_all();\n" + RETURN),
                ("softmax", "  // 6. P.V once V is in", "  cp_async_wait_all();\n" + RETURN)),
        # burst_issue_only: every burst copy zero-filled, the burst's issue
        # without its bytes; burst_none: no burst at all (both timing
        # variants, their results wrong); tma_burst: the burst by bulk copies
        extra={"burst_issue_only": [("cp_async16(&k_s[x], kb + (att ? x * 16 : 0), att);", "cp_async16(&k_s[x], kb, false);"),
                                    ("cp_async16(&v_s[x], vb + (need ? x * 16 : 0), need);", "cp_async16(&v_s[x], vb, false);")],
               "burst_none": (DECODE_CP_ASYNC_BURST, ""),
               "tma_burst": DECODE_TMA},
        bounds=DECODE_SHORT_BOUNDS,
        shapes={"rollout": (64, 12, 128, 72)},
    ),
}
GROUPS = {"paged": ("paged_long", "paged_short"), "decode": ("decode_long", "decode_short")}


def variants(src: str, kernel: dict) -> dict:
    """{name: source} for every cut, the whole kernel and the unbounded one."""

    def patched(old: str, new: str, text: str = src) -> str:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in {kernel['source']}: {old!r}")
        return text.replace(old, new)

    out = {name: patched(anchor, (cut[0] if cut else RETURN) + anchor) for name, anchor, *cut in kernel["stages"]}
    for name, patches in kernel["extra"].items():  # one (old, new) pair, or a list of them
        text = src
        for old, new in patches if isinstance(patches, list) else [patches]:
            text = patched(old, new, text)
        out[name] = text
    out["whole"] = src
    if kernel["bounds"] is not None:
        out["whole_unbounded_registers"] = patched(kernel["bounds"], "__launch_bounds__(256)")
    return out


def build(sources: dict, out_dir: Path) -> dict:
    from trlx_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def paged_call(kind: str, gen, B, T, H, PS, MP):
    """(the paged kernel's wrapper call, its occupancy query) on an int8
    pool of 12 layers (layer 5 attended) whose lanes hold ragged depths
    33..MP*PS-5 before the step's T tokens: the first third of a lane (at
    most PS + 2 slots) left padding, its pages past the depth null, the
    step's tokens causal among themselves, as the engine lays them out."""
    import torch

    from trlx_tpu_torch.ops import decode_attention as da
    from trlx_tpu_torch.ops import paged_kv

    S, D = MP * PS, 64
    depths = torch.randint(33, S - 4, (B,), generator=gen, device="cuda")
    pad = torch.clamp(depths // 3, max=PS + 2)
    pools = paged_kv.init_pool(12, 1 + B * MP, PS, H, D, "int8", torch.bfloat16, "cuda")
    for name in ("pk", "pv"):
        pools[name].copy_(torch.randint(-127, 128, pools[name].shape, generator=gen, device="cuda"))
    for name in ("pk_scale", "pv_scale"):
        pools[name].copy_(torch.rand(pools[name].shape, generator=gen, device="cuda") * 0.02)
    table = (1 + torch.arange(B * MP, device="cuda")).reshape(B, MP)
    table[torch.arange(MP, device="cuda")[None, :] >= ((depths + T + PS - 1) // PS)[:, None]] = 0
    slots = torch.arange(S, device="cuda")
    q_slots = depths[:, None] + torch.arange(T, device="cuda")[None, :]
    visible = (slots[None, None, :] <= q_slots[:, :, None]) & (slots[None, None, :] >= pad[:, None, None])
    bias = torch.where(visible, 0.0, -1e9)[:, None].float().contiguous()
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    table = table.to(torch.int32).contiguous()
    route = kind.split("_")[1]
    fn = da.paged_attention_short if route == "short" else da.paged_attention_long
    return (lambda: fn(q, pools, 5, table, bias, D ** -0.5),
            lambda: da.paged_attention_occupancy(route, T, H, H, PS, MP, True))


def decode_call(kind: str, gen, B, H, S, written):
    """(the int8 decode kernel's wrapper call, its occupancy query) on a
    12-layer int8 cache of S slots (layer 5 attended) whose rows hold
    `written` slots after a random left pad of fewer than written / 2, as
    `chip_smoke.py`'s decode rows lay them out."""
    import torch

    from trlx_tpu_torch.ops import decode_attention as da

    L, D = 12, 64
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    ck, cv = (torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device="cuda").to(torch.int8)
              for _ in range(2))
    ks = torch.rand((L, B, H, 1, S), generator=gen, device="cuda") * 0.02
    vs = torch.rand((B, H, 1, D), generator=gen, device="cuda") * 0.02
    pad = torch.randint(0, written // 2, (B,), generator=gen, device="cuda")
    slots = torch.arange(S, device="cuda")[None, :]
    mask = ((slots >= pad[:, None]) & (slots < written)).to(torch.int32)
    route = kind.split("_")[1]
    fn = da.decode_attention_int8_short if route == "short" else da.decode_attention_int8_long
    return (lambda: fn(q, ck, cv, ks, vs, mask, 5, D ** -0.5),
            lambda: da.decode_attention_int8_occupancy(route, H, H, S))


def fused_call(kind: str, gen, B, H, T, S, causal):
    """(the kernel's wrapper call on seeded inputs, its occupancy query):
    `bias` and `bias_fwd` with a right-padded key mask and an fp32 bias,
    `plain` with a left-padded key mask (at the default causal offset
    S - T), `fwd` with the inputs of `chip_smoke.py`'s forward rows (a
    left-padded key mask, batch row 0 wholly padded)."""
    import torch

    from trlx_tpu_torch.ops import flash_attention as fa

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")

    q, g = (randn(B, H, T, 64).to(torch.bfloat16) for _ in range(2))
    k, v = (randn(B, H, S, 64).to(torch.bfloat16) for _ in range(2))
    slots = torch.arange(S, device="cuda")[None, :]
    if kind == "fwd":
        pad = torch.randint(0, T // 2 + 1, (B,), generator=gen, device="cuda")
        pad[0] = T
        mask = (slots >= S - T + pad[:, None]).to(torch.int32)
        km = fa._check_inputs(q, k, v, mask)
        return (lambda: fa.flash_attention_fwd_short(q, k, v, km, causal, 64 ** -0.5, S - T),
                lambda: fa.flash_attention_fwd_short_occupancy(T, S, causal, S - T))
    if kind.startswith("bias"):
        bias = randn(H, T, S)
        length = torch.randint(S // 2, S + 1, (B,), generator=gen, device="cuda")
        mask = (slots < length[:, None]).to(torch.int32)
        if kind == "bias_fwd":
            km, bias32 = fa._check_inputs(q, k, v, mask), fa._check_bias(q, k, bias, causal)
            return (lambda: fa.flash_attention_bias_fwd_short(q, k, v, km, bias32, causal, 1.0),
                    lambda: fa.flash_bias_fwd_short_occupancy(T, S, causal))
        _, m, l = fa.flash_attention_bias(q, k, v, mask, bias, causal=causal, with_stats=True)
        km, g2 = fa.backward_operands(q, k, v, mask, g, m, l)
        bias32 = fa._check_bias(q, k, bias, causal)
        return (lambda: fa.flash_attention_bias_bwd(q, k, v, km, bias32, g2, m, l, causal, 1.0),
                lambda: fa.flash_attention_bias_bwd_occupancy(T, S))
    pad = torch.randint(0, S // 2 + 1, (B,), generator=gen, device="cuda")
    mask = (slots >= pad[:, None]).to(torch.int32)
    scale, q_offset = (64 ** -0.5, S - T) if causal else (1.0, 0)
    _, m, l = fa.flash_attention(q, k, v, mask, causal=causal, sm_scale=scale, with_stats=True)
    km, g2 = fa.backward_operands(q, k, v, mask, g, m, l)
    return (lambda: fa.flash_attention_bwd(q, k, v, km, g2, m, l, causal, scale, q_offset),
            lambda: fa.flash_attention_bwd_occupancy(T, S))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=(*KERNELS, *GROUPS, "all"), default="all")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bwd_stages: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from trlx_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kinds = tuple(KERNELS) if args.kernel == "all" else GROUPS.get(args.kernel, (args.kernel,))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    lines = []
    load = _build.load
    try:
        for kind in kinds:
            kernel = KERNELS[kind]
            source = kernel["source"]
            libs = build(variants((_build.CSRC / source).read_text(), kernel), _build.BUILD_ROOT.parent / "stages" / kind)
            for shape, dims in kernel["shapes"].items():
                if kind.startswith("paged"):  # dims: B, T, H, PS, MP
                    call, occupancy = paged_call(kind, gen, *dims)
                    where = dict(dims=[*dims, 64])
                elif kind.startswith("decode"):  # dims: B, H, S, written
                    call, occupancy = decode_call(kind, gen, *dims)
                    where = dict(dims=[*dims[:3], 64], written=dims[3])
                else:  # dims: B, H, T, S, causal
                    call, occupancy = fused_call(kind, gen, *dims)
                    where = dict(dims=[*dims[:4], 64], causal=dims[4])
                for name, lib in libs.items():
                    _build.load = lambda src, head_dim=None, lib=lib, source=source: (
                        lib if src == source else load(src, head_dim))
                    line = dict(kernel=kind, shape=shape, **where, variant=name,
                                ms=time_ms(call), occupancy=occupancy(), card=card)
                    lines.append(line)
                    print(json.dumps(line), flush=True)
    finally:
        _build.load = load
    print(card)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
