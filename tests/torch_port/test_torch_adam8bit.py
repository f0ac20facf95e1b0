"""trlx_tpu_torch.ops.adam8bit and the registry's 8-bit AdamW and Lion
against trlx_tpu.ops.adam8bit and optax, on the CPU (the plain versions of
kernel 9).

Held: the blockwise companded int8 code (payloads equal, scales to 1e-7
relative); both 8-bit AdamW variants and Lion over 5 steps on leaves that
include one of 77,000 elements (no whole number of 256-blocks), with
weight decay and a linear learning-rate schedule read at the
pre-increment count, with fp32 and with bf16 gradients (the same bf16
values fed to both): parameters within 1e-6 (atol 1e-6 on weights of
size 0.02), payloads equal or one LSB apart in at most 0.1% of the
entries, scales to 1e-6 relative; the optimizer's state_dict round trip
bit for bit. Kernel 9's own shortcuts, mirrored in plain PyTorch: its
dequantisation table times the scale is `deq_blocks` bit for bit, and its
fast requantisation rule gives `quant_blocks`' payloads exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trlx_tpu.ops import adam8bit as j8
from trlx_tpu.utils import build_optimizer as j_build_optimizer

from trlx_tpu_torch.data.configs import OptimizerConfig, SchedulerConfig
from trlx_tpu_torch.ops import adam8bit as a8
from trlx_tpu_torch.utils import build_optimizer

SHAPES = {"w": (64, 48), "ragged": (1000, 77), "bias": (48,)}
STEPS, LR, WD = 5, 1e-3, 0.01
LSB_SHARE = 1e-3


@pytest.mark.parametrize("shape", [(256,), (3, 256), (7, 77), (1000, 77)])
@pytest.mark.parametrize("spread", [1e-2, 1e3])
def test_blockwise_code_matches_reference(shape, spread):
    """Payloads equal and scales to 1e-7 relative; the dequantized leaf to
    fp32 rounding. Values spanning orders of magnitude within a block (v's
    case) and a block of zeros."""
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * np.exp(rng.uniform(-6, 0, shape)) * spread).astype(np.float32)
    x.reshape(-1)[:256] = 0.0
    jq = j8._quantize(jnp.asarray(x))
    q, s = a8.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq.q))
    np.testing.assert_allclose(s.numpy(), np.asarray(jq.scale), rtol=1e-7, atol=0)
    np.testing.assert_allclose(a8.dequantize(q, s, shape).numpy(), np.asarray(j8._dequantize(jq)),
                               rtol=1e-6, atol=0)


def _kernel_table() -> torch.Tensor:
    """Kernel 9's dequantisation table as the kernel builds it in shared
    memory: entry q + 128 = sign(u) * u * u with u = q / 127 correctly
    rounded, for every int8 payload q."""
    u = torch.arange(-128, 128, dtype=torch.float32) / torch.tensor(127.0)
    return torch.sign(u) * u * u


@pytest.mark.parametrize("scale", [0.0, 1e-30, 1e-40, 1.0, 1e30], ids=["zero", "1e-30", "subnormal", "one", "1e30"])
def test_kernel_table_dequantisation_is_exact(scale):
    """The table entry times the block's scale is `deq_blocks` bit for bit
    at every payload value (-128 .. 127), so kernel 9's table read and one
    multiply give its plain version's moments exactly."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)[None]
    s = torch.tensor([scale], dtype=torch.float32)
    got = _kernel_table()[q.long() + 128] * s[:, None]
    want = a8.deq_blocks(q, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_fast_requantisation_rule_gives_the_exact_code():
    """Kernel 9's requantisation rule: t = sqrt(|x| * (1 / A)) * 127 from an
    approximate square root, off the exact chain's t by less than 2^-13,
    is rounded to the code when it lies more than 2^-10 from a
    half-integer, else the exact chain decides. Mirrored with t pushed the
    whole 2^-13 either way, over random blocks and values placed on each
    rounding boundary, it gives `quant_blocks`' payloads exactly."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, a8.BLOCK)) * np.exp(rng.uniform(-8, 0, (64, a8.BLOCK)))).astype(np.float32)
    # m's and v's values on each boundary k + 0.5 of a block whose absmax is 1
    k = np.arange(127, dtype=np.float64)
    edge = ((k + 0.5) / 127) ** 2
    near = np.concatenate([edge, np.nextafter(edge.astype(np.float32), 0), np.nextafter(edge.astype(np.float32), 2)])
    y = np.zeros((2, a8.BLOCK), np.float32)
    y[:, 0] = 1.0
    y[0, 1:1 + near.size // 2] = near[: near.size // 2]
    y[1, 1:1 + near.size - near.size // 2] = -near[near.size // 2:]
    blocks = torch.from_numpy(np.concatenate([x, y]))
    want, scale = a8.quant_blocks(blocks)
    a = torch.clamp(scale, min=1e-30)[:, None]
    t = torch.sqrt(blocks.abs() * (1 / a)) * 127.0
    exact = want.float().abs()
    for push in (-(2.0 ** -13), 2.0 ** -13):
        tf = t + push
        r = torch.round(tf)
        fast = (tf - r).abs() < 0.5 - 2.0 ** -10
        code = torch.where(fast, r, exact) * torch.sign(blocks)
        assert torch.equal(code.to(torch.int8), want), push
    assert not fast.all()  # the boundary values take the exact chain


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v) * 0.02).astype(np.float32) for k, v in SHAPES.items()}


def _grads(step, grad_dtype):
    rng = np.random.default_rng(100 + step)
    out = {}
    for k, v in SHAPES.items():
        g = (rng.standard_normal(v) * 1e-2 * np.exp(rng.uniform(-3, 0, v))).astype(np.float32)
        # both packages see the same bf16 values: rounded once by torch
        out[k] = g if grad_dtype == "float32" else torch.from_numpy(g).bfloat16().float().numpy()
    return out


def _configs(name):
    kwargs = dict(lr=LR, betas=(0.9, 0.99 if name == "lion" else 0.999), weight_decay=WD)
    if name != "lion":
        kwargs["eps"] = 1e-8
    return (OptimizerConfig(name=name, kwargs=kwargs),
            SchedulerConfig(name="linear", kwargs=dict(total_steps=8, final_lr=LR / 4)))


def _run_reference(name, grad_dtype):
    opt_cfg, sched_cfg = _configs(name)
    tx, _ = j_build_optimizer(opt_cfg, sched_cfg)
    params = {k: jnp.asarray(v) for k, v in _leaves().items()}
    state = tx.init(params)
    jdt = jnp.float32 if grad_dtype == "float32" else jnp.bfloat16
    for step in range(STEPS):
        grads = {k: jnp.asarray(v).astype(jdt) for k, v in _grads(step, grad_dtype).items()}
        if hasattr(tx, "fused_apply"):
            params, state = tx.fused_apply(params, grads, state)
        else:
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
    return params, state


def _run_port(name, grad_dtype):
    opt_cfg, sched_cfg = _configs(name)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in _leaves().items()}
    optimizer, scheduler, _ = build_optimizer(list(params.values()), opt_cfg, sched_cfg)
    tdt = torch.float32 if grad_dtype == "float32" else torch.bfloat16
    for step in range(STEPS):
        grads = {params[k]: torch.from_numpy(v).to(tdt) for k, v in _grads(step, grad_dtype).items()}
        optimizer.step(grads=grads)
        scheduler.step()
    return params, optimizer


def _q8_of(state, key):
    """The reference's (m, v) Q8 leaves of parameter `key`."""
    inner = state if hasattr(state, "m") else next(s for s in state if hasattr(s, "m"))
    return inner.m[key], inner.v[key]


def _assert_payloads(q, jq):
    d = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= LSB_SHARE, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw_8bit_fused", "adamw_8bit_bnb", "lion"])
def test_optimizer_matches_reference(name, grad_dtype):
    jparams, jstate = _run_reference(name, grad_dtype)
    params, optimizer = _run_port(name, grad_dtype)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-6, err_msg=k)
        st = optimizer.state[p]
        assert int(st["step"]) == STEPS
        if name == "lion":
            mu = next(s for s in jstate if hasattr(s, "mu")).mu[k]
            np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(mu), rtol=1e-6, atol=1e-9, err_msg=k)
            continue
        jm, jv = _q8_of(jstate, k)
        for (q, s), jq in (((st["m_q"], st["m_scale"]), jm), ((st["v_q"], st["v_scale"]), jv)):
            _assert_payloads(q, jq.q)
            np.testing.assert_allclose(s.numpy(), np.asarray(jq.scale), rtol=1e-6, atol=0, err_msg=k)


def test_frozen_parameters_get_no_state():
    """A parameter outside the optimizer (frozen) never gets moments; one
    without a gradient this step keeps its state."""
    a, b = torch.nn.Parameter(torch.ones(300)), torch.nn.Parameter(torch.ones(10))
    frozen = torch.nn.Parameter(torch.ones(5))
    opt = a8.AdamW8bit([a, b], lr=1e-2)
    opt.step(grads={a: torch.full((300,), 0.5)})
    assert set(opt.state) == {a} and frozen not in opt.state
    assert opt.state[a]["m_q"].shape == (2, a8.BLOCK) and opt.state[a]["m_q"].dtype == torch.int8
    torch.testing.assert_close(b.detach(), torch.ones(10))


@pytest.mark.parametrize("fused", [True, False])
def test_state_dict_round_trip_is_bit_for_bit(fused, tmp_path):
    """Two steps, the state dict saved and loaded into a fresh optimizer
    over copies of the parameters, three more steps: parameters, int8
    payloads and scales equal bit for bit to five uninterrupted steps."""
    def make():
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in _leaves().items()}
        return params, a8.AdamW8bit(list(params.values()), lr=LR, weight_decay=WD, fused=fused)

    def step(params, opt, i):
        opt.step(grads={params[k]: torch.from_numpy(v).bfloat16() for k, v in _grads(i, "bfloat16").items()})

    full, opt_full = make()
    for i in range(STEPS):
        step(full, opt_full, i)
    part, opt_part = make()
    for i in range(2):
        step(part, opt_part, i)
    torch.save({"opt": opt_part.state_dict(), "params": {k: p.detach() for k, p in part.items()}},
               tmp_path / "ckpt.pt")
    saved = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    resumed, opt_resumed = make()
    with torch.no_grad():
        for k, p in resumed.items():
            p.copy_(saved["params"][k])
    opt_resumed.load_state_dict(saved["opt"])
    for i in range(2, STEPS):
        step(resumed, opt_resumed, i)
    for k in SHAPES:
        assert torch.equal(resumed[k], full[k]), k
        a, b = opt_resumed.state[resumed[k]], opt_full.state[full[k]]
        for key in ("m_q", "m_scale", "v_q", "v_scale", "step"):
            assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), (k, key)


def test_registry_names():
    from trlx_tpu_torch.utils import get_optimizer_class

    p = [torch.nn.Parameter(torch.zeros(3))]
    assert isinstance(get_optimizer_class("adamw_8bit_fused")(p, 1e-3), a8.AdamW8bit)
    assert get_optimizer_class("adamw_8bit_fused")(p, 1e-3).fused
    assert not get_optimizer_class("ADAMW_8BIT_BNB")(p, 1e-3).fused
    assert isinstance(get_optimizer_class("lion")(p, 1e-4, betas=(0.9, 0.99)), a8.Lion)
