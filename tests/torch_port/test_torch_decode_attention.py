"""trlx_tpu_torch.ops.decode_attention on the CPU (its plain version)
against the JAX package's Pallas `decode_attention_int8` (interpret
mode): every layer of an L=3 int8 cache, a padded row, GQA; masks with
holes, a fully masked row and a row attendable only at its last slot, at
S = 128 and 256 (the short CUDA route's edge). fp32 q; atol 2e-5. Then
the CUDA route table and the wrappers' refusals: the route kernels take
CUDA tensors only, and a failed launch never falls back."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.decode_attention import decode_attention_int8 as j_decode

from trlx_tpu_torch.ops import decode_attention as da
from trlx_tpu_torch.ops.decode_attention import (
    SHORT_DECODE_MAX_SLOTS,
    decode_attention_int8,
    decode_attention_int8_long,
    decode_attention_int8_occupancy,
    decode_attention_int8_plain,
    decode_attention_int8_short,
    decode_route,
)


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_every_layer_matches_jax_kernel(H, Hkv):
    L, B, S, D = 3, 2, 128, 16  # the reference kernel needs 128 | S
    rng = np.random.default_rng(H + Hkv)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    ck = rng.integers(-127, 128, size=(L, B, Hkv, S, D)).astype(np.int8)
    cv = rng.integers(-127, 128, size=(L, B, Hkv, S, D)).astype(np.int8)
    ks = (rng.random(size=(L, B, Hkv, 1, S)) * 0.02).astype(np.float32)
    vs = (rng.random(size=(L, B, Hkv, 1, D)) * 0.02).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :9] = 0  # left-padded prompt
    mask[:, 100:] = 0  # unwritten slots
    for ix in range(L):
        ref = j_decode(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(ks),
            jnp.asarray(vs[ix]), jnp.asarray(mask), ix, sm_scale=D ** -0.5,
        )
        got = decode_attention_int8(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            torch.from_numpy(ks), torch.from_numpy(vs[ix]), torch.from_numpy(mask),
            ix, D ** -0.5,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("S,route", [(1, "short"), (128, "short"), (256, "short"), (257, "long"), (384, "long")])
def test_decode_route(S, route):
    """The CUDA int8 decode step takes the short kernel while the cache
    holds at most SHORT_DECODE_MAX_SLOTS slots (whatever the mask admits),
    the long one past it. Every path's cache is 128 slots (generate()
    rounds it up under the kernel), so every path takes the short route."""
    assert SHORT_DECODE_MAX_SLOTS == 256
    assert decode_route(S) == route


@pytest.mark.parametrize("S", [128, 256], ids=["S128", "S256"])
@pytest.mark.parametrize("H,Hkv", [(3, 3), (6, 2)], ids=["mha", "gqa"])
def test_holes_and_fully_masked_row_match_jax_kernel(H, Hkv, S):
    """The plain version (the CUDA kernels' oracle) against the JAX Pallas
    kernel on the masks the short kernel's mask ballot has to get right:
    a row with holes inside its span, a fully masked row (a uniform average
    of V over all S), a row attendable only at slot S - 1, and a row with
    every slot attendable. fp32 q, both layers of an L=2 cache; atol 2e-5."""
    L, B, D = 2, 4, 16
    rng = np.random.default_rng(S + H)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    ck = rng.integers(-127, 128, size=(L, B, Hkv, S, D)).astype(np.int8)
    cv = rng.integers(-127, 128, size=(L, B, Hkv, S, D)).astype(np.int8)
    ks = (rng.random(size=(L, B, Hkv, 1, S)) * 0.02).astype(np.float32)
    vs = (rng.random(size=(L, B, Hkv, 1, D)) * 0.02).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :7] = 0
    mask[0, S - 20:] = 0
    mask[0, 7:S - 20] = rng.random(S - 27) < 0.6  # holes inside the span
    mask[1] = 0  # fully masked
    mask[2] = 0
    mask[2, S - 1] = 1  # only the last slot
    for ix in range(L):
        ref = j_decode(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(ks),
            jnp.asarray(vs[ix]), jnp.asarray(mask), ix, sm_scale=D ** -0.5,
        )
        got = decode_attention_int8_plain(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            torch.from_numpy(ks), torch.from_numpy(vs[ix]), torch.from_numpy(mask),
            ix, D ** -0.5,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
        # the fully masked row is V's uniform average over all S slots
        uniform = cv[ix, 1].astype(np.float64).mean(axis=1) * vs[ix, 1, :, 0]  # [Hkv, D]
        np.testing.assert_allclose(got.numpy()[1], np.repeat(uniform, H // Hkv, axis=0), atol=2e-5, rtol=0)


def _operands(device, S=128, H=12, Hkv=12):
    """Well-formed operands of the CUDA kernels (GPT-2's head width), on
    `device`."""
    L, B, D = 2, 2, 64
    return (torch.zeros((B, H, D), dtype=torch.bfloat16, device=device),
            torch.zeros((L, B, Hkv, S, D), dtype=torch.int8, device=device),
            torch.zeros((L, B, Hkv, S, D), dtype=torch.int8, device=device),
            torch.zeros((L, B, Hkv, 1, S), dtype=torch.float32, device=device),
            torch.zeros((B, Hkv, 1, D), dtype=torch.float32, device=device),
            torch.ones((B, S), dtype=torch.int32, device=device))


@pytest.mark.parametrize("kernel", [decode_attention_int8_short, decode_attention_int8_long], ids=["short", "long"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_route_kernels_refuse_non_cuda_tensors(kernel, device):
    """The routes' kernels run on the card only: on CPU or meta tensors they
    raise a clear error and count no launch (only `decode_attention_int8`
    takes the plain version, and only for CPU tensors)."""
    args = _operands(device)
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(*args, 0, 0.125)
    assert kernel.launches == before


def test_wrapper_refuses_other_devices_without_the_plain_version(monkeypatch):
    """On a device that is neither the CPU nor CUDA the wrapper raises; it
    never computes the plain version there."""
    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(da, "decode_attention_int8_plain", plain_must_not_run)
    before = decode_attention_int8.launches
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        decode_attention_int8(*_operands("meta"), 0, 0.125)
    assert decode_attention_int8.launches == before


@pytest.mark.parametrize("S,route", [(128, "short"), (384, "long")])
def test_cuda_launch_failure_raises_and_never_falls_back(monkeypatch, S, route):
    """A CUDA operand goes to the kernel of its route; if that kernel's
    launch fails, the error reaches the caller: neither the other route nor
    the plain version runs, and no launch is counted."""
    calls = []

    def failing(name):
        def kernel(*args):
            calls.append(name)
            raise RuntimeError(f"{name} kernel launch failed: too many resources requested for launch")
        return kernel

    def recorded(name):
        def fn(*args, **kwargs):
            calls.append(name)
            raise AssertionError(f"{name} ran after a failed launch")
        return fn

    monkeypatch.setattr(da, f"decode_attention_int8_{route}", failing(route))
    other = "long" if route == "short" else "short"
    monkeypatch.setattr(da, f"decode_attention_int8_{other}", recorded(other))
    monkeypatch.setattr(da, "decode_attention_int8_plain", recorded("plain"))
    q = SimpleNamespace(device=torch.device("cuda"))  # only its device is read before the launch
    ck = SimpleNamespace(shape=(2, 2, 12, S, 64))
    before = decode_attention_int8.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        decode_attention_int8(q, ck, None, None, None, None, 0, 0.125)
    assert calls == [route]
    assert decode_attention_int8.launches == before


def test_occupancy_query_needs_a_cuda_device():
    """The occupancy query refuses a device that is not CUDA by name, and
    raises, not guesses, where no card is present (as here)."""
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA device"):
            decode_attention_int8_occupancy("short", 12, 12, 128, device=device)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            decode_attention_int8_occupancy("short", 12, 12, 128)
