"""The cross-start comparison of `test_torch_curves.py::
test_ppo_from_jax_clone_matches_reference`, run in a fresh interpreter the
way `scripts/torch_randomwalks_cross_start.py`'s `main` runs it: one torch
thread and nothing left over from earlier work in the process. The JAX
example's behaviour-cloned start at the example's seed, converted into the
port's save format, and the JAX trainer's value head; then two PPO cycles
(8 steps) of the example's config, greedy in fp32, in the port and in the
JAX package's per-step loop. Held: the last rollouts' tokens and masks
exactly, their logprobs, values and rewards within 1e-4, the loss stream
to rtol 1e-4 and the eval optimality exactly.

    python -m tests.torch_port.cross_start_check <scratch directory>

exits 0 when every comparison holds (an AssertionError otherwise)."""

import os
import sys

import tests.conftest  # noqa: F401  (JAX on 8 CPU devices, as under pytest)


def main(directory: str) -> None:
    import jax
    import numpy as np
    import torch

    from scripts import torch_randomwalks_cross_start as cross

    torch.set_num_threads(1)
    start = cross.clone_start(1000, os.path.join(directory, "clone"))
    hparams = cross.ppo_hparams(1000, os.path.join(directory, "ppo"), greedy=True, epochs=2,
                                compute_dtype="float32")
    ref, j_stats, init = cross.jax_ppo(start["jax"], hparams, fused=False)
    ours = cross.port_ppo(start["port"], hparams, init)
    assert ours.iter_count == ref.iter_count == 8

    j_hist = jax.tree_util.tree_map(np.asarray, ref.store.history)
    hist = ours.store.history
    assert (hist.response_tensors == ours.tokenizer.eos_token_id).any()
    for name in ("query_tensors", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(getattr(hist, name).numpy(), getattr(j_hist, name), err_msg=name)
    for name in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(getattr(hist, name).numpy(), getattr(j_hist, name), atol=1e-4, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(cross.series(ours.stats_history, "losses/total_loss"),
                               cross.series(j_stats, "losses/total_loss"), rtol=1e-4, atol=1e-5)
    optimality = cross.series(ours.stats_history, "metrics/optimality")
    assert len(optimality) == 2 and optimality == cross.series(j_stats, "metrics/optimality")
    print("cross_start_check: every comparison holds")


if __name__ == "__main__":
    main(sys.argv[1])
