"""trlx_tpu_torch's pipelines against the JAX package's: shuffles, loader
orders, prompt collation, the rollout store's loader and the trainer's
prompt stream must be EXACTLY equal (integer and host state)."""

import numpy as np
import pytest
import torch

from trlx_tpu.pipeline import DataLoader as JDataLoader
from trlx_tpu.pipeline import epoch_shuffle_order as j_order
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.pipeline.ppo_pipeline import PPORolloutStorage as JStorage
from trlx_tpu.utils.tokenizers import ByteTokenizer as JByteTokenizer

from trlx_tpu_torch.data import PPORolloutBatch
from trlx_tpu_torch.pipeline import DataLoader, MiniBatchIterator, epoch_shuffle_order
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

PROMPTS = [
    "hello world", "the cat", "a b", "xyz", "what is", "I am", "go", "ok",
    "a much longer prompt that will be truncated", "é unicode", "", "tail",
]


@pytest.mark.parametrize("n,seed", [(1, 0), (16, 1234), (37, 7), (100, 2**31 + 5)])
def test_epoch_shuffle_order_is_exact(n, seed):
    np.testing.assert_array_equal(epoch_shuffle_order(n, seed), j_order(n, seed))


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_order_across_two_iterations(drop_last):
    """The first iteration consumes epoch_shuffle_order(n, seed); the
    second continues the same generator stream — in both packages."""
    data = list(range(23))
    ours = DataLoader(data, 5, collate_fn=np.asarray, shuffle=True, drop_last=drop_last, seed=11)
    ref = JDataLoader(data, 5, collate_fn=np.asarray, shuffle=True, drop_last=drop_last, seed=11)
    assert len(ours) == len(ref)
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    first = np.concatenate(list(DataLoader(data, 5, collate_fn=np.asarray, shuffle=True, seed=11)))
    np.testing.assert_array_equal(first, epoch_shuffle_order(23, 11))


@pytest.mark.parametrize("with_metadata", [False, True])
def test_prompt_pipeline_tokens_and_masks(with_metadata):
    prompts = PROMPTS
    if with_metadata:
        prompts = [{"prompt": p, "label": i, "tag": p[:2]} for i, p in enumerate(PROMPTS)]
    ours = PromptPipeline([dict(p) if with_metadata else p for p in prompts], 10, ByteTokenizer())
    ref = JPromptPipeline([dict(p) if with_metadata else p for p in prompts], 10, JByteTokenizer())
    assert len(ours) == len(ref)
    for a, b in zip(ours.create_loader(5, shuffle=True, seed=3), ref.create_loader(5, shuffle=True, seed=3)):
        assert a.input_ids.dtype == torch.int32 and a.attention_mask.dtype == torch.int32
        np.testing.assert_array_equal(a.input_ids.numpy(), np.asarray(b.input_ids))
        np.testing.assert_array_equal(a.attention_mask.numpy(), np.asarray(b.attention_mask))
        assert a.metadata == b.metadata


def _store_rows(n=20, P=3, N=4):
    rng = np.random.default_rng(0)
    return dict(
        query_tensors=np.arange(n * P, dtype=np.int32).reshape(n, P),
        response_tensors=rng.integers(0, 50, size=(n, N)).astype(np.int32),
        logprobs=rng.normal(size=(n, N)).astype(np.float32),
        values=rng.normal(size=(n, N)).astype(np.float32),
        rewards=rng.normal(size=(n, N)).astype(np.float32),
        response_mask=(rng.random((n, N)) > 0.3).astype(np.float32),
    )


def test_rollout_store_loader_order():
    """Two pushed chunks, then two passes of the shuffled loader: every
    minibatch holds the same rows, in the same order, in both stores."""
    from trlx_tpu.data import PPORolloutBatch as JBatch

    rows = _store_rows()
    ours, ref = PPORolloutStorage(), JStorage()
    for sl in (slice(0, 12), slice(12, 20)):
        ours.push(PPORolloutBatch(**{k: torch.from_numpy(v[sl]) for k, v in rows.items()}))
        ref.push(JBatch(**{k: v[sl] for k, v in rows.items()}))
    assert len(ours) == len(ref) == 20
    ours_loader = ours.create_loader(8, shuffle=True, drop_last=True, seed=1003)
    ref_loader = ref.create_loader(8, shuffle=True, drop_last=True, seed=1003)
    for _ in range(2):
        got, want = list(ours_loader), list(ref_loader)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for name in rows:
                np.testing.assert_array_equal(getattr(a, name).numpy(), np.asarray(getattr(b, name)))


def test_epoch_perms_are_the_loader_orders():
    """The minibatch index rows the reference's fused scan consumes
    (`_epoch_perms`) equal the reference's and are, epoch by epoch, the
    rows the port's per-step loop draws from its fresh loaders (seed =
    train.seed + the step count at each epoch's start)."""
    from types import SimpleNamespace

    from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer

    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    n, bs, seed, it0, epochs, P = 20, 8, 11, 3, 3, 3
    state = SimpleNamespace(config=SimpleNamespace(train=SimpleNamespace(batch_size=bs, seed=seed)),
                            iter_count=it0, n_inner_epochs=epochs)
    perms = TPUBaseTrainer._epoch_perms(state, n)
    np.testing.assert_array_equal(perms, JBaseTrainer._epoch_perms(state, n))
    store = PPORolloutStorage()
    store.push(PPORolloutBatch(**{k: torch.from_numpy(v) for k, v in _store_rows(n=n, P=P).items()}))
    drawn, it = [], it0
    for _ in range(epochs):
        for batch in store.create_loader(bs, shuffle=True, drop_last=True, seed=seed + it):
            drawn.append(batch.query_tensors[:, 0].numpy() // P)
            it += 1
    np.testing.assert_array_equal(perms, np.stack(drawn))


def test_minibatch_iterator_splits_rows():
    rows = _store_rows(n=8)
    batch = PPORolloutBatch(**{k: torch.from_numpy(v) for k, v in rows.items()})
    (mbs,) = list(MiniBatchIterator([batch], mb_size=3, num_mb=3))
    assert [len(mb.query_tensors) for mb in mbs] == [3, 3, 2]
    np.testing.assert_array_equal(
        torch.cat([mb.logprobs for mb in mbs]).numpy(), rows["logprobs"]
    )


def test_prompt_cursor_order_over_three_chunks(tmp_path):
    """The trainers' prompt stream (a shuffled loader over the prompt set
    at chunk_size, drop_last, cycled forever) pulls the same chunks in
    both packages: 24 prompts at chunk 8 give three chunks a pass, and
    the fourth chunk is the first of the loader's second pass."""
    from tests.test_trainers import ppo_tiny_config, word_count_reward
    from trlx_tpu.utils.loading import get_trainer as j_get_trainer

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    jconfig = ppo_tiny_config(tmp_path, method=dict(chunk_size=8), train=dict(seed=17))
    config = TRLConfig.from_dict(jconfig.to_dict())
    ref = j_get_trainer(jconfig.train.trainer)(config=jconfig, reward_fn=word_count_reward)
    ours = get_trainer(config.train.trainer)(config=config, reward_fn=word_count_reward, device="cpu")
    prompts = PROMPTS + ["p%d" % i for i in range(12)]  # 24 prompts: 3 chunks of 8 a pass
    ref.add_prompt_pipeline(JPromptPipeline(prompts, 8, ref.tokenizer))
    ours.add_prompt_pipeline(PromptPipeline(prompts, 8, ours.tokenizer))
    for i in range(4):  # the 4th chunk starts the second pass
        a, b = ours._next_prompt_batch(), ref._next_prompt_batch()
        np.testing.assert_array_equal(a.input_ids.numpy(), np.asarray(b.input_ids), err_msg=f"chunk {i}")
        np.testing.assert_array_equal(a.attention_mask.numpy(), np.asarray(b.attention_mask))
    assert ours._prompt_batches_consumed == ref._prompt_batches_consumed == 4
