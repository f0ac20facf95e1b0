"""Stop sequences, the rollout export (`train.rollout_logging_dir`) and
`train.timing_split` against the JAX package, on the CPU:

- `decode()` on crafted token arrays against the reference's `decode`:
  each output cut at the first occurrence of every stop string and
  right-stripped, the EOS string appended to a cut output as to one that
  ended on EOS or pad, seq2seq's sep join;
- one `train()` with all three knobs against `trlx_tpu.train` (its
  per-step loop) with the same stop strings: the last cycle's store (the
  response tokens re-tokenised from the cut outputs; tokens and masks
  exactly, floats atol 1e-4), the loss stream (rtol 1e-4) and the
  evaluations, which decode through the same trimming; at least one
  output was cut, and none still holds a stop string;
- the export: one `epoch-*.json` (the first cycle's store; the run ends
  at total_steps inside the second) beside `config.json`, row for row the
  reference's (the same keys, token lists exactly, floats atol 1e-4, the
  decoded strings);
- `time/forward` and `time/backward` at exactly the reference's steps
  (the second step of the batch shape on), non-negative."""

import glob
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.utils.tokenizers import ByteTokenizer as JByteTokenizer

from tests.torch_port import ppo_parity
from trlx_tpu_torch.trainer.base import TPUBaseTrainer
from trlx_tpu_torch.trainer.ppo import TPUPPOTrainer
from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

# stop strings that the greedy outputs of ppo_parity's config hold ("s---",
# "zzzz")
STOPS = ["--", "zz"]


def _bytes(text):
    return list(text.encode())


@pytest.mark.parametrize("seq2seq", [False, True], ids=["causal", "seq2seq"])
def test_decode_trims_like_the_reference(seq2seq):
    stops = ["\n\nHuman:", "##", "  "]
    eos, pad = 257, 257
    prompt = _bytes("Q: hi")
    outputs = [
        _bytes("fine\n\nHuman: more") + [eos],  # cut, then rstrip of nothing
        _bytes("a ## b  c"),  # "##" cuts; "  " is then looked for in the cut output
        _bytes("plain text"),  # not cut, no EOS: nothing appended
        _bytes("ends") + [eos, pad, pad],  # ended on pad: EOS appended
        _bytes("trail   ##x"),  # "  " cuts first, rstrip drops the third space
        _bytes("##"),  # cut to the empty string
    ]
    # a seq2seq sample is the decoder sequence alone
    samples = [np.asarray(([] if seq2seq else prompt) + o) for o in outputs]
    arch = "seq2seq" if seq2seq else "causal"
    j_self = SimpleNamespace(tokenizer=JByteTokenizer(), stop_sequences=stops,
                             config=SimpleNamespace(model=SimpleNamespace(model_arch_type=arch)))
    t_self = SimpleNamespace(tokenizer=ByteTokenizer(), stop_sequences=stops, seq2seq=seq2seq)
    for append in (False, True):
        for i, sample in enumerate(samples):  # one row at a time: the rows are ragged
            want = JBaseTrainer.decode(j_self, [prompt], [sample], [len(prompt)], append_eos_token=append)
            got = TPUBaseTrainer.decode(t_self, [prompt], [sample], [len(prompt)], append_eos_token=append)
            assert got == want, (i, append)
    _, _, cut = TPUBaseTrainer.decode(t_self, [prompt] * 6, samples, [len(prompt)] * 6, append_eos_token=True)
    assert cut == ["fine<|eos|>", "a<|eos|>", "plain text", "ends<|eos|>", "trail<|eos|>", "<|eos|>"]


@pytest.fixture(scope="module")
def knobs_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("knobs")
    logs = {name: tmp / name for name in ("ref_rollouts", "port_rollouts")}
    for d in logs.values():
        d.mkdir()
    jconfig = ppo_parity.config(tmp, train=dict(timing_split=True, rollout_logging_dir=str(logs["ref_rollouts"])))
    ref, init, j_stats = ppo_parity.run_reference(jconfig, stop_sequences=STOPS)
    jconfig.train.rollout_logging_dir = str(logs["port_rollouts"])
    cut = []
    retokenize = TPUPPOTrainer._retokenize_outputs

    def spy(self, str_outputs, batch, sequences, N):
        raw = [self.tokenizer.decode(row[-N:]) for row in sequences.cpu().numpy()]
        cut.append((raw, list(str_outputs)))
        return retokenize(self, str_outputs, batch, sequences, N)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TPUPPOTrainer, "_retokenize_outputs", spy)
        ours = ppo_parity.run_port(jconfig, init, stop_sequences=STOPS)
    return ref, j_stats, ours, logs, cut


def test_stop_sequences_train_matches_reference(knobs_run):
    ref, j_stats, ours, _, cut = knobs_run
    assert ours.iter_count == ref.iter_count == 8
    ppo_parity.assert_store_matches(ours, ref)
    want, got = ppo_parity.losses(j_stats), ppo_parity.losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-5)

    def evals(stream):
        return [float(s["reward/mean"]) for _, s in stream if "reward/mean" in s]

    np.testing.assert_allclose(evals(ours.stats_history), evals(j_stats), rtol=1e-6)
    # not vacuous: sampled outputs held a stop string, the scored ones none
    raw = [r for chunk_raw, _ in cut for r in chunk_raw]
    trimmed = [o for _, chunk_out in cut for o in chunk_out]
    assert len(cut) == 4 and sum(any(s in r for s in STOPS) for r in raw) >= 1
    assert not any(s in o for s in STOPS for o in trimmed)


def _export(directory):
    runs = glob.glob(os.path.join(directory, "run-*"))
    assert len(runs) == 1
    assert os.path.exists(os.path.join(runs[0], "config.json"))
    with open(os.path.join(runs[0], "config.json")) as f:
        assert "train" in json.load(f)
    files = glob.glob(os.path.join(runs[0], "epoch-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        return json.load(f)


def test_rollout_export_matches_reference(knobs_run):
    _, _, _, logs, _ = knobs_run
    want, got = _export(logs["ref_rollouts"]), _export(logs["port_rollouts"])
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"query_tensor", "response_tensor", "logprobs", "values", "rewards",
                                    "query", "response"}
        for key in ("query_tensor", "response_tensor", "query", "response"):
            assert g[key] == w[key], key
        for key in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, rtol=0, err_msg=key)


def test_timing_split_matches_reference_steps(knobs_run):
    _, j_stats, ours, _, _ = knobs_run

    def timed(stream):
        return [step for step, s in stream if "time/forward" in s]

    assert timed(ours.stats_history) == timed(j_stats) == list(range(2, 9))
    for _, s in ours.stats_history:
        if "time/forward" in s:
            assert "time/backward" in s and s["time/forward"] >= 0 and s["time/backward"] >= 0
