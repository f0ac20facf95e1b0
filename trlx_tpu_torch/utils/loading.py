"""Registry lookups for trainers and pipelines (port of
trlx_tpu.utils.loading): the same names, so the reference's configs
select the port's classes unchanged. Importing the trainer modules
populates the registries."""

from __future__ import annotations

# the reference's aliases of its trainer names
_ALIASES = {
    "accelerateppotrainer": "tpuppotrainer",
    "nemoppotrainer": "tpuppotrainer",
    "acceleratesfttrainer": "tpusfttrainer",
    "nemosfttrainer": "tpusfttrainer",
    "accelerateilqltrainer": "tpuilqltrainer",
    "nemoilqltrainer": "tpuilqltrainer",
    "acceleraterfttrainer": "tpurfttrainer",
    "accelerategrpotrainer": "tpugrpotrainer",
    "acceleratedpotrainer": "tpudpotrainer",
}


def get_trainer(name: str) -> type:
    import trlx_tpu_torch.trainer as trainer_pkg
    import trlx_tpu_torch.trainer.dpo  # noqa: F401
    import trlx_tpu_torch.trainer.grpo  # noqa: F401
    import trlx_tpu_torch.trainer.ilql  # noqa: F401
    import trlx_tpu_torch.trainer.ppo  # noqa: F401  (registration side effects)
    import trlx_tpu_torch.trainer.rft  # noqa: F401
    import trlx_tpu_torch.trainer.sft  # noqa: F401

    key = _ALIASES.get(name.lower(), name.lower())
    if key not in trainer_pkg._TRAINERS:
        raise ValueError(
            f"Unknown trainer {name!r}; registered: {sorted(trainer_pkg._TRAINERS)}"
        )
    return trainer_pkg._TRAINERS[key]


def get_pipeline(name: str) -> type:
    import trlx_tpu_torch.pipeline as pipeline_pkg
    import trlx_tpu_torch.pipeline.offline_pipeline  # noqa: F401

    key = name.lower()
    if key not in pipeline_pkg._DATAPIPELINE:
        raise ValueError(
            f"Unknown pipeline {name!r}; registered: {sorted(pipeline_pkg._DATAPIPELINE)}"
        )
    return pipeline_pkg._DATAPIPELINE[key]
