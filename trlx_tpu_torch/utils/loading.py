"""Registry lookups for trainers and pipelines (port of
trlx_tpu.utils.loading): the same names, so the reference's configs
select the port's classes unchanged. Importing the trainer modules
populates the registries."""

from __future__ import annotations

# the reference's trainer names that the port has reached
_ALIASES = {
    "accelerateppotrainer": "tpuppotrainer",
    "nemoppotrainer": "tpuppotrainer",
}


def get_trainer(name: str) -> type:
    import trlx_tpu_torch.trainer as trainer_pkg
    import trlx_tpu_torch.trainer.ppo  # noqa: F401  (registration side effect)

    key = _ALIASES.get(name.lower(), name.lower())
    if key not in trainer_pkg._TRAINERS:
        raise ValueError(
            f"Unknown trainer {name!r}; the port has {sorted(trainer_pkg._TRAINERS)} "
            "(the other trainers are ROADMAP queue 6)"
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
