"""Data-parallel training and serving over several devices
(``parallel.mesh``; the counterpart of ``pose_transfer_tpu/parallel``)."""

from .mesh import (ParallelTrainStep, ProcessGroup, config_for_mesh,
                   gather_rows, make_parallel_eval_step,
                   make_parallel_train_step, replicate_state, shard_batch,
                   spawn_ranks, unreplicate_state)

__all__ = ["ParallelTrainStep", "ProcessGroup", "config_for_mesh",
           "gather_rows", "make_parallel_eval_step",
           "make_parallel_train_step", "replicate_state", "shard_batch",
           "spawn_ranks", "unreplicate_state"]
