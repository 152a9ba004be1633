"""Training/serving substrate: optimizer, steps, data, checkpoints, fault
tolerance (port of ``repro/train``, meshless or on a mesh)."""

from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.train.train_step import (cast_to_compute, greedy_sample,
                                          init_train_state, loss_fn,
                                          make_serve_steps, make_shard_ctx,
                                          make_spectral_train_step,
                                          make_train_step, spectral_loss_fn,
                                          temperature_sample)

__all__ = ["OptConfig", "adamw_update", "cast_to_compute", "greedy_sample",
           "init_opt_state", "init_train_state", "loss_fn",
           "make_serve_steps", "make_shard_ctx", "make_spectral_train_step",
           "make_train_step", "spectral_loss_fn", "temperature_sample"]
