"""Serving steps and synthetic data (port of ``repro/train``; the
serving part so far)."""

from repro_torch.train.train_step import (cast_to_compute, greedy_sample,
                                          make_serve_steps,
                                          temperature_sample)

__all__ = ["cast_to_compute", "greedy_sample", "make_serve_steps",
           "temperature_sample"]
