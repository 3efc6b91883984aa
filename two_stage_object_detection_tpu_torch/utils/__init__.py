"""Checkpoints, preemption, plots, seeding, and weight carry-over from the
JAX package."""
