"""Auxiliary helpers: timers and the JAX-state converter."""

from .timers import Timer, list_timings
