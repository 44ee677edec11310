"""Auxiliary helpers: timers, rank-aware logging, checkpoint / restart,
solution output and the JAX-state converter (`measure` is the slope
timer, `convert` the converter)."""

from .timers import Timer, list_timings, reset_timings
from .logging import get_logger, init_logging
from .checkpoint import load_state, save_state
from .io import write_npz, write_vtk
