"""Plumbing for solver programs that are generic over the hierarchy
classes (the single-device `PMGHierarchy` and the device grid
`parallel.grid2d.GridPMG`).

Port of the single-device branch of `pmg_dolfinx_tpu.solvers.shardwrap`:
a whole-solve program (a Newton step, a BiCGStab loop) runs as it is on
one device, so the JAX package's ``shard_map`` wrapping (`wrap_program`,
`vector_spec`) has no counterpart; the sharded branches (the slab and
grid layouts and their per-axis exchanges) are ROADMAP.md Queue 1 item
10 and raise on a `GridPMG`.
"""


def _todo(what):
    return NotImplementedError(
        f"{what} on a sharded hierarchy (GridPMG) is not ported yet "
        "(ROADMAP.md Queue 1 item 10)")


def is_sharded(hier):
    """True on the device grid (`GridPMG`, which carries a partition)."""
    return hasattr(hier, "part")


def layout_converters(hier):
    """``(to_work, from_work)``: a global flat vector to the hierarchy's
    working layout (lattice-shaped for the Kronecker family) and back to
    flat."""
    if is_sharded(hier):
        raise _todo("layout_converters")
    return hier._to_work, lambda v: v.reshape(-1)


def shards_of(hier):
    """Per-axis shard counts of the dof lattice: ``(1, 1, 1)`` on one
    device."""
    if is_sharded(hier):
        raise _todo("shards_of")
    return (1, 1, 1)


def axis_exchanges(hier):
    """Per-axis interface partial-sum exchanges for custom operator terms:
    ``(None, None, None)`` on one device."""
    if is_sharded(hier):
        raise _todo("axis_exchanges")
    return (None, None, None)
