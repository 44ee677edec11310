"""Plumbing for solver programs that are generic over the hierarchy
classes: the single-device `PMGHierarchy`, the 1D slab
`parallel.dist.DistPMG` and the device grid `parallel.grid2d.GridPMG`.

Port of `pmg_dolfinx_tpu.solvers.shardwrap`. A whole-solve program (a
Newton step, a BiCGStab loop) runs as it is on every class: the port
stacks the shards of the sharded classes on one device (or, across
processes, each rank's block of them), so the JAX package's
``shard_map`` wrapping (`wrap_program`, `vector_spec`) has no
counterpart. What differs between the classes is the working layout of a
vector (`layout_converters`: global vectors in and out on every rank),
the global shard counts (`shards_of`; the cells a shard holds) and the
per-axis interface exchanges of a custom operator term
(`axis_exchanges`, through the class's own grid).
"""


def is_sharded(hier):
    """True on the slab and grid classes (they carry a partition)."""
    return hasattr(hier, "part")


def layout_converters(hier):
    """``(to_work, from_work)``: a global flat vector to the hierarchy's
    working layout (lattice-shaped for the Kronecker family on one
    device, the slab or grid stack on the sharded classes) and back to a
    global flat vector."""
    if is_sharded(hier):
        return hier.to_dist, hier.from_dist
    return hier._to_work, lambda v: v.reshape(-1)


def shards_of(hier):
    """Per-axis shard counts of the dof lattice: ``(1, 1, 1)`` on one
    device, ``(S, 1, 1)`` on the x-slab, the grid shape on `GridPMG`."""
    if not is_sharded(hier):
        return (1, 1, 1)
    part = hier.part
    if hasattr(part, "shards"):
        return tuple(part.shards)
    return (part.n_shards, 1, 1)


def axis_exchanges(hier):
    """Per-axis interface partial-sum exchanges (``lat -> lat`` on the
    class's stacked lattice; None on unsharded axes) for custom operator
    terms, matching the class's own apply: the slab's single x exchange,
    the grid's per-axis ones. A term contracted along axis ``a`` is
    shard-partial exactly at the duplicated a-interface planes and must
    be exchanged along that axis only (pointwise factors are already
    consistent)."""
    shards = shards_of(hier)
    if not is_sharded(hier):
        return (None, None, None)
    if hasattr(hier.part, "shards"):
        from ..parallel.grid2d import _exchange_axis

        grid = hier.grid
        return tuple(
            (lambda t, a=a: _exchange_axis(t, grid, a))
            if shards[a] > 1 else None
            for a in range(3)
        )
    from ..parallel.dist import _exchange_partials

    grid = hier.grid      # every slab here, or this rank's block of them
    return ((lambda t: _exchange_partials(t, grid)) if shards[0] > 1
            else None, None, None)
