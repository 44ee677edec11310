"""BLAS-1 layer on dof vectors.

Port of `pmg_dolfinx_tpu.ops.blas`: `inner_product`, and the distributed
`dist_inner_product` / `dist_norm` of the device grid. In the port a
distributed vector stacks every shard on one device (`parallel.grid2d`),
so the JAX package's ownership-weighted local sum plus ``psum`` is one
weighted sum over the whole tensor; ``axis`` (the JAX mesh axes) is kept
for the call shape.
"""

import torch


def inner_product(u, v):
    """Real dot product as a 0-d tensor on the vectors' device;
    shape-agnostic (lattice-shaped vectors reduce without a reshape)."""
    return torch.sum(u * v)


def dist_inner_product(u, v, weights, axis=None):
    """Ownership-weighted dot of two distributed vectors (each duplicated
    interface entry counted once)."""
    return torch.sum(u * v * weights)


def dist_norm(u, weights, axis=None, kind="l2"):
    """The l2 norm (ownership-weighted) or the max norm of a distributed
    vector."""
    if kind == "l2":
        return torch.sqrt(dist_inner_product(u, u, weights, axis))
    if kind == "linf":
        return torch.max(torch.abs(u))
    raise ValueError(kind)
