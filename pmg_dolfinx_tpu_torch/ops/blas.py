"""BLAS-1 layer on dof vectors (single device).

Port of `pmg_dolfinx_tpu.ops.blas.inner_product`; the distributed
variants wait for the `torch.distributed` layer (ROADMAP.md, Queue 1
item 10).
"""

import torch


def inner_product(u, v):
    """Real dot product as a 0-d tensor on the vectors' device;
    shape-agnostic (lattice-shaped vectors reduce without a reshape)."""
    return torch.sum(u * v)
