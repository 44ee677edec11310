"""Carry hierarchy state between the JAX package and the port.

`hierarchy_data_from_numpy` turns a JAX `PMGHierarchy.data` tree, already
converted to numpy (``jax.tree.map(np.asarray, hier.data)``), into the
port's data layout: ``levels`` and ``transfer`` lists of dicts of
tensors plus the optional ``fdm`` dict. Every operator family carries
over under the JAX names: the Kronecker levels (``kb_mats`` ...), the
lattice family (``Gt``, ``lb_mats``, ``G``, ``E*``/``D*``, ``m3``) and
the dofmap levels (``dofmap``, ``G``, ``coeff``, ``D``), with
``diag_inv``, ``lmax`` and the transfers (``I*`` or ``M1``,
``dofmap_c``/``dofmap_f``, ``mult_f``). Pass the result to the port's
`PMGHierarchy.load_state` to run its cycles on the JAX state (the
calibrated ``lmax`` included), so cycle parity is tested apart from
calibration parity.
"""

import numpy as np
import torch


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype == np.bool_:
        return torch.tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.tensor(arr, dtype=torch.int64, device=device)
    return torch.tensor(arr, dtype=dtype, device=device)


def hierarchy_data_from_numpy(tree, device, dtype):
    """Port-layout hierarchy data (``levels``, ``transfer``, ``fdm``)
    from a numpy copy of the JAX hierarchy's data tree; float arrays are
    cast to ``dtype``, bool markers stay bool, integer dofmaps become
    int64."""
    out = {
        "levels": _convert(list(tree["levels"]), device, dtype),
        "transfer": _convert(list(tree["transfer"]), device, dtype),
    }
    if "fdm" in tree:
        out["fdm"] = _convert(tree["fdm"], device, dtype)
    return out
