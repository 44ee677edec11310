"""Solver-state checkpoint / restart.

Port of `pmg_dolfinx_tpu.utils.checkpoint`: the stationary or refined
iteration state (the iterate, the residual history, the cycle count and a
fingerprint of the problem) in one portable ``.npz``, the same file as
the JAX package's, so either package resumes from the other's. The
fingerprint (cell counts, degrees, kappa) guards against resuming onto
another discretisation.
"""

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else (
        np.asarray(a))


def _fingerprint(mesh, degrees, kappa):
    return np.array(
        [*mesh.nc, *[int(p) for p in degrees], float(kappa)], dtype=np.float64
    )


def save_state(path, mesh, degrees, kappa, u, rnorms, cycle):
    """Write ``u`` (numpy or a tensor on any device), the residual norms
    and the cycle count with the problem's fingerprint to ``path``."""
    np.savez(
        path,
        fingerprint=_fingerprint(mesh, degrees, kappa),
        u=_host(u),
        rnorms=np.asarray(rnorms, dtype=np.float64),
        cycle=np.int64(cycle),
    )


def load_state(path, mesh, degrees, kappa):
    """Return ``(u, rnorms, cycle)`` (``u`` a host numpy array); raises
    ValueError if the checkpoint belongs to a different problem."""
    data = np.load(path)
    expect = _fingerprint(mesh, degrees, kappa)
    if not np.array_equal(data["fingerprint"], expect):
        raise ValueError(
            "checkpoint fingerprint mismatch: saved for a different "
            f"problem (saved {data['fingerprint']}, expected {expect})"
        )
    return data["u"], list(data["rnorms"]), int(data["cycle"])
