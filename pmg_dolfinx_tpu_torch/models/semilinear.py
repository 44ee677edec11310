"""Semilinear reaction-diffusion models:

    -div(kappa grad u) + sigma u + N(u) = f      on the unit cube,
    u = 0 on Dirichlet faces,

with a pointwise nonlinearity ``N`` collocated at the GLL nodes, so the
discrete nonlinear term is ``m3 * N(u)`` with the lumped mass ``m3`` (the
mechanism of the linear shift ``sigma * m3 * u``). Solved by the inexact
Newton loop of `solvers.newton` with the hierarchy's V-cycle as the
preconditioner of every linear step, or stepped in time by the evolvers
of `solvers.transient`.

Port of `pmg_dolfinx_tpu.models.semilinear`: ``N``/``dN`` act on torch
tensors, ``N_np``/``dN_np`` on numpy arrays (manufactured sources and
host oracles). The products keep the JAX package's order (``c * u * u *
u``), so float64 results match it bit for bit.
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .poisson import u_exact


@dataclass(frozen=True)
class Nonlinearity:
    """A pointwise nonlinearity ``N`` and its derivative ``N'``: ``N``/``dN``
    on torch tensors (inside the Newton steps and the time steppers),
    ``N_np``/``dN_np`` their numpy twins."""

    name: str
    N: Callable
    dN: Callable
    N_np: Callable
    dN_np: Callable


def cubic(c: float = 1.0) -> Nonlinearity:
    """``N(u) = c u^3``: monotone for ``c >= 0`` (the Jacobian stays SPD,
    so Newton with an FCG(V) inner solve is safe)."""
    c = float(c)
    return Nonlinearity(
        name=f"cubic(c={c:g})",
        N=lambda u: c * u * u * u,
        dN=lambda u: 3.0 * c * u * u,
        N_np=lambda u: c * u**3,
        dN_np=lambda u: 3.0 * c * u**2,
    )


def bratu(lam: float = 1.0) -> Nonlinearity:
    """Bratu-Gelfand ``-lap u - lam e^u = 0``, i.e. ``N(u) = -lam e^u``.
    The Jacobian ``A - lam e^u M`` is SPD below the fold (lam* ~ 6.8 on
    the unit cube); ``f = 0``, the solution is positive inside."""
    lam = float(lam)
    return Nonlinearity(
        name=f"bratu(lam={lam:g})",
        N=lambda u: -lam * torch.exp(u),
        dN=lambda u: -lam * torch.exp(u),
        N_np=lambda u: -lam * np.exp(u),
        dN_np=lambda u: -lam * np.exp(u),
    )


def f_rhs_semilinear(kappa: float, nonlin: Nonlinearity, sigma: float = 0.0):
    """Manufactured source for ``-kappa lap u + sigma u + N(u) = f`` with
    ``u_e = sin(pi x) sin(pi y) sin(pi z)``: ``f = (3 pi^2 kappa + sigma)
    u_e + N(u_e)``."""

    def f(x):
        ue = u_exact(x)
        return (3.0 * np.pi**2 * kappa + sigma) * ue + nonlin.N_np(ue)

    return f
