# Copyright 2022 The JAX Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     https://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
#
# A torch translation of `lobpcg_standard` from
# `jax/experimental/sparse/linalg.py`: the same steps in the same order
# (orthonormal X, P, R blocks; SVQB orthonormalization twice; the
# residual basis projected out twice and truncated; the Rayleigh-Ritz
# eigensolve on the joint basis; the P update from the QR of Q's
# off-diagonal quadrant; the self-consistency convergence test), so on the
# same operator and start block it takes the same number of iterations.
# `torch.lobpcg` takes no callable operator and runs another algorithm.

"""Block LOBPCG for the top-k eigenpairs of a symmetric operator."""

import torch


def lobpcg_standard(A, X, m=100, tol=None):
    """Top-``k`` standard eigenpairs of a symmetric ``A`` by LOBPCG.

    ``A`` is an ``(n, n)`` tensor or a callable ``(n, j) -> (n, j)``; ``X``
    the ``(n, k)`` start block (numerically independent; ``0 < 5 k < n``);
    ``m`` the iteration cap; ``tol`` the convergence tolerance (the dtype's
    epsilon when None): a pair converges when ``|A v - lambda v| < tol *
    10 n (lambda + |A v|)``, and the loop exits once all ``k`` have.
    Returns ``(theta, U, i)``: the ``(k,)`` eigenvalues (descending), the
    ``(n, k)`` eigenvectors and the iteration count (a Python int; one
    host read per iteration).
    """
    if isinstance(A, torch.Tensor):
        M = A
        A = lambda V: M @ V
    n, k = X.shape
    dt = X.dtype
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(dt).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])

    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    i, converged = 0, 0
    while i < m and converged < k:
        # Residual basis selection.
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)

        # Projected eigensolve.
        theta, Q = _rayleigh_ritz_orth(A, XPR)

        # Eigenvector X extraction.
        B = Q[:, :k]
        normB = torch.linalg.vector_norm(B, ord=2, dim=0, keepdim=True)
        B = B / normB
        X = XPR @ B
        normX = torch.linalg.vector_norm(X, ord=2, dim=0, keepdim=True)
        X = X / normX

        # Difference terms P: concat(0, Q[k:, :k]) orthogonalized against
        # Q[:, :k] in the standard basis, then mapped with XPR.
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        diff_rayleigh_ortho = Q[:, k:] @ q
        P = XPR @ diff_rayleigh_ortho
        normP = torch.linalg.vector_norm(P, ord=2, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, torch.ones_like(normP), normP)

        # New residuals and the self-consistency convergence test.
        AX = A(X)
        R = AX - theta[None, :k] * X
        resid_norms = torch.linalg.vector_norm(R, ord=2, dim=0)
        reltol = torch.linalg.vector_norm(AX, ord=2, dim=0) + theta[:k]
        reltol = reltol * n
        reltol = reltol * 10
        converged = int(torch.sum(resid_norms < tol * reltol))
        theta = theta[None, :k]
        i += 1

    return theta[0, :], X, i


def _check_inputs(A, X):
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if test_output.dtype != X.dtype:
        raise ValueError(
            f"A, X must have same dtypes (were {test_output.dtype}, "
            f"{X.dtype})")
    if tuple(test_output.shape) != (n, 1):
        raise ValueError(
            f"A must be ({n}, {n}) matrix A, got output "
            f"{tuple(test_output.shape)}")


def _eigh_ascending(A):
    # Named after the JAX source; the eigenvalues come out descending.
    w, V = torch.linalg.eigh(A)
    return torch.flip(w, (0,)), torch.flip(V, (1,))


def _svqb(X):
    """A truncated orthonormal basis of ``X`` (SVQB: the eigenbasis of the
    ``(k, k)`` Gram matrix; degenerate directions are zeroed)."""
    norms = torch.linalg.vector_norm(X, ord=2, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)

    inner = X.T @ X
    w, V = _eigh_ascending(inner)

    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** (-0.5)

    scaledV = V * sqrted[None, :]
    orthoX = X @ scaledV

    keep = ((w > tau) * (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = torch.linalg.vector_norm(orthoX, ord=2, dim=0, keepdim=True)
    keep = keep * (norms > 0.0)
    orthoX = orthoX / torch.where(keep, norms, torch.ones_like(norms))
    return orthoX


def _project_out(basis, U):
    """The component of ``U`` in the orthogonal complement of the
    orthonormal (zero columns allowed) ``basis``: subtracted and
    orthonormalized twice, subtracted twice more, and near-zero columns
    zeroed, so ``[basis, U]`` stays zero-or-orthonormal."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.vector_norm(U, ord=2, dim=0, keepdim=True)
    U = U * (normU >= 0.99).to(U.dtype)
    return U


def _orthonormalize(basis):
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S):
    """Eigenpairs of ``S^T A S`` for the orthonormal ``S``."""
    SAS = S.T @ A(S)
    return _eigh_ascending(SAS)


def _extend_basis(X, m):
    """``m`` columns orthonormal to the orthonormal ``X``, from block
    Householder reflectors (deterministic, never overlapping ``X``)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat(
        [torch.eye(m, dtype=X.dtype, device=X.device),
         torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    h[k:] = h[k:] + other
    return h
