"""Line-relaxation preconditioner for strongly anisotropic problems.

Port of `pmg_dolfinx_tpu.solvers.line`. Whole lines of dofs along the
strongly-coupled axis are relaxed together: the per-line banded blocks
(half-bandwidth P along the line) are extracted from the assembled
p-level matrix at setup (host, float64) and inverted densely, so the
preconditioner apply is one batched dense matvec ``einsum("lij,lj->li")``
over all lines, as the JAX package leaves it to XLA. Memory is ``ndofs *
line length`` floats; the builder refuses past `LINE_BLOCK_DOF_LIMIT`.
"""

import numpy as np
import torch

# Cap on line_inv floats (= ndofs * line length). Setup binds first: the
# blocks come from the assembled global matrix, ndofs*(2P+1)^3 nonzeros,
# fine through ~500k dofs at p=3 or ~2M at p=1, hopeless at p=6/2M+.
LINE_BLOCK_DOF_LIMIT = 200_000_000


def line_block_inverses(mesh, P, kappa, axis, sigma=0.0):
    """Dense inverses of the within-line blocks of the assembled operator:
    ``(nlines, n, n)`` float64 with ``n = lattice_shape[axis]``.

    Two dofs are in one line iff their lattice indices differ only along
    ``axis``; the block is the restriction of the bc-applied stiffness
    (plus the ``sigma`` lumped-mass shift) to that line. Dirichlet rows
    and columns are zeroed with unit diagonal, so boundary dofs stay
    decoupled through the inverse. The size guard runs before the
    assembly."""
    import scipy.sparse as sp

    from ..fem.assembly import assemble_stiffness, lumped_mass_np

    shape = mesh.lattice_shape(P)
    N = int(np.prod(shape))
    n = shape[axis]
    if N * n > LINE_BLOCK_DOF_LIMIT:
        raise ValueError(
            f"line smoother blocks would hold {N * n} floats "
            f"({N} dofs x line length {n}) > {LINE_BLOCK_DOF_LIMIT}; "
            "keep line relaxation to the coarse p-levels / h-MG levels "
            "at this size"
        )
    A = assemble_stiffness(mesh, P, kappa=kappa).tocsr()
    if sigma:
        A = (A + sp.diags(sigma * lumped_mass_np(mesh, P, bc_zero=True))
             ).tocsr()
    # Permute dofs so `axis` is fastest: the blocks are the size-n diagonal
    # blocks of the permuted matrix, taken from the COO entries whose row
    # and column fall in the same line.
    order = np.moveaxis(np.arange(N).reshape(shape), axis, -1).ravel()
    Ap = A[order][:, order].tocoo()
    same_line = (Ap.row // n) == (Ap.col // n)
    r, c, v = Ap.row[same_line], Ap.col[same_line], Ap.data[same_line]
    blocks = np.zeros((N // n, n, n))
    blocks[r // n, r % n, c % n] = v
    return np.linalg.inv(blocks)


def stacked_lead(r, shape):
    """The leading (shard) dims of ``r`` over the local lattice ``shape``:
    ``()`` for one lattice (flat or 3D), the dims before the last three
    of a stacked tensor, ``(S,)`` for a flat stack of ``S`` lattices (the
    slab layout of the general backends, `parallel.dist`)."""
    if r.dim() > 3:
        return tuple(r.shape[:-3])
    n = shape[0] * shape[1] * shape[2]
    return () if r.numel() == n else (r.numel() // n,)


def line_precond_apply(line_inv, r, shape, axis):
    """Apply the line preconditioner ``r -> T^-1 r`` (shape-preserving).

    ``r`` is flat, lattice-shaped, a device grid's stacked ``(sx, sy,
    sz) + shape`` tensor or a slab stack (``(S,) + shape`` or flat,
    `stacked_lead`); ``line_inv`` flattens to the line order of
    ``movedim(r, axis, -1)`` (for the stacked layout: shard axes first,
    the two non-line local axes, then the line). One batched dense matvec
    over all lines."""
    lead = stacked_lead(r, shape)
    rm = torch.movedim(r.reshape(lead + tuple(shape)), len(lead) + axis, -1)
    mshape = rm.shape
    n = mshape[-1]
    y = torch.einsum("lij,lj->li", line_inv.reshape(-1, n, n),
                     rm.reshape(-1, n))
    return torch.movedim(y.reshape(mshape), -1, len(lead) + axis).reshape(
        r.shape)


def shard_line_blocks(blocks, gshape, axis, starts_per_lead):
    """Global ``(nlines, n, n)`` block inverses -> the duplicated-plane lead
    layout of a sharded class: ``(L0, L1, n, n)`` over the two non-line
    axes. ``starts_per_lead`` gives per lead axis ``None`` (unsharded) or
    ``(starts, npl)``: each shard's ``npl`` planes from ``starts[s]``
    (interface planes on both shards, so duplicated lines hold identical
    blocks)."""
    n = gshape[axis]
    lead = tuple(gshape[a] for a in range(3) if a != axis)
    blocks = np.asarray(blocks).reshape(lead + (n, n))
    for i, sp in enumerate(starts_per_lead):
        if sp is None:
            continue
        starts, npl = sp
        blocks = np.concatenate(
            [np.take(blocks, range(x0, x0 + npl), axis=i)
             for x0 in starts],
            axis=i,
        )
    return blocks


def parse_line_smoother(smoother, mesh, kappa, allowed=None):
    """Resolve a ``smoother`` spec to a line axis (or None).

    'cheb' -> None (point-Jacobi Chebyshev); 'line' -> the axis with the
    strongest effective coupling ``mean(kappa_aa)/h_a^2``
    (`solvers.hmg.axis_coupling`); 'line-x' / 'line-y' / 'line-z' -> that
    axis. ``allowed`` (a sharded class's unsharded axes) only breaks ties
    of 'line' among equally strong axes in favour of an allowed one."""
    if smoother in (None, "cheb"):
        return None
    if smoother == "line":
        from .hmg import axis_coupling

        c = axis_coupling(mesh, kappa)
        best = int(np.argmax(c))
        if allowed is not None and best not in allowed:
            ties = [a for a in allowed if c[a] == c[best]]
            if ties:
                return ties[0]
        return best
    if smoother in ("line-x", "line-y", "line-z"):
        return "xyz".index(smoother[-1])
    raise ValueError(
        f"unknown hmg smoother {smoother!r}: expected 'cheb', 'line' "
        "or 'line-x'/'line-y'/'line-z'"
    )
