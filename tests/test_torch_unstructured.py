"""The port's unstructured hex meshes (`fem/unstructured.py`) against the
JAX package.

- the geometric merge, the DSS renumbering and every layout table, the
  coordinates, the boundary marker and the multiplicity equal JAX's
  exactly on the L-shape at n = 1-3 and p = 1-6, and on rotated corner
  frames (the port finds the merged components with
  `connected_components` where JAX runs a Python union-find);
- the tests of JAX's ``tests/test_unstructured.py`` on the port: the box
  round trip, the L-shape's convergence rate, rotated frames, the npz and
  Gmsh v2.2 / v4.1 readers (physical groups included, written into
  ``tmp_path``), the Dirichlet guards, DG-0 kappa with sigma;
- the general backends take the duck-typed mesh: the ``dofmap``
  hierarchy on ``l_shaped_hex_mesh(2)`` (which raised on the box-only
  ``mesh.dirichlet_faces`` before) cycles as JAX's;
- `examples/unstructured_torch.py --device cpu --dtype f64 --demo-n 2`
  prints JAX's `examples/unstructured.py` iteration count and L2 error.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
from itertools import permutations

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

from pmg_dolfinx_tpu.fem import unstructured as ju  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import unstructured as tu  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import (  # noqa: E402
    assemble_rhs,
    assemble_stiffness,
    l2_error_collocated,
)
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402

PI = np.pi
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _u_exact(x):
    return np.sin(PI * x[0]) * np.sin(PI * x[1]) * np.sin(PI * x[2])


def _f_rhs(x):
    return 3.0 * PI**2 * _u_exact(x)


def _frames():
    """The 24 rotations of the cube as signed axis permutations."""
    out = []
    for perm in permutations(range(3)):
        for signs in np.ndindex(2, 2, 2):
            M = np.zeros((3, 3))
            for r, (p, s) in enumerate(zip(perm, signs)):
                M[r, p] = 1 - 2 * s
            if np.linalg.det(M) > 0:
                out.append(M)
    return out


def _rotated_cells(cells, seed):
    """Every cell's corner frame rotated independently (all dihedral
    orientations of the shared faces and edges)."""
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)]) - 0.5
    frames = _frames()
    rng = np.random.default_rng(seed)
    rot = np.empty_like(cells)
    for c in range(len(cells)):
        newc = corners @ frames[rng.integers(len(frames))].T
        rot[c] = cells[c, [int(np.argmin(np.abs(corners - p).sum(1)))
                           for p in newc]]
    return rot


def _assert_same_space(mt, mj, P):
    assert mt.num_dofs(P) == mj.num_dofs(P)
    assert np.array_equal(mt.dofmap(P), mj.dofmap(P))
    assert np.array_equal(mt.dof_coords(P), mj.dof_coords(P))
    assert np.array_equal(mt.boundary_dof_marker(P), mj.boundary_dof_marker(P))
    assert np.array_equal(mt.dof_multiplicity(P), mj.dof_multiplicity(P))
    lt, lj = mt.dss_layout(P), mj.dss_layout(P)
    assert set(lt) == set(lj)
    for k in lj:
        a, b = np.asarray(lt[k]), np.asarray(lj[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


_MERGE_CASES = ([(n, P, None) for n in (1, 2, 3) for P in range(1, 7)]
                + [(n, P, seed) for n, seed in ((2, 0), (3, 5))
                   for P in (2, 3, 6)])


@pytest.mark.parametrize("n,P,seed", _MERGE_CASES)
def test_merge_and_tables_equal_jax(n, P, seed):
    mj = ju.l_shaped_hex_mesh(n)
    if seed is not None:
        cells = _rotated_cells(np.asarray(mj.geometry_dofmap), seed)
        mj = ju.UnstructuredHexMesh(mj.geometry_x, cells)
        mt = tu.UnstructuredHexMesh(mj.geometry_x, cells)
    else:
        mt = tu.l_shaped_hex_mesh(n)
        assert np.array_equal(mt.geometry_x, mj.geometry_x)
        assert np.array_equal(mt.geometry_dofmap, mj.geometry_dofmap)
    _assert_same_space(mt, mj, P)
    assert mt._boundary_cell_faces() == mj._boundary_cell_faces()
    assert mt.tol == mj.tol


def test_box_geometry_roundtrip_exact():
    bm = BoxMesh((2, 3, 2))
    um = tu.UnstructuredHexMesh(bm.geometry_x, bm.geometry_dofmap)
    P = 3
    assert um.num_dofs(P) == bm.num_dofs(P)
    d, idx = cKDTree(bm.dof_coords(P)).query(um.dof_coords(P))
    assert d.max() < 1e-12
    Ab = assemble_stiffness(bm, P, kappa=2.0).toarray()
    Au = assemble_stiffness(um, P, kappa=2.0).toarray()
    assert np.abs(Au - Ab[np.ix_(idx, idx)]).max() < 1e-14
    assert np.array_equal(um.boundary_dof_marker(P),
                          bm.boundary_dof_marker(P)[idx])
    assert np.array_equal(um.dof_multiplicity(P),
                          bm.dof_multiplicity(P)[idx])
    _assert_same_space(um, ju.UnstructuredHexMesh(bm.geometry_x,
                                                  bm.geometry_dofmap), P)


def test_l_shape_manufactured_convergence():
    P = 2
    errs = []
    for n in (2, 4):
        mesh = tu.l_shaped_hex_mesh(n)
        b = assemble_rhs(mesh, P, _f_rhs)
        hier = PMGHierarchy(mesh, degrees=(1, P), kappa=1.0, coarse="direct",
                            operator="dofmap", device="cpu")
        u, niter = hier.solve_pcg(b, rtol=1e-10)
        assert niter <= 12
        errs.append(l2_error_collocated(mesh, P, u.numpy(), _u_exact))
    rate = np.log2(errs[0] / errs[1])
    assert rate > P + 0.5, (errs, rate)
    hc = PMGHierarchy(mesh, degrees=(1, P), kappa=1.0, coarse="direct",
                      operator="csr", device="cpu")
    uc, nc_ = hc.solve_pcg(b, rtol=1e-10)
    assert nc_ == niter
    assert (np.linalg.norm(uc.numpy() - u.numpy())
            < 1e-9 * np.linalg.norm(u.numpy()))


def test_rotated_corner_frames_are_equivalent():
    P = 3
    base = tu.l_shaped_hex_mesh(2)
    rot = tu.UnstructuredHexMesh(base.geometry_x,
                                 _rotated_cells(base.geometry_dofmap, 11))
    assert rot.num_dofs(P) == base.num_dofs(P)
    out = []
    for mesh in (base, rot):
        b = assemble_rhs(mesh, P, _f_rhs)
        hier = PMGHierarchy(mesh, degrees=(1, P), kappa=1.0, coarse="direct",
                            operator="dofmap", device="cpu")
        u, _ = hier.solve_pcg(b, rtol=1e-11)
        out.append((mesh.dof_coords(P), u.numpy()))
    (cb, ub), (cr, ur) = out
    d, idx = cKDTree(cb).query(cr)
    assert d.max() < 1e-12
    assert np.linalg.norm(ur - ub[idx]) < 1e-9 * np.linalg.norm(ub)


def test_npz_roundtrip(tmp_path):
    mesh = tu.l_shaped_hex_mesh(2)
    path = tmp_path / "l.npz"
    np.savez(path, nodes=mesh.geometry_x, cells=mesh.geometry_dofmap)
    loaded = tu.load_hex_mesh_npz(path)
    P = 2
    _assert_same_space(loaded, ju.load_hex_mesh_npz(path), P)
    A0 = assemble_stiffness(mesh, P).toarray()
    assert np.abs(assemble_stiffness(loaded, P).toarray() - A0).max() < 1e-14
    inv = np.argsort(tu.GMSH_HEX_PERM)
    np.savez(tmp_path / "g.npz", nodes=mesh.geometry_x,
             cells=mesh.geometry_dofmap[:, inv],
             corner_order=np.array("gmsh"))
    lg = tu.load_hex_mesh_npz(tmp_path / "g.npz")
    assert np.abs(assemble_stiffness(lg, P).toarray() - A0).max() < 1e-14


def _two_hex_msh(version):
    bm = BoxMesh((2, 1, 1), extent=(2.0, 1.0, 1.0))
    inv = np.argsort(tu.GMSH_HEX_PERM)
    nodes, cells_g = bm.geometry_x, bm.geometry_dofmap[:, inv]
    buf = io.StringIO()
    if version == "2.2":
        buf.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
        buf.write(f"{len(nodes)}\n")
        for i, p in enumerate(nodes):
            buf.write(f"{i + 10} {p[0]} {p[1]} {p[2]}\n")
        buf.write("$EndNodes\n$Elements\n3\n1 15 2 0 1 10\n")
        for e, cell in enumerate(cells_g):
            buf.write(f"{e + 2} 5 2 0 1 "
                      + " ".join(str(v + 10) for v in cell) + "\n")
        buf.write("$EndElements\n")
        return bm, buf.getvalue()
    n0 = len(nodes) // 2
    buf.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$Nodes\n")
    buf.write(f"2 {len(nodes)} 5 {len(nodes) + 4}\n")
    for tag, rng in ((1, range(n0)), (2, range(n0, len(nodes)))):
        buf.write(f"3 {tag} 0 {len(rng)}\n")
        for i in rng:
            buf.write(f"{i + 5}\n")
        for i in rng:
            buf.write(f"{nodes[i][0]} {nodes[i][1]} {nodes[i][2]}\n")
    buf.write("$EndNodes\n$Elements\n")
    buf.write(f"2 {len(cells_g) + 1} 1 {len(cells_g) + 1}\n0 1 15 1\n1 5\n")
    buf.write(f"3 1 5 {len(cells_g)}\n")
    for e, cell in enumerate(cells_g):
        buf.write(f"{e + 2} " + " ".join(str(v + 5) for v in cell) + "\n")
    buf.write("$EndElements\n")
    return bm, buf.getvalue()


@pytest.mark.parametrize("version", ["2.2", "4.1"])
def test_gmsh_reader(tmp_path, version):
    """Gmsh ASCII v2.2 and v4.1: two unit hexes sharing a face in Gmsh
    corner order, non-contiguous node ids, a skipped point element;
    the space equals BoxMesh((2,1,1))'s and JAX's reader's."""
    bm, text = _two_hex_msh(version)
    path = tmp_path / f"two{version}.msh"
    path.write_text(text)
    gm = tu.read_gmsh_hex(path)
    P = 3
    _assert_same_space(gm, ju.read_gmsh_hex(path), P)
    d, idx = cKDTree(bm.dof_coords(P)).query(gm.dof_coords(P))
    assert d.max() < 1e-12
    Ab = assemble_stiffness(bm, P, kappa=1.5).toarray()
    Ag = assemble_stiffness(gm, P, kappa=1.5).toarray()
    assert np.abs(Ag - Ab[np.ix_(idx, idx)]).max() < 1e-14


def test_mixed_dirichlet_marker_and_guards():
    sel = lambda x: x[2] < 0.5
    mesh = tu.l_shaped_hex_mesh(2, dirichlet=sel)
    P = 2
    m = mesh.boundary_dof_marker(P)
    c = mesh.dof_coords(P)
    assert m.any() and not m[c[:, 2] > 0.5].any()
    assert m[np.abs(c[:, 2]) < 1e-12].all()
    assert np.array_equal(
        m, ju.l_shaped_hex_mesh(2, dirichlet=sel).boundary_dof_marker(P))
    bm = BoxMesh((1, 1, 1))
    bad = bm.geometry_dofmap.copy()
    bad[0] = bad[0][[4, 5, 6, 7, 0, 1, 2, 3]]
    with pytest.raises(ValueError, match="Jacobian"):
        tu.UnstructuredHexMesh(bm.geometry_x, bad)
    with pytest.raises(ValueError, match="Neumann"):
        tu.l_shaped_hex_mesh(2, dirichlet=lambda x: x[0] > 99.0) \
            .boundary_dof_marker(2)
    with pytest.raises(ValueError, match="cells"):
        tu.UnstructuredHexMesh(bm.geometry_x, np.zeros((1, 6), dtype=int))


def test_variable_kappa_and_sigma_on_unstructured():
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from pmg_dolfinx_tpu_torch.fem.assembly import lumped_mass_np

    mesh = tu.l_shaped_hex_mesh(2)
    P, sigma = 2, 3.0
    kap = 1.0 + np.random.default_rng(4).random(mesh.ncells)
    b = assemble_rhs(mesh, P, _f_rhs)
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kap, sigma=sigma,
                        coarse="direct", operator="dofmap", device="cpu")
    u, _ = hier.solve_pcg(b, rtol=1e-12)
    A = (assemble_stiffness(mesh, P, kappa=kap).tocsr()
         + sigma * sp.diags(lumped_mass_np(mesh, P, bc_zero=True)))
    ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(u.numpy() - ref) < 1e-8 * np.linalg.norm(ref)


def _lshape_msh_text(n, version):
    """The L-shape as a Gmsh ASCII file with two physical surface
    groups: 'bottom' (z=0 faces) and 'top' (z=1 faces)."""
    mesh = tu.l_shaped_hex_mesh(n)
    nodes, cells = mesh.geometry_x, np.asarray(mesh.geometry_dofmap)
    cells_gmsh = cells[:, np.argsort(tu.GMSH_HEX_PERM)]
    quads = {1: [], 2: []}
    for c, fi in mesh._boundary_cell_faces():
        q = [int(cells[c, i]) for i in tu._FACES[fi][0]]
        z = nodes[q, 2]
        if np.allclose(z, 0.0):
            quads[1].append(q)
        elif np.allclose(z, 1.0):
            quads[2].append(q)
    head = ["$MeshFormat", f"{version} 0 8", "$EndMeshFormat",
            "$PhysicalNames", "2", '2 1 "bottom"', '2 2 "top"',
            "$EndPhysicalNames"]
    if version == "2.2":
        out = head + ["$Nodes", str(len(nodes))]
        out += [f"{i+1} {p[0]} {p[1]} {p[2]}" for i, p in enumerate(nodes)]
        out += ["$EndNodes", "$Elements",
                str(sum(len(v) for v in quads.values()) + len(cells))]
        eid = 1
        for phys, qs in quads.items():
            for q in qs:
                out.append(f"{eid} 3 2 {phys} {10+phys} "
                           + " ".join(str(v + 1) for v in q))
                eid += 1
        for e in cells_gmsh:
            out.append(f"{eid} 5 2 0 1 " + " ".join(str(v + 1) for v in e))
            eid += 1
        out.append("$EndElements")
        return "\n".join(out) + "\n"
    nq1, nq2, nc = len(quads[1]), len(quads[2]), len(cells)
    out = head + ["$Entities", "0 0 2 1", "11 0 0 0 2 2 1 1 1 0",
                  "12 0 0 0 2 2 1 1 2 0", "1 0 0 0 2 2 1 0 0",
                  "$EndEntities", "$Nodes", f"1 {len(nodes)} 1 {len(nodes)}",
                  f"3 1 0 {len(nodes)}"]
    out += [str(i + 1) for i in range(len(nodes))]
    out += [f"{p[0]} {p[1]} {p[2]}" for p in nodes]
    out += ["$EndNodes", "$Elements", f"3 {nq1+nq2+nc} 1 {nq1+nq2+nc}"]
    eid = 1
    for etag, qs in ((11, quads[1]), (12, quads[2])):
        out.append(f"2 {etag} 3 {len(qs)}")
        for q in qs:
            out.append(f"{eid} " + " ".join(str(v + 1) for v in q))
            eid += 1
    out.append(f"3 1 5 {nc}")
    for e in cells_gmsh:
        out.append(f"{eid} " + " ".join(str(v + 1) for v in e))
        eid += 1
    out.append("$EndElements")
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("version", ["2.2", "4.1"])
def test_gmsh_physical_groups_drive_mixed_bc(tmp_path, version):
    path = tmp_path / f"lshape_{version}.msh"
    path.write_text(_lshape_msh_text(2, version))
    mesh = tu.read_gmsh_hex(str(path), dirichlet=["bottom", "top"])
    assert set(mesh.tagged_faces) == {"bottom", "top"}
    jmesh = ju.read_gmsh_hex(str(path), dirichlet=["bottom", "top"])
    assert all(np.array_equal(mesh.tagged_faces[k], jmesh.tagged_faces[k])
               for k in jmesh.tagged_faces)
    ref = tu.l_shaped_hex_mesh(
        2, dirichlet=lambda x: (x[2] < 1e-12) | (x[2] > 1 - 1e-12))
    P = 2
    np.testing.assert_array_equal(mesh.boundary_dof_marker(P),
                                  ref.boundary_dof_marker(P))
    np.testing.assert_array_equal(mesh.boundary_dof_marker(P),
                                  jmesh.boundary_dof_marker(P))
    only_bottom = tu.read_gmsh_hex(str(path), dirichlet="bottom")
    mb = only_bottom.boundary_dof_marker(P)
    assert mb.sum() < mesh.boundary_dof_marker(P).sum()
    assert np.allclose(only_bottom.dof_coords(P)[mb][:, 2], 0.0)
    with pytest.raises(ValueError, match="unknown face group"):
        tu.read_gmsh_hex(str(path), dirichlet="sides").boundary_dof_marker(P)


def test_tagged_faces_internal_quad_rejected():
    base = tu.l_shaped_hex_mesh(2)
    cells = np.asarray(base.geometry_dofmap)
    keys = {}
    for c in range(base.ncells):
        for fi, (ids, _, _) in enumerate(tu._FACES):
            key = tuple(sorted(int(cells[c, i]) for i in ids))
            keys.setdefault(key, []).append((c, fi))
    internal = next(k for k, v in keys.items() if len(v) == 2)
    mesh = tu.UnstructuredHexMesh(
        base.geometry_x, cells, dirichlet="bad",
        tagged_faces={"bad": np.asarray([list(internal)])})
    with pytest.raises(ValueError, match="no topological boundary"):
        mesh.boundary_dof_marker(2)


def test_dofmap_hierarchy_takes_the_duck_typed_mesh():
    """The general path reads the box-only ``dirichlet_faces`` /
    ``has_robin`` / ``lattice_shape`` through JAX's defaults: the port's
    ``dofmap`` hierarchy on ``l_shaped_hex_mesh(2)`` (an AttributeError
    before) gives JAX's calibration, trajectory and FCG count (f64)."""
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JH

    mt, mj = tu.l_shaped_hex_mesh(2), ju.l_shaped_hex_mesh(2)
    b = assemble_rhs(mt, 3, _f_rhs)
    th = PMGHierarchy(mt, degrees=(1, 3), coarse="direct", operator="dofmap",
                      device="cpu")
    jh = JH(mj, degrees=(1, 3), coarse="direct", operator="dofmap")
    for et, ej in zip(th.eigs, jh.eigs):
        assert np.abs(np.asarray(et) - np.asarray(ej)).max() <= 1e-10 * abs(
            float(ej[-1]))
    _, rt = th.solve(torch.tensor(b), num_cycles=5)
    _, rj = jh.solve(jnp.asarray(b), num_cycles=5)
    assert np.max(np.abs(np.array(rt) - np.asarray(rj)) / np.asarray(rj)) \
        <= 1e-10
    ut, nt = th.solve_pcg(torch.tensor(b), rtol=1e-10)
    uj, nj = jh.solve_pcg(jnp.asarray(b), rtol=1e-10)
    assert nt == nj
    assert np.abs(ut.numpy() - np.asarray(uj)).max() <= 1e-10 * np.abs(
        np.asarray(uj)).max()


def _last_json(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_driver_prints_jax_driver_result():
    """`examples/unstructured_torch.py --device cpu --dtype f64 --demo-n 2`
    against `examples/unstructured.py --cpu --dtype f64 --demo-n 2`: the
    same FCG(V) count, the L2 error within 1e-10 relative."""
    flags = ["--dtype", "f64", "--demo-n", "2"]
    got = _last_json([sys.executable, "examples/unstructured_torch.py",
                      "--device", "cpu"] + flags)
    want = _last_json([sys.executable, "examples/unstructured.py",
                       "--cpu"] + flags)
    assert got["niter"] == want["niter"]
    assert abs(got["l2_error"] - want["l2_error"]) <= 1e-10 * want["l2_error"]
