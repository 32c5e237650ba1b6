"""Cell meshes from STL files and the other mesh sources of the port
(``hemocell_tpu_torch.mesh``) against the JAX package's, on the CPU:

  (a) an ASCII STL, a binary STL and a binary STL whose 80-byte header
      begins with "solid" (the ASCII reader finds no vertex in it, and the
      binary reader must take over), all written in code from a perturbed
      icosphere, through both packages' ``mesh_from_stl``: vertices to
      1e-12, triangles exact, the source mesh's vertices found again;
  (b) ``construct_mesh`` equal for every construct type, its refusals
      equal;
  (c) ``MeshMetrics`` and the ``SurfaceMesh`` transforms equal.
"""

import numpy as np
import pytest

from hemocell_tpu.mesh import MeshMetrics as JMeshMetrics
from hemocell_tpu.mesh import generate as jgen
from hemocell_tpu_torch.mesh import MeshMetrics, generate

CONSTRUCT_TYPES = ("RBC_FROM_SPHERE", "RBC", "ELLIPSOID_FROM_SPHERE", "PLT", "ELLIPSOID",
                   "MESH_FROM_STL", "STL", "SPHERE", "WBC_SPHERE",
                   "SPHERE_FROM_ICOSAHEDRON", "wbc_sphere")


def _source_mesh():
    """A perturbed icosphere (162 vertices, 320 triangles): no two vertices
    at one point, no symmetry that would hide a reordering."""
    mesh = generate.icosphere(320)
    rng = np.random.default_rng(5)
    return mesh.vertices * 3.0 + 0.05 * rng.standard_normal(mesh.vertices.shape), \
        mesh.triangles


def _facets(verts, tris):
    v = verts[tris]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    return v, n / np.linalg.norm(n, axis=1, keepdims=True)


def write_ascii_stl(path, verts, tris):
    v, n = _facets(verts, tris)
    lines = ["solid cell"]
    for nn, tri in zip(n, v):
        lines += [f"  facet normal {nn[0]:.9e} {nn[1]:.9e} {nn[2]:.9e}", "    outer loop"]
        lines += [f"      vertex {p[0]:.17e} {p[1]:.17e} {p[2]:.17e}" for p in tri]
        lines += ["    endloop", "  endfacet"]
    lines.append("endsolid cell")
    path.write_text("\n".join(lines) + "\n")


def write_binary_stl(path, verts, tris, header=b"binary STL written in code"):
    v, n = _facets(verts, tris)
    rec = np.zeros(len(tris), dtype=[("f", "<f4", (12,)), ("attr", "<u2")])
    rec["f"] = np.concatenate([n[:, None, :], v], axis=1).reshape(-1, 12)
    path.write_bytes(header.ljust(80, b" ")[:80] + np.uint32(len(tris)).tobytes()
                     + rec.tobytes())


WRITERS = {
    "ascii": write_ascii_stl,
    "binary": write_binary_stl,
    "binary_solid_header": lambda p, v, t: write_binary_stl(
        p, v, t, header=b"solid exported as binary by a CAD tool"),
}


@pytest.fixture(scope="module")
def stl_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stl")
    verts, tris = _source_mesh()
    paths = {}
    for kind, write in WRITERS.items():
        paths[kind] = d / f"{kind}.stl"
        write(paths[kind], verts, tris)
    return verts, tris, paths


@pytest.mark.parametrize("kind", list(WRITERS))
def test_mesh_from_stl_matches_jax(stl_files, kind):
    verts, tris, paths = stl_files
    path = str(paths[kind])
    if kind == "binary_solid_header":
        assert open(path, "rb").read(5) == b"solid"
    jm = jgen.mesh_from_stl(path, 4.0)
    tm = generate.mesh_from_stl(path, 4.0)
    assert tm.vertices.dtype == np.float64 and tm.triangles.dtype == np.int32
    np.testing.assert_allclose(tm.vertices, jm.vertices, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    # the STL's 162 vertices come back, the largest extent scaled to the
    # diameter
    assert tm.num_vertices == len(verts) and tm.num_triangles == len(tris)
    assert np.ptp(tm.vertices, axis=0).max() == pytest.approx(8.0, rel=1e-12)
    src = verts - 0.5 * (verts.min(axis=0) + verts.max(axis=0))
    src = src * (8.0 / np.ptp(verts, axis=0).max())
    tol = 1e-5 if kind != "ascii" else 1e-12  # float32 in the binary files
    np.testing.assert_allclose(tm.vertices[tm.triangles], src[tris], rtol=0, atol=tol)
    # numbered in the order they first appear in the triangle list
    first = np.unique(tm.triangles.reshape(-1), return_index=True)[1]
    assert np.all(np.diff(first) > 0)


def test_read_stl_falls_through_to_binary(stl_files):
    _, _, paths = stl_files
    with pytest.raises(ValueError, match="ASCII STL"):
        generate._read_stl_ascii(str(paths["binary_solid_header"]))
    np.testing.assert_array_equal(generate._read_stl(str(paths["binary_solid_header"])),
                                  generate._read_stl_binary(str(paths["binary"])))


@pytest.mark.parametrize("construct", CONSTRUCT_TYPES)
def test_construct_mesh_matches_jax(stl_files, construct):
    _, _, paths = stl_files
    stl = str(paths["binary_solid_header"])
    jm = jgen.construct_mesh(construct, 4.1, 600, 0.3, stl)
    tm = generate.construct_mesh(construct, 4.1, 600, 0.3, stl)
    np.testing.assert_allclose(tm.vertices, jm.vertices, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    assert tm.num_vertices > 6


def test_construct_mesh_refusals_match_jax():
    for args in (("MESH_FROM_STL", 4.0), ("CUBE", 4.0)):
        with pytest.raises(ValueError) as jerr:
            jgen.construct_mesh(*args)
        with pytest.raises(ValueError) as terr:
            generate.construct_mesh(*args)
        assert str(terr.value) == str(jerr.value)


def test_mesh_metrics_and_transforms_match_jax(stl_files):
    _, _, paths = stl_files
    for construct in ("RBC_FROM_SPHERE", "ELLIPSOID_FROM_SPHERE", "WBC_SPHERE", "STL"):
        tm = generate.construct_mesh(construct, 3.9, 600, 0.3, str(paths["ascii"]))
        jm = jgen.construct_mesh(construct, 3.9, 600, 0.3, str(paths["ascii"]))
        t, j = MeshMetrics(tm), JMeshMetrics(jm)
        for name in ("area", "volume", "mean_edge_length", "min_edge_length",
                     "max_edge_length"):
            assert getattr(t, name) == pytest.approx(getattr(j, name), rel=1e-12), name
        np.testing.assert_allclose(t.triangle_areas, j.triangle_areas, rtol=1e-12)
        assert t.volume > 0.0
        assert t.describe() == j.describe()
    rot = generate.euler_zxz(0.3, 1.1, -0.4)
    np.testing.assert_array_equal(rot, jgen.euler_zxz(0.3, 1.1, -0.4))
    for op, arg in (("translated", (1.0, -2.0, 0.5)), ("scaled", 1.7), ("rotated", rot)):
        np.testing.assert_array_equal(getattr(tm, op)(arg).vertices,
                                      getattr(jm, op)(arg).vertices, err_msg=op)
        np.testing.assert_array_equal(getattr(tm, op)(arg).triangles, jm.triangles)
