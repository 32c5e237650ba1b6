"""The cell templates the two facades build from the material XMLs of
``tools/cell_templates``, in a configuration directory written in code
(RBC_MALARIA's ``vRBC_uniform.stl`` too, a binary STL of a biconcave
shape whose header begins with "solid"):

  (a) a material XML with an ``<StlFile>`` makes both facades build the
      STL's mesh and the same inner edges; an ``<StlFile>`` that names no
      file raises the same error in both;
  (b) both facades build the same template mesh (vertex count, positions
      to 1e-12 in f64, triangles) and the same inner edges for each
      template, the STL-based RBC_MALARIA among them;
  (c) ``<InnerEdges>`` ids of an STL mesh are taken as they stand when they
      index its vertices, else the mirror pairs.
"""

import os
import re
import shutil

import numpy as np
import pytest

from hemocell_tpu import HemoCell as JaxHemoCell
from hemocell_tpu_torch import HemoCell
from hemocell_tpu_torch.mesh import generate
from test_torch_mesh_stl import write_binary_stl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = os.path.join(REPO, "tools", "cell_templates")
CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm><stepMaterialEvery> 20 </stepMaterialEvery><stepParticleEvery> 5 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><Re> 0.5 </Re></domain>
</hemocell>
"""
MODELS = (("RBC", "RbcHighOrderModel"), ("PLT", "PltSimpleModel"),
          ("WBC", "WbcHighOrderModel"), ("RBC_MALARIA", "RbcMalariaModel"))

# a regular octahedron of unit radius: 6 vertices, 8 facets
_OCTA = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 dtype=np.float64)
_OCTA_FACETS = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
                (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]


def _write_octahedron_stl(path):
    lines = ["solid octahedron"]
    for a, b, c in _OCTA_FACETS:
        n = np.cross(_OCTA[b] - _OCTA[a], _OCTA[c] - _OCTA[a])
        n = n / np.linalg.norm(n)
        lines.append(f"facet normal {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}")
        lines.append("outer loop")
        lines += [f"vertex {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in _OCTA[[a, b, c]]]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid octahedron")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _set_stl(xml, stl_name, inner_edges=None):
    """Name ``stl_name`` in the material XML's <StlFile> (added or
    replaced), and with ``inner_edges`` set its <InnerEdges> to those ids."""
    text = re.sub(r"\s*<StlFile>.*?</StlFile>", "", xml.read_text())
    text = re.sub(r"\s*<InnerEdges>.*?</InnerEdges>", "", text, flags=re.S)
    extra = f"    <StlFile>{stl_name}</StlFile>\n"
    if inner_edges is not None:
        extra += ("    <InnerEdges>" + "".join(f"<Edge>{a} {b}</Edge>" for a, b in inner_edges)
                  + "</InnerEdges>\n")
    xml.write_text(text.replace("</MaterialModel>", extra + "</MaterialModel>"))


@pytest.fixture
def config_dir(tmp_path):
    (tmp_path / "config.xml").write_text(CONFIG_XML)
    for name, _ in MODELS:
        shutil.copy(os.path.join(TEMPLATES, f"{name}_template.xml"),
                    tmp_path / f"{name}.xml")
    # the malaria template's mesh, not in the repository: a biconcave cell
    rbc = generate.rbc_from_sphere(1.0, 320)
    write_binary_stl(tmp_path / "vRBC_uniform.stl", rbc.vertices, rbc.triangles,
                     header=b"solid vRBC written as binary")
    return tmp_path


def _both(config_dir, name, model):
    path = str(config_dir / "config.xml")
    jhc = JaxHemoCell(path)
    jhc.add_cell_type(name, model)
    thc = HemoCell(path, device="cpu")
    thc.add_cell_type(name, model)
    return jhc.cell_types[0], thc.cell_types[0]


@pytest.mark.parametrize("name,model", MODELS)
def test_stl_file_raises(config_dir, name, model):
    """An <StlFile> makes both facades build the STL's own mesh (the
    octahedron's 6 vertices) with the same inner edges; one that names no
    file raises the same error in both."""
    _write_octahedron_stl(config_dir / "octa.stl")
    xml = config_dir / f"{name}.xml"
    _set_stl(xml, "octa.stl")
    jct, tct = _both(config_dir, name, model)
    assert tct.mesh.num_vertices == jct.mesh.num_vertices == 6
    np.testing.assert_allclose(tct.mesh.vertices, jct.mesh.vertices, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tct.mesh.triangles, jct.mesh.triangles)
    np.testing.assert_array_equal(np.asarray(tct.topo.inner_edges),
                                  np.asarray(jct.topo.inner_edges))
    assert tct.num_vertices == 6 and tct.volume_um3 == jct.volume_um3
    _set_stl(xml, "missing.stl")
    path = str(config_dir / "config.xml")
    with pytest.raises(FileNotFoundError):
        JaxHemoCell(path).add_cell_type(name, model)
    thc = HemoCell(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        thc.add_cell_type(name, model)
    assert thc.cell_types == []


@pytest.mark.parametrize("ids_in_range", [True, False])
def test_stl_inner_edge_ids(config_dir, ids_in_range):
    """The malaria template from its STL with <InnerEdges>: ids that index
    the STL's vertices are its inner edges in both facades; an id past them
    makes both take the mirror pairs."""
    nv = generate.mesh_from_stl(str(config_dir / "vRBC_uniform.stl"), 1.0).num_vertices
    ids = [(0, 5), (3, 17), (40, nv - 1 if ids_in_range else nv)]
    _set_stl(config_dir / "RBC_MALARIA.xml", "vRBC_uniform.stl", ids)
    jct, tct = _both(config_dir, "RBC_MALARIA", "RbcMalariaModel")
    ti = np.asarray(tct.topo.inner_edges)
    np.testing.assert_array_equal(ti, np.asarray(jct.topo.inner_edges))
    if ids_in_range:
        np.testing.assert_array_equal(ti, ids)
    else:
        assert len(ti) > len(ids)


@pytest.mark.parametrize("name,model", MODELS)
def test_templates_agree(config_dir, name, model):
    path = str(config_dir / "config.xml")
    jhc = JaxHemoCell(path)
    jhc.add_cell_type(name, model)
    thc = HemoCell(path, device="cpu")
    thc.add_cell_type(name, model)
    jm, tm = jhc.cell_types[0].mesh, thc.cell_types[0].mesh
    assert tm.num_vertices == jm.num_vertices > 6
    jv = np.asarray(jm.vertices, dtype=np.float64)
    tv = np.asarray(tm.vertices, dtype=np.float64)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(tm.triangles), np.asarray(jm.triangles))


@pytest.mark.parametrize("name,model", MODELS)
def test_inner_edges_agree(config_dir, name, model):
    path = str(config_dir / "config.xml")
    jhc = JaxHemoCell(path)
    jhc.add_cell_type(name, model)
    thc = HemoCell(path, device="cpu")
    thc.add_cell_type(name, model)
    ji = np.asarray(jhc.cell_types[0].topo.inner_edges)
    ti = np.asarray(thc.cell_types[0].topo.inner_edges)
    np.testing.assert_array_equal(ti, ji)
    # the PLT template asks for the transverse stiffening pairs, the RBC's not
    assert (len(ti) > 0) == (name == "PLT")
