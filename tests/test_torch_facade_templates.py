"""The cell templates the two facades build from the material XMLs of
``tools/cell_templates``, in a configuration directory written in code:

  (a) a material XML with an ``<StlFile>`` makes the JAX facade build the
      STL's mesh; the port has no STL reader yet and must raise, not build
      its sphere-derived template in its place;
  (b) without one, both facades build the same template mesh (vertex count,
      positions to 1e-12 in f64, triangles) and the same inner edges.
"""

import os
import shutil

import numpy as np
import pytest

from hemocell_tpu import HemoCell as JaxHemoCell
from hemocell_tpu_torch import HemoCell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = os.path.join(REPO, "tools", "cell_templates")
CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm><stepMaterialEvery> 20 </stepMaterialEvery><stepParticleEvery> 5 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><Re> 0.5 </Re></domain>
</hemocell>
"""
MODELS = (("RBC", "RbcHighOrderModel"), ("PLT", "PltSimpleModel"))

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


@pytest.fixture
def config_dir(tmp_path):
    (tmp_path / "config.xml").write_text(CONFIG_XML)
    for name, _ in MODELS:
        shutil.copy(os.path.join(TEMPLATES, f"{name}_template.xml"),
                    tmp_path / f"{name}.xml")
    return tmp_path


@pytest.mark.parametrize("name,model", MODELS)
def test_stl_file_raises(config_dir, name, model):
    _write_octahedron_stl(config_dir / "octa.stl")
    xml = config_dir / f"{name}.xml"
    text = xml.read_text()
    assert "<StlFile>" not in text
    xml.write_text(text.replace("</MaterialModel>",
                                "    <StlFile>octa.stl</StlFile>\n</MaterialModel>"))
    path = str(config_dir / "config.xml")
    # the reference builds the STL's own mesh
    jhc = JaxHemoCell(path)
    jhc.add_cell_type(name, model)
    assert jhc.cell_types[0].mesh.num_vertices == 6
    thc = HemoCell(path, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        thc.add_cell_type(name, model)
    assert thc.cell_types == []


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
