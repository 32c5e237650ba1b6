"""Port membrane mechanics (hemocell_tpu_torch.mechanics) against the JAX
reference: rbc_ho_forces and plt_simple_forces batched over 3 deformed
cells, against the JAX functions vmap-ed, in f64 to 1e-10 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.mechanics import MaterialConstants, material_dict
from hemocell_tpu.mechanics import forces as jf
from hemocell_tpu.mesh import build_topology as j_build_topology
from hemocell_tpu.mesh import generate as jgen
from hemocell_tpu_torch.mechanics import forces as tf
from hemocell_tpu_torch.mesh import build_topology, generate

MC = material_dict(MaterialConstants(k_volume=2.0, k_area=1.5, k_link=1.2, k_bend=0.8,
                                     eta_m=0.5))


def _mesh(kind, gen):
    if kind == "rbc":
        return gen.rbc_from_sphere(7.82, 600), None
    mesh = gen.ellipsoid_from_sphere(2.5, 0.375, 66)
    return mesh, gen.mirror_inner_edges(mesh, axis=1)


@pytest.fixture(scope="module", params=["rbc", "plt"])
def case(request):
    kind = request.param
    jmesh, jinner = _mesh(kind, jgen)
    jtopo = j_build_topology(jmesh, inner_edges=jinner)
    t_jax = jf.topology_device_arrays(jtopo, dtype=jnp.float64)
    rng = np.random.default_rng(11)
    nc = 3
    base = jmesh.vertices
    # deformed copies: anisotropic stretch + vertex noise, and random velocities
    pos = np.stack([base * (1.0 + 0.05 * rng.standard_normal(3))
                    + 0.08 * rng.standard_normal(base.shape) + 20.0 * i
                    for i in range(nc)])
    vel = 0.01 * rng.standard_normal(pos.shape)
    return kind, jmesh, jinner, t_jax, pos, vel


def test_topology_copy_matches(case):
    kind, jmesh, jinner, t_jax, _, _ = case
    mesh, inner = _mesh(kind, generate)
    np.testing.assert_array_equal(mesh.vertices, jmesh.vertices)
    t_port = tf.topology_device_arrays(build_topology(mesh, inner_edges=inner),
                                       dtype=torch.float64)
    for k, v in t_port.items():
        ref = t_jax[k]
        if k == "num_vertices":
            assert v == ref
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(ref), rtol=0, atol=1e-14,
                                       err_msg=k)


def test_forces_batched_match_vmap(case):
    kind, _, _, t_jax, pos, vel = case
    jfn = jf.rbc_ho_forces if kind == "rbc" else jf.plt_simple_forces
    tfn = tf.rbc_ho_forces if kind == "rbc" else tf.plt_simple_forces
    ref = jax.vmap(lambda p, v: jfn(p, v, t_jax, MC))(jnp.asarray(pos), jnp.asarray(vel))
    t_port = tf.topology_from_arrays(
        {k: (v if k == "num_vertices" else np.asarray(v)) for k, v in t_jax.items()},
        dtype=torch.float64)
    out = tfn(torch.as_tensor(pos), torch.as_tensor(vel), t_port, MC)
    for name in jf.ForceTerms._fields:
        r = np.asarray(getattr(ref, name))
        o = getattr(out, name).numpy()
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(o, r, rtol=1e-10, atol=1e-10 * scale, err_msg=name)
    assert np.abs(np.asarray(ref.total)).max() > 0.0


def test_mean_force_magnitude():
    rng = np.random.default_rng(2)
    force = rng.standard_normal((4, 5, 3))
    alive = np.array([True, False, True, True])
    from hemocell_tpu.utils.cellinfo import mean_force_magnitude

    ref = float(mean_force_magnitude(jnp.asarray(force), jnp.asarray(alive)))
    out = float(tf.mean_force_magnitude(torch.as_tensor(force), torch.as_tensor(alive)))
    assert abs(out - ref) <= 1e-14 * abs(ref)
