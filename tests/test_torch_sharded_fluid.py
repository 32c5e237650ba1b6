"""The halo (sharded) mode of the port's fluid kernels K1 and K10 and the
per-rank fluid step against the JAX reference, on the CPU:

  * the plain K1 halo version (``stream_collide(..., halos=)`` on CPU
    tensors) against ``stream_collide_pallas(..., halos=, interpret=True)``
    in f32 at 1e-6 (f32 rounding of populations of order 1e-2 in another
    summation order), and against the JAX ``lbm.stream_collide`` on the
    extended block in f64 at 1e-12, for every set of row keys;
  * the plain K10 halo version against ``stream_collide_pallas_2d(...,
    halos=, interpret=True)`` with 4x4 tiles, f32 at 1e-6;
  * the split: the slabs of a box, each stepped with its neighbours' rows,
    equal one whole-box step (f64, 1e-15);
  * ``make_sharded_stream_collide`` on 2 and 4 gloo ranks against the JAX
    one on a mesh of as many devices (the shape and steps of
    ``tests/test_sharded_fluid.py``), f64 at 1e-12.

The ranks are processes spawned by ``torch.multiprocessing``: the workers
below import no JAX (this module imports it inside the tests only).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hemocell_tpu_torch.config.defaults import FLAG_PRESSURE, FLAG_VELOCITY, FLAG_WALL
from hemocell_tpu_torch.fluid.stream_collide import stream_collide, stream_collide_halo
from hemocell_tpu_torch.fluid.stream_collide_2d import stream_collide_2d, stream_collide_2d_halo

SLAB = (4, 8, 16)  # the rank's slab (Xl, Y, Z)
KEY_SETS = {
    "f": dict(force=None, flags=False),
    "uniform force": dict(force="uniform", flags=False),
    "force field + flags": dict(force="field", flags=True),
    "flags + bc + pressure": dict(force="field", flags=True, bc=True),
    "omega field": dict(force="uniform", flags=True, omega=True),
    "le planes": dict(force="field", flags=False, le=True),
}


def _inputs(spec, seed, dtype, xl=SLAB[0], yz=SLAB[1:]):
    """Numpy operands of a slab of width ``xl`` with its two neighbour rows,
    extended to [.., xl + 2, ..] (row 0 and row -1 are the rows):
    (f, force, omega, flags, bc, rho0, le)."""
    rng = np.random.default_rng(seed)
    shape = (xl + 2,) + tuple(yz)
    from hemocell_tpu_torch.fluid import lbm

    rho = 1.0 + 0.02 * rng.standard_normal(shape)
    u = 0.02 * rng.standard_normal((3,) + shape)
    f = lbm.equilibrium_dev(torch.as_tensor(rho), torch.as_tensor(u)).numpy()
    f = (f + 1e-3 * rng.standard_normal(f.shape)).astype(dtype)
    force = None
    if spec.get("force") == "uniform":
        force = np.asarray([1e-5, -2e-6, 3e-6], dtype)
    elif spec.get("force") == "field":
        force = (1e-5 * rng.standard_normal((3,) + shape)).astype(dtype)
    flags = bc = rho0 = omega = le = None
    if spec.get("flags"):
        flags = np.zeros(shape, np.uint8)
        flags[:, 0, :] = FLAG_WALL
        flags[1, 2:3, 3:6] = FLAG_WALL  # a bar on the slab's first row
    if spec.get("bc"):
        flags[:, :, 0] = FLAG_VELOCITY
        flags[-1, 1:, 1:] = FLAG_PRESSURE  # the hi row
        flags[1, 1:, 1:] = FLAG_PRESSURE  # and the slab's first row
        bc = (0.01 * rng.standard_normal((3,) + shape)).astype(dtype)
        rho0 = 1.01
    omega = 0.9
    if spec.get("omega"):
        omega = (0.9 + 0.2 * rng.random(shape)).astype(dtype)
    if spec.get("le"):
        le = (1e-3 * rng.standard_normal((38, shape[0], shape[1]))).astype(dtype)
    return f, force, omega, flags, bc, rho0, le


def _split_rows(arrays):
    """(slab operands, halos dict) from extended numpy operands, as torch."""
    f, force, omega, flags, bc, _, le = arrays
    t = torch.as_tensor

    def cut(a, d):
        n = a.shape[d]
        body = t(np.take(a, range(1, n - 1), axis=d))
        lo = t(np.take(a, [0], axis=d))
        hi = t(np.take(a, [n - 1], axis=d))
        return body, (lo, hi)

    halos = {}
    f_l, halos["f"] = cut(f, 1)
    force_l = None if force is None else t(force)
    if force is not None and force.ndim > 1:
        force_l, halos["force"] = cut(force, 1)
    flags_l = None
    if flags is not None:
        flags_l, halos["flags"] = cut(flags, 0)
    bc_l = None
    if bc is not None:
        bc_l, halos["bc"] = cut(bc, 1)
    omega_l = omega
    if isinstance(omega, np.ndarray):
        omega_l, halos["omega"] = cut(omega, 0)
    le_l = None
    if le is not None:
        le_l, halos["le"] = cut(le, 1)
    return f_l, force_l, omega_l, flags_l, bc_l, le_l, halos


def _port_halo(arrays):
    f_l, force_l, omega_l, flags_l, bc_l, le_l, halos = _split_rows(arrays)
    return stream_collide_halo(f_l, force_l, omega_l, flags_l, bc_l, arrays[5], halos,
                               le_planes=le_l)


def _j(a):
    import jax.numpy as jnp

    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("keys", list(KEY_SETS))
def test_k1_halo_f32_matches_pallas_interpret(keys):
    from hemocell_tpu.fluid.pallas_lbm import stream_collide_pallas

    arrays = _inputs(KEY_SETS[keys], seed=1, dtype=np.float32)
    f_l, force_l, omega_l, flags_l, bc_l, le_l, halos = _split_rows(arrays)
    jhalos = {k: (_j(lo.numpy()), _j(hi.numpy())) for k, (lo, hi) in halos.items()}
    ref = stream_collide_pallas(
        _j(f_l.numpy()), _j(None if force_l is None else force_l.numpy()),
        omega_l if not torch.is_tensor(omega_l) else _j(omega_l.numpy()),
        _j(None if flags_l is None else flags_l.numpy()),
        _j(None if bc_l is None else bc_l.numpy()), interpret=True, bc_density=arrays[5],
        le_planes=_j(None if le_l is None else le_l.numpy()), halos=jhalos)
    n0 = stream_collide_halo.plain_calls
    out = stream_collide(f_l, force_l, omega_l, flags_l, bc_l, arrays[5], halos=halos) \
        if le_l is None else _port_halo(arrays)
    assert stream_collide_halo.plain_calls == n0 + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (19,) + SLAB
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("keys", list(KEY_SETS))
def test_k1_halo_f64_matches_jax_on_the_extended_block(keys):
    import jax.numpy as jnp

    from hemocell_tpu.fluid import lbm as jlbm
    from hemocell_tpu.fluid.lees_edwards import stream_with_planes

    arrays = _inputs(KEY_SETS[keys], seed=2, dtype=np.float64)
    f, force, omega, flags, bc, rho0, le = arrays
    shape = f.shape[1:]
    field = np.zeros((3,) + shape) if force is None else (
        np.broadcast_to(force[:, None, None, None], (3,) + shape) if force.ndim == 1
        else force)
    jflags = jnp.asarray(np.zeros(shape, np.uint8) if flags is None else flags)
    om = omega if not isinstance(omega, np.ndarray) else jnp.asarray(omega)
    if le is None:
        ref = jlbm.stream_collide(jnp.asarray(f), jnp.asarray(field), om, jflags, _j(bc),
                                  bc_density=rho0)
    else:
        ref = stream_with_planes(jlbm.collide(jnp.asarray(f), jnp.asarray(field), om, jflags),
                                 jnp.asarray(le))
    out = _port_halo(arrays)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, 1:-1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("keys", ["uniform force", "flags + bc + pressure"])
def test_k10_halo_f32_matches_pallas_interpret(keys):
    """One 4x4 tile of the slab [4, 4, 8] (its y neighbours wrap onto it)."""
    from hemocell_tpu.fluid.pallas_lbm_2d import stream_collide_pallas_2d

    arrays = _inputs(KEY_SETS[keys], seed=3, dtype=np.float32, yz=(4, 8))
    f_l, force_l, omega_l, flags_l, bc_l, _, halos = _split_rows(arrays)
    jhalos = {k: (_j(lo.numpy()), _j(hi.numpy())) for k, (lo, hi) in halos.items()}
    ref = stream_collide_pallas_2d(
        _j(f_l.numpy()), _j(None if force_l is None else force_l.numpy()), omega_l,
        _j(None if flags_l is None else flags_l.numpy()),
        _j(None if bc_l is None else bc_l.numpy()), tx=4, ty=4, interpret=True,
        bc_density=arrays[5], halos=jhalos)
    n0 = stream_collide_2d_halo.plain_calls
    out = stream_collide_2d(f_l, force_l, omega_l, flags_l, bc_l, arrays[5], halos=halos)
    assert stream_collide_2d_halo.plain_calls == n0 + 1
    assert tuple(out.shape) == (19, 4, 4, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_slabs_with_their_rows_equal_the_whole_box(n_slabs):
    """The rows of the neighbouring slabs (periodic in x) make each slab's
    step the whole box's, to f64 rounding; through ``stream_collide``'s
    dispatch to K10 as well."""
    import importlib

    sc = importlib.import_module("hemocell_tpu_torch.fluid.stream_collide")
    X = 4 * n_slabs
    arrays = _inputs(KEY_SETS["flags + bc + pressure"], seed=4, dtype=np.float64,
                     xl=X - 2)
    f, force, omega, flags, bc, rho0, _ = (torch.as_tensor(a) if isinstance(a, np.ndarray)
                                           else a for a in arrays)
    whole = stream_collide(f, force, omega, flags, bc, rho0)
    Xl = X // n_slabs

    def rows(a, d, s):
        lo, hi = (s * Xl - 1) % X, ((s + 1) * Xl) % X
        return a.narrow(d, lo, 1), a.narrow(d, hi, 1)

    for large in (None, SLAB[1] * SLAB[2]):
        sc.LARGE_CROSS_SECTION = large
        try:
            parts = []
            for s in range(n_slabs):
                halos = {"f": rows(f, 1, s), "force": rows(force, 1, s),
                         "flags": rows(flags, 0, s), "bc": rows(bc, 1, s)}
                parts.append(stream_collide(
                    f.narrow(1, s * Xl, Xl), force.narrow(1, s * Xl, Xl), omega,
                    flags.narrow(0, s * Xl, Xl), bc.narrow(1, s * Xl, Xl), rho0,
                    halos=halos))
        finally:
            sc.LARGE_CROSS_SECTION = None
        np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(), whole.numpy(), rtol=0,
                                   atol=1e-15)


def test_halo_mode_refuses_missing_rows():
    arrays = _inputs(KEY_SETS["force field + flags"], seed=5, dtype=np.float64)
    f_l, force_l, omega_l, flags_l, bc_l, _, halos = _split_rows(arrays)
    del halos["flags"]
    with pytest.raises(ValueError, match="flags"):
        stream_collide(f_l, force_l, omega_l, flags_l, bc_l, halos=halos)


# ---------------------------------------------------------------------------
# make_sharded_stream_collide on gloo ranks

SHARDED_SHAPE = (32, 8, 128)
SHARDED_STEPS = 5


def _sharded_inputs():
    rng = np.random.default_rng(0)
    from hemocell_tpu_torch.fluid import lbm

    rho = 1.0 + 0.02 * rng.standard_normal(SHARDED_SHAPE)
    u = 0.02 * rng.standard_normal((3,) + SHARDED_SHAPE)
    f = lbm.equilibrium_dev(torch.as_tensor(rho), torch.as_tensor(u)).numpy()
    force = 1e-5 * rng.standard_normal((3,) + SHARDED_SHAPE)
    flags = np.zeros(SHARDED_SHAPE, np.uint8)
    flags[:, 0, :] = FLAG_WALL
    return f, force, flags


def _fluid_worker(rank, world, tmp, f, force, flags):
    """One gloo rank: SHARDED_STEPS of the sharded fluid step on its slab,
    then the gathered populations to ``tmp``."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.fluid.sharded_pallas import make_sharded_stream_collide
    from hemocell_tpu_torch.parallel import init_distributed
    from hemocell_tpu_torch.parallel import comm

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    try:
        step = make_sharded_stream_collide(mesh, flags)
        Xl = f.shape[1] // world
        sl = slice(rank * Xl, (rank + 1) * Xl)
        f_l = torch.as_tensor(f[:, sl]).contiguous()
        force_l = torch.as_tensor(force[:, sl]).contiguous()
        for _ in range(SHARDED_STEPS):
            f_l = step(f_l, force_l, 0.9)
        out = comm.all_gather(mesh, f_l, 1)
        if rank == 0:
            np.save(os.path.join(tmp, "f.npy"), out.numpy())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_make_sharded_stream_collide_matches_jax_mesh(world, tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hemocell_tpu.fluid.sharded_pallas import make_sharded_stream_collide as j_make
    from hemocell_tpu.parallel import make_mesh

    f, force, flags = _sharded_inputs()
    mp.spawn(_fluid_worker, args=(world, str(tmp_path), f, force, flags), nprocs=world,
             join=True)
    out = np.load(tmp_path / "f.npy")

    mesh = make_mesh(world, axes=("x",))
    step = j_make(mesh, jnp.asarray(flags))
    spec = NamedSharding(mesh, P(None, "x", None, None))
    ref = jax.device_put(jnp.asarray(f), spec)
    fo = jax.device_put(jnp.asarray(force), spec)
    for _ in range(SHARDED_STEPS):
        ref = step(ref, fo, 0.9)
    assert float(np.abs(out - f).max()) > 1e-4  # the flow moved
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-12)
