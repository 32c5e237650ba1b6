"""Checkpoint and restart of the port (``io/checkpoint.py`` and the facade's
``save_checkpoint`` / ``load_checkpoint``) on the CPU, in the JAX
reference's npz format:

  (a) a round trip: the file's keys and dtypes, the loaded state equal to
      the saved one bit for bit, the ``.old`` double buffer, and the run
      resumed in a fresh facade equal to the uninterrupted one bit for bit;
  (b) a JAX checkpoint resumed and stepped by the port equals the JAX run
      in f64 (1e-9), and a port checkpoint resumed by the JAX facade equals
      the port's run; the JAX file's ``ibm_overflow`` is dropped;
  (c) ``bc_state`` (a preInlet run's) round-trips, and a legacy file of
      full populations under ``f`` is converted;
  (d) a termination signal makes the next ``iterate`` write a checkpoint
      and raise SystemExit;
  (e) on 2 gloo ranks, the written checkpoint equals the gathered state,
      and the run resumed on 2 ranks equals the uninterrupted one bit for
      bit.
"""

import os
import shutil
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hemocell_tpu import HemoCell as JaxHemoCell
from hemocell_tpu_torch import HemoCell
from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
from hemocell_tpu_torch.cells.state import place_cells
from hemocell_tpu_torch.convert import state_to_numpy
from hemocell_tpu_torch.fluid.d3q19 import W
from hemocell_tpu_torch.io import load_checkpoint, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = os.path.join(REPO, "tools", "cell_templates")
SHAPE = (32, 20, 20)
RADIUS = 8.5
CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm><stepMaterialEvery> 20 </stepMaterialEvery><stepParticleEvery> 5 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><Re> 0.5 </Re></domain>
</hemocell>
"""
CENTERS = (np.array([[8.0, 9.5, 9.5], [22.0, 9.0, 10.0]]), np.array([[15.0, 9.5, 9.5]]))
SAVE_AT, RESUMED = 10, 12  # the resumed run crosses a material update (it = 20)


def _write_case(d):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.xml"), "w") as fh:
        fh.write(CONFIG_XML)
    for name in ("RBC", "PLT"):
        shutil.copy(os.path.join(TEMPLATES, f"{name}_template.xml"),
                    os.path.join(d, f"{name}.xml"))
    return os.path.join(d, "config.xml")


def _facade(cls, path, dtype=None, cells=True, **kw):
    """The walled pipe with 2 RBC and 1 PLT placed in code, a body force and
    the CEPAC field; ``cells=False`` leaves the cells to a checkpoint."""
    hc = cls(path, **kw)
    if dtype is not None:
        hc.dtype = dtype
    hc.initialize_lattice(flags=pipe_flags(SHAPE, RADIUS))
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.add_cell_type("PLT", "PltSimpleModel")
    if cells:
        for k, ct in enumerate(hc.cell_types):
            hc.set_cells(k, place_cells(np.asarray(ct.mesh.vertices), CENTERS[k],
                                        np.zeros((len(CENTERS[k]), 3))))
    hc.set_body_force((2e-5, 0.0, 0.0))
    hc.enable_cepac(init=0.1)
    return hc


@pytest.fixture(scope="module")
def case_path(tmp_path_factory):
    return _write_case(str(tmp_path_factory.mktemp("ckpt_case")))


def _arrays(state):
    """The state's arrays by checkpoint key, as numpy."""
    from hemocell_tpu_torch.io.checkpoint import state_arrays

    return state_arrays(state)


def test_round_trip_and_old(case_path, tmp_path):
    hc = _facade(HemoCell, case_path, device="cpu")
    hc.set_output_dir(str(tmp_path))
    hc.iterate(SAVE_AT)
    path = hc.save_checkpoint()
    assert path == os.path.join(str(tmp_path), "checkpoint", "checkpoint.npz")
    saved = _arrays(hc.state)
    with np.load(path) as data:
        keys = set(data.keys())
        assert data["it"].dtype == np.int32 and int(data["it"]) == SAVE_AT
        assert data["h"].dtype == np.float32
        for key, val in saved.items():
            assert data[key].tobytes() == val.tobytes(), key
    assert {"h", "it", "n_types", "cepac", "cell0_pos", "cell1_restime",
            "cell1_solidify"} <= keys
    assert "f" not in keys and "ibm_overflow" not in keys
    # the resumed run in a fresh facade against the uninterrupted one
    fresh = _facade(HemoCell, case_path, cells=False, device="cpu")
    meta = fresh.load_checkpoint(os.path.dirname(path))
    assert meta == {"iteration": SAVE_AT, "dx": hc.params.dx, "dt": hc.params.dt}
    assert fresh.iter == SAVE_AT
    for key, val in _arrays(fresh.state).items():
        assert val.tobytes() == saved[key].tobytes(), key
    fresh.iterate(RESUMED)
    hc.iterate(RESUMED)
    for key, val in _arrays(hc.state).items():
        assert _arrays(fresh.state)[key].tobytes() == val.tobytes(), key
    # the .old double buffer keeps the previous file
    first = open(path, "rb").read()
    hc.save_checkpoint()
    assert open(path + ".old", "rb").read() == first
    assert not os.path.exists(path + ".tmp")
    state, _ = load_checkpoint(os.path.dirname(path), device="cpu")
    assert state.it == SAVE_AT + RESUMED


def _assert_states_close(t_state, j_state, atol=1e-9):
    np.testing.assert_allclose(t_state.f.numpy(), np.asarray(j_state.f), rtol=0, atol=atol)
    np.testing.assert_allclose(t_state.cepac.numpy(), np.asarray(j_state.cepac), rtol=0,
                               atol=atol)
    for k, cs_j in enumerate(j_state.cells):
        cs_t = t_state.cells[k]
        for name in ("pos", "vel", "force"):
            ref = np.asarray(getattr(cs_j, name))
            np.testing.assert_allclose(getattr(cs_t, name).numpy(), ref, rtol=0,
                                       atol=atol * max(1.0, np.abs(ref).max()), err_msg=name)
        np.testing.assert_array_equal(cs_t.alive.numpy(), np.asarray(cs_j.alive))
        np.testing.assert_array_equal(cs_t.restime.numpy(), np.asarray(cs_j.restime))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume_f64(case_path, tmp_path, writer):
    """One package runs SAVE_AT steps and saves; the other resumes from the
    file while the first runs on: after RESUMED more steps the two agree in
    f64 to 1e-9."""
    ckpt = str(tmp_path / "ckpt")
    if writer == "jax":
        first = _facade(JaxHemoCell, case_path, dtype=jnp.float64)
        second = _facade(HemoCell, case_path, dtype=torch.float64, cells=False, device="cpu")
    else:
        first = _facade(HemoCell, case_path, dtype=torch.float64, device="cpu")
        second = _facade(JaxHemoCell, case_path, dtype=jnp.float64, cells=False)
    first.iterate(SAVE_AT)
    first.save_checkpoint(ckpt)
    with np.load(os.path.join(ckpt, "checkpoint.npz")) as data:
        assert data["h"].dtype == np.float64 and int(data["it"]) == SAVE_AT
        # the JAX file holds its TPU window guard, which the port drops
        assert ("ibm_overflow" in data) == (writer == "jax")
    second.load_checkpoint(ckpt)
    assert second.iter == SAVE_AT
    first.iterate(RESUMED)
    second.iterate(RESUMED)
    port, ref = (second, first) if writer == "jax" else (first, second)
    assert port.iter == ref.iter == SAVE_AT + RESUMED
    _assert_states_close(port.state, ref.state)
    assert np.abs(port.state.cells[0].force.numpy()).max() > 0.0  # the model ran


def test_bc_state_refused_and_legacy_f(case_path, tmp_path):
    hc = _facade(HemoCell, case_path, device="cpu")
    hc.iterate(3)
    src = hc.save_checkpoint(str(tmp_path / "a"))
    with np.load(src) as data:
        arrays = dict(data)
    # a preInlet run's file: its bc_state round-trips, on the device asked
    # for and in the dtype asked for
    bc = np.random.default_rng(5).standard_normal((3,) + SHAPE)
    os.makedirs(tmp_path / "b")
    np.savez(tmp_path / "b" / "checkpoint.npz", bc_state=bc, **arrays)
    state, _ = load_checkpoint(str(tmp_path / "b"), dtype=torch.float64, device="cpu")
    assert state.bc_state.dtype == torch.float64
    np.testing.assert_array_equal(state.bc_state.numpy(), bc)
    save_checkpoint(str(tmp_path / "b2"), state)
    back, _ = load_checkpoint(str(tmp_path / "b2"), device="cpu")
    np.testing.assert_array_equal(back.bc_state.numpy(), bc)
    np.testing.assert_array_equal(back.f.numpy(), state.f.numpy())
    # a legacy file: full populations under "f"
    legacy = dict(arrays)
    h = legacy.pop("h")
    legacy["f"] = h + W.astype(np.float32).reshape(19, 1, 1, 1)
    os.makedirs(tmp_path / "c")
    np.savez(tmp_path / "c" / "checkpoint.npz", **legacy)
    state, meta = load_checkpoint(str(tmp_path / "c"), device="cpu")
    assert meta is None
    np.testing.assert_allclose(state.f.numpy(), h, rtol=0, atol=1e-7)
    # the host fields stay on the host, in the state's dtype
    arrays["le_displacement"] = np.asarray(3.25)
    arrays["body_force_state"] = np.array([1e-6, 0.0, 0.0])
    os.makedirs(tmp_path / "d")
    np.savez(tmp_path / "d" / "checkpoint.npz", **arrays)
    state, _ = load_checkpoint(str(tmp_path / "d"), dtype=torch.float32, device="cpu")
    assert state.le_displacement.dtype == torch.float32 and state.le_displacement.dim() == 0
    assert state.body_force_state.dtype == torch.float32
    assert float(state.le_displacement) == 3.25


def test_exit_signal_writes_checkpoint(case_path, tmp_path):
    names = ("SIGINT", "SIGTERM", "SIGHUP", "SIGUSR1", "SIGUSR2")
    saved = {n: signal.getsignal(getattr(signal, n)) for n in names if hasattr(signal, n)}
    try:
        hc = _facade(HemoCell, case_path, device="cpu")
        hc.set_output_dir(str(tmp_path))
        hc.enable_exit_signals()
        hc.iterate(2)
        os.kill(os.getpid(), signal.SIGUSR1)
        with pytest.raises(SystemExit):
            hc.iterate(1)
    finally:
        for n, handler in saved.items():
            signal.signal(getattr(signal, n), handler)
    state, meta = load_checkpoint(str(tmp_path / "checkpoint"), device="cpu")
    assert state.it == meta["iteration"] == 2


def _rank_worker(rank, world, tmp):
    """One gloo rank: the facade distributed, 5 steps, a checkpoint, 6 more;
    then a fresh distributed facade resumes from the file for 6 steps."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.parallel import init_distributed

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    try:
        path = _write_case(os.path.join(tmp, f"case{rank}"))
        hc = _facade(HemoCell, path, device="cpu")
        hc.distribute(mesh)
        hc.iterate(5)
        ckpt = os.path.join(tmp, "ckpt")
        written = hc.save_checkpoint(ckpt)
        assert (written is not None) == (rank == 0)
        at_save = _arrays(hc.state)
        hc.iterate(6)
        end = _arrays(hc.state)
        fresh = _facade(HemoCell, path, cells=False, device="cpu")
        fresh.distribute(mesh)
        fresh.load_checkpoint(ckpt)
        assert fresh.local_state.f.shape[1] == SHAPE[0] // world
        fresh.iterate(6)
        resumed = _arrays(fresh.state)
        np.savez(os.path.join(tmp, f"r{rank}.npz"),
                 **{f"save/{k}": v for k, v in at_save.items()},
                 **{f"end/{k}": v for k, v in end.items()},
                 **{f"resumed/{k}": v for k, v in resumed.items()})
    finally:
        dist.destroy_process_group()


def test_distributed_checkpoint_on_two_ranks(tmp_path):
    mp.spawn(_rank_worker, args=(2, str(tmp_path)), nprocs=2, join=True)
    with np.load(tmp_path / "ckpt" / "checkpoint.npz") as data:
        written = dict(data)
    for rank in range(2):
        r = dict(np.load(tmp_path / f"r{rank}.npz"))
        save = {k[5:]: v for k, v in r.items() if k.startswith("save/")}
        assert set(save) == set(written)
        for key, val in written.items():
            assert save[key].tobytes() == val.tobytes(), (rank, key)
        for key in (k[4:] for k in r if k.startswith("end/")):
            assert r[f"resumed/{key}"].tobytes() == r[f"end/{key}"].tobytes(), (rank, key)
        assert int(r["end/it"]) == 11
        assert np.abs(r["end/h"] - r["save/h"]).max() > 0.0
