"""K2, the deterministic binned spread (``ibm/kernels.spread``,
``csrc/bin_vertices.cu`` + ``csrc/spread.cu``), and the body force it adds
as it stores the field.

On the CPU:
  * ``spread(..., body_force=b)`` equals ``spread(...) + b`` bit for bit, in
    each form of ``b``, and ``spread.body_force_stores`` counts the call;
  * the kernels' tile (``binned.gather_tiles``) is near-cubic, within the
    shared-memory budget, at least 8 nodes along z where Z allows, and the
    binned gather on it equals the plain spread;
  * a coupled single-device step gives the state the separate
    ``field + body force`` gave (the body force of the configuration, of
    ``body_force_state``, and a field body force, which is still added
    after the spread), and hands K2 the uniform force;
  * the sharded and owner steps call K2 without a body force (their
    halo-add needs the raw field).

Tests marked ``card`` run the kernels on a CUDA card and skip without one:
K2's field against a plain int64 fixed-point spread of the same
quantization (each corner's deposit ``rint(w * F * scale)``, summed with
``index_add_`` in int64, times ``1 / scale``), bit for bit, at 256^3 with
4400 RBC, 128^3 with 872, the 248x56x56 pipe with cells in it and with
vertices strewn, the sharded step's extended slab, the owner step's grid
and one heavy tile holding every vertex, each with and without the extra
force and the body force (by value and from device memory); the C
library's tiles against the mirror's; three device kernels a call under
their names; the counter; K11 against the same int64 spread of its own
records.  This file imports no JAX, so that the card's tests run where JAX
is not installed::

    python -m pytest --noconftest -p no:cacheprovider -q -m card \
        tests/test_torch_spread_k2.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
from hemocell_tpu_torch.ibm import binned, coupling, kernels

SHAPE = (12, 10, 10)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def _vertices(shape, P, seed, dtype=torch.float64, device="cpu"):
    """Unwrapped positions over [-1, 2) boxes, forces around the cap, an
    extra force and an activity with dead vertices."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 2.0, (P, 3)) * np.asarray(shape, np.float64)
    force = rng.standard_normal((P, 3)) * 3e-3
    extra = rng.standard_normal((P, 3)) * 5e-3
    active = (rng.random(P) > 0.2).astype(np.float64)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (pos, force, extra, active))


BODY_FORMS = ("tensor", "tensor3111", "list", "tensor_f64")


def _body_force(form, dtype):
    values = [5e-7, -2.5e-7, 1.25e-6]
    if form == "list":
        return values
    t = torch.tensor(values, dtype=torch.float64 if form == "tensor_f64" else dtype)
    return t.reshape(3, 1, 1, 1) if form == "tensor3111" else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", BODY_FORMS)
def test_spread_with_body_force_on_cpu_is_the_add_bitwise(form, dtype):
    pos, force, extra, active = _vertices(SHAPE, 300, 1, dtype)
    flags = torch.as_tensor(pipe_flags(SHAPE, 4.0))
    bf = _body_force(form, dtype)
    before = kernels.spread.plain_calls, kernels.spread.body_force_stores
    out = kernels.spread(pos, force, active, flags, 4e-3, force_extra=extra, body_force=bf)
    assert (kernels.spread.plain_calls, kernels.spread.body_force_stores) == (
        before[0] + 1, before[1] + 1)
    ref = kernels.spread(pos, force, active, flags, 4e-3, force_extra=extra)
    assert kernels.spread.body_force_stores == before[1] + 1
    view = torch.as_tensor(bf, dtype=torch.float64 if form == "list" else None)
    view = view.reshape(3).to(dtype)[:, None, None, None]
    assert out.dtype == dtype and torch.equal(out, ref + view)
    # a wall node gets no deposit: it holds the body force alone
    assert torch.equal(out[:, flags != 0], view[:, :, 0, 0].expand(3, int((flags != 0).sum())))


@pytest.mark.parametrize("bad", [[1.0, 2.0], torch.zeros(3, 2), torch.zeros((3,) + SHAPE)])
def test_spread_refuses_a_body_force_of_other_than_three_values(bad):
    pos, force, _, active = _vertices(SHAPE, 20, 2)
    before = kernels.spread.plain_calls
    with pytest.raises(ValueError, match="3 values"):
        kernels.spread(pos, force, active, torch.zeros(SHAPE, dtype=torch.uint8), 1.0,
                       body_force=bad)
    assert kernels.spread.plain_calls == before


TILE_SHAPES = {
    "cube256": ((256, 256, 256), (8, 16, 16), 1.28),
    "cube128": ((128, 128, 128), (8, 16, 16), 1.28),
    "pipe": ((248, 56, 56), (8, 8, 8), 1.43),
    "slab": ((65, 128, 128), None, 1.37),
    "owner": ((271, 56, 56), None, 1.43),
    "tile2d": ((249, 57, 56), None, 1.45),
    "capillary": ((400, 50, 50), None, 1.39),
    "small": (SHAPE, (4, 10, 10), 1.25),
    "flat": ((64, 64, 4), None, 1.2),
}


@pytest.mark.parametrize("name", list(TILE_SHAPES))
def test_gather_tiles_are_near_cubic(name):
    """The tile fits its budget (``TILE_NODES``, halved down to
    ``MIN_TILE_NODES`` while the lattice would have fewer than
    ``MIN_TILES`` tiles), stores 8 nodes or more along z, makes few entries
    a vertex ((1 + 1/tx)(1 + 1/ty)(1 + 1/tz) where a tile does not span its
    axis; z columns of 4 x 2 x 256 would make 1.875 at 256^3), and no other
    tile of power-of-two extents within the budget makes fewer."""
    shape, expected, most = TILE_SHAPES[name]
    tile = binned.gather_tiles(shape)
    budget = binned.tile_budget(shape)
    if expected is not None:
        assert tile == expected
    n_tiles = math.prod(-(-n // t) for n, t in zip(shape, tile))
    assert math.prod(tile) <= budget <= binned.TILE_NODES
    if budget < binned.TILE_NODES:  # halved: twice the budget made too few tiles
        wider = binned._cut_tiles(shape, 2 * budget)
        assert math.prod(-(-n // t) for n, t in zip(shape, wider)) < binned.MIN_TILES
        assert n_tiles >= binned.MIN_TILES or budget == binned.MIN_TILE_NODES
    assert all(1 <= t <= n for t, n in zip(tile, shape))
    assert tile[2] >= min(shape[2], 8)
    entries = math.prod(binned._axis_entries(t, n) for t, n in zip(tile, shape))
    assert entries <= most
    for tx in (1, 2, 4, 8, 16, 32, 64):
        for ty in (1, 2, 4, 8, 16, 32, 64):
            for tz in (8, 16, 32, 64):
                other = (min(tx, shape[0]), min(ty, shape[1]), min(tz, shape[2]))
                if math.prod(other) <= budget:
                    assert entries <= math.prod(binned._axis_entries(t, n) + 1e-12
                                                for t, n in zip(other, shape))


def test_binned_gather_on_the_kernel_tile_is_the_plain_spread():
    """The tile gather on the kernels' tile of a 40x36x36 pipe (5 x 5 x 5
    tiles, ragged in y and z, stencils wrapping onto the first tiles)
    against ``coupling.spread_forces`` in f64."""
    shape = (40, 36, 36)
    assert binned.gather_tiles(shape) == (8, 8, 8)
    pos, force, extra, active = _vertices(shape, 600, 3)
    flags = torch.as_tensor(pipe_flags(shape, 10.0))
    out = binned.spread_binned_plain(pos, force, shape, active, flags, 4e-3, extra)
    ref = coupling.spread_forces(pos, force, active, flags, 4e-3, extra)
    assert float(ref.abs().max()) > 1e-3
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)


# ---- the steps (CPU) -------------------------------------------------------

BF = (1e-6, -3e-7, 2e-7)


def _suspension(dtype, body_force):
    from hemocell_tpu_torch import presets

    cfg, state, _ = presets.rbc_suspension(shape=(32, 16, 16), n_cells=2, particle_every=1,
                                           material_every=1, repulsion=True, dtype=dtype,
                                           device="cpu")
    return dataclasses.replace(cfg, body_force=body_force), state


def _counted(fn):
    """``fn`` in place of ``kernels.spread``, with the wrapper's counters
    (the plain version counts on the module's ``spread``)."""
    fn.launches = fn.plain_calls = fn.body_force_stores = 0
    return fn


def _spread_adding(extra_force):
    """K2's plain version followed by the separate addition of
    ``extra_force`` ([3] or a field): what the step did before K2 took the
    body force.  It refuses a body force of its own."""
    plain = kernels.spread

    def spread(*args, body_force=None, **kw):
        assert body_force is None
        out = plain(*args, **kw)
        f = torch.as_tensor(extra_force, dtype=out.dtype)
        return out + (f[:, None, None, None] if f.dim() == 1 else f)

    return _counted(spread)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("source", ["config", "state", "state_over_config", "field"])
def test_step_hands_k2_the_uniform_body_force(source, dtype, monkeypatch):
    """Two iterations of the coupled step (repulsion, particles, materials)
    with the body force from the configuration, from ``body_force_state``
    (alone or over the configuration's), or as a field, against the step
    without a body force whose spread adds the same force after K2: the
    same state bit for bit.  K2 folds the uniform forms, not the field."""
    from hemocell_tpu_torch.dynamics import build_step

    shape = (32, 16, 16)
    field = None
    if source == "field":
        g = torch.Generator().manual_seed(4)
        field = 1e-6 * torch.rand((3,) + shape, generator=g, dtype=torch.float64).to(dtype)
    cfg_bf = {"config": BF, "state": None, "state_over_config": (3e-6, 0.0, 0.0),
              "field": field}[source]
    cfg, state = _suspension(dtype, cfg_bf)
    if source.startswith("state"):
        state = state._replace(body_force_state=torch.tensor(BF, dtype=dtype))
    applied = field if source == "field" else BF
    step = build_step(cfg)
    stores = kernels.spread.body_force_stores
    out = step(step(state))
    assert kernels.spread.body_force_stores == stores + (0 if source == "field" else 2)

    cfg0 = dataclasses.replace(cfg, body_force=None)
    state0 = state._replace(body_force_state=None)
    monkeypatch.setattr(kernels, "spread", _spread_adding(applied))
    step0 = build_step(cfg0)
    ref = step0(step0(state0))
    assert torch.equal(out.f, ref.f)
    for a, b in zip(out.cells, ref.cells):
        for k in ("pos", "vel", "force", "force_repulsion"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_sharded_and_owner_steps_spread_without_a_body_force(tmp_path, monkeypatch):
    """At world size 1 (gloo, in this process) the sharded and the owner
    runners spread through K2 with no body force: their halo-add takes the
    raw field, and the body force is added after it."""
    import torch.distributed as dist

    from hemocell_tpu_torch.parallel import (build_owner_runner, build_shardmap_runner,
                                             init_distributed, shard_state, suggest_envelope)

    seen = []
    plain = kernels.spread

    def spread(*args, **kw):
        seen.append(kw.get("body_force"))
        return plain(*args, **kw)

    monkeypatch.setattr(kernels, "spread", _counted(spread))
    cfg, state = _suspension(torch.float64, BF)
    mesh = init_distributed("cpu", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        build_shardmap_runner(cfg, mesh)(shard_state(state, mesh), 2)
        sharded = len(seen)
        env = suggest_envelope(state.cells, resort_every=1)
        build_owner_runner(cfg, mesh, envelope=env)(shard_state(state, mesh), 2)
    finally:
        dist.destroy_process_group()
    assert sharded == 2 and len(seen) == 4
    assert seen == [None] * 4


# ---- on a CUDA card ---------------------------------------------------------


def _wrap(pos, shape):
    """The kernels' wrap: fmod, then + L below 0 (it may round to L)."""
    L = torch.tensor(shape, dtype=pos.dtype, device=pos.device)
    r = torch.fmod(pos, L)
    return torch.where(r < 0, r + L, r)


def _int64_spread(p, F, wscale, fluid, shape, bound, body_force=None):
    """The plain int64 fixed-point spread of the kernels' quantization, in
    float32 as the kernels round: wrapped positions ``p`` [P,3] (in [0,
    L]), forces ``F`` [P,3], weight scales ``wscale`` [P] (0 for a dead
    vertex), the fluid mask of the 8 corners ``fluid`` [P,8] and the bound
    of the deposits.  Each corner's deposit ((wx wy) wz) wscale F rounds to
    an integer at the scale, the sums are int64 (``index_add_``), and each
    node is (float)(sum / scale), plus the body force in float32."""
    X, Y, Z = shape
    dev = p.device
    scale = binned.fixed_point_scale(bound)
    fscale = torch.tensor(scale, dtype=torch.float32, device=dev)
    base = torch.floor(p)
    g = p - base
    b = base.long()
    n = torch.tensor(shape, device=dev)
    b = torch.where(b >= n, b - n, b)
    one = torch.ones_like(g)
    sums = torch.zeros((3, X * Y * Z), dtype=torch.long, device=dev)
    live = wscale != 0
    for c, (a, bb, cc) in enumerate(binned._OFFSETS):
        w = torch.where(torch.tensor([a, bb, cc], device=dev).bool(), g, one - g)
        ws = ((w[:, 0] * w[:, 1]) * w[:, 2]) * wscale
        node = (((b[:, 0] + a) % X) * Y + (b[:, 1] + bb) % Y) * Z + (b[:, 2] + cc) % Z
        keep = fluid[:, c] & live
        for d in range(3):
            q = torch.round((ws * F[:, d]) * fscale).long()
            sums[d].index_add_(0, node[keep], q[keep])
    out = (sums.double() * (1.0 / scale)).float().reshape((3,) + tuple(shape))
    if body_force is not None:
        out = out + body_force.to(device=dev, dtype=torch.float32).reshape(3, 1, 1, 1)
    return out


def _k2_plain_int64(pos, force, active, flags, f_limit, extra=None, body_force=None):
    """K2's records (the cap, the extra force, the fluid mask and the
    renormalised weight scale, in the counting kernel's order of float32
    operations) into ``_int64_spread``."""
    shape = tuple(flags.shape)
    X, Y, Z = shape
    dev = pos.device
    p = _wrap(pos, shape)
    base = torch.floor(p)
    g = p - base
    b = base.long()
    n = torch.tensor(shape, device=dev)
    b = torch.where(b >= n, b - n, b)
    f = force.clone()
    mag = torch.sqrt((f[:, 0] * f[:, 0] + f[:, 1] * f[:, 1]) + f[:, 2] * f[:, 2])
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    lim = torch.full_like(mag, f_limit)
    f = torch.where((mag > lim)[:, None], f * (lim / torch.maximum(mag, tiny))[:, None], f)
    if extra is not None:
        f = f + extra
    total = torch.zeros_like(g[:, 0])
    one = torch.ones_like(g)
    fluid = []
    for a, bb, cc in binned._OFFSETS:
        node = (((b[:, 0] + a) % X) * Y + (b[:, 1] + bb) % Y) * Z + (b[:, 2] + cc) % Z
        fl = flags.reshape(-1)[node] == 0
        w = torch.where(torch.tensor([a, bb, cc], device=dev).bool(), g, one - g)
        total = total + torch.where(fl, (w[:, 0] * w[:, 1]) * w[:, 2], torch.zeros_like(total))
        fluid.append(fl)
    wscale = active / torch.maximum(total, tiny)
    live = wscale != 0
    per = active.abs() * f.abs().amax(dim=1)
    bound = float(per[live].max()) if bool(live.any()) else 0.0
    return _int64_spread(p, f, wscale, torch.stack(fluid, dim=1), shape, bound, body_force)


def _cube_cells(shape, n_cells, seed, device, radius=None):
    """``n_cells`` RBC of the presets' template on their grid, each rotated
    from the seed, some moved by whole periods (positions are unwrapped);
    with ``radius`` the first of a finer grid within it of the x axis."""
    from hemocell_tpu_torch.cells.state import place_cells
    from hemocell_tpu_torch.mesh import rbc_from_sphere
    from hemocell_tpu_torch.presets import default_params, grid_centers

    mesh = rbc_from_sphere(3.91e-6 / default_params().dx, 600)
    rng = np.random.default_rng(seed)
    if radius is None:
        centers = grid_centers(shape, n_cells)
    else:
        centers = grid_centers(shape, 20 * n_cells)
        off = np.hypot(centers[:, 1] - shape[1] / 2, centers[:, 2] - shape[2] / 2)
        centers = centers[off < radius][:n_cells]
    cells = place_cells(mesh.vertices, centers, rng.uniform(0, 2 * np.pi, (len(centers), 3)))
    cells = cells + rng.integers(-1, 2, (len(centers), 1, 3)) * np.asarray(shape)
    return torch.as_tensor(cells.reshape(-1, 3), dtype=torch.float32, device=device)


def _card_case(name, device):
    """(pos, force, extra, active, flags, f_limit) of a card shape."""
    g = torch.Generator(device="cpu").manual_seed(sum(map(ord, name)))

    def randn(*size, s=1.0):
        return (s * torch.randn(size, generator=g)).to(device)

    f_lim = 2e-3
    if name in ("cube256", "cube128"):
        shape, n = ((256,) * 3, 4400) if name == "cube256" else ((128,) * 3, 872)
        pos = _cube_cells(shape, n, 7, device)
        flags = torch.zeros(shape, dtype=torch.uint8, device=device)
    elif name == "pipe_cells":
        # pipeflow30's lattice with 226 RBC inside its radius-25 tube
        shape = (248, 56, 56)
        pos = _cube_cells(shape, 226, 5, device, radius=17.0)
        flags = torch.as_tensor(pipe_flags(shape, 25.0), device=device)
    elif name == "pipe":
        shape = (248, 56, 56)
        P = 150_000
        r = 27.5 * torch.sqrt(torch.rand(P, generator=g))
        ang = 2 * math.pi * torch.rand(P, generator=g)
        pos = torch.stack([shape[0] * (3 * torch.rand(P, generator=g) - 1),
                           27.5 + r * torch.cos(ang), 27.5 + r * torch.sin(ang)], 1).to(device)
        flags = torch.as_tensor(pipe_flags(shape, 25.0), device=device)
    elif name in ("slab", "owner"):
        # the sharded step's [Xl+1, Y, Z] slab (local x in [-1, Xl+1)) and
        # the owner step's [Xl+2E+1, Yg, Z] grid with its parking row
        shape = (65, 128, 128) if name == "slab" else (271, 56, 56)
        P = 200_000
        lo = torch.tensor([-1.0, 0.0, 0.0] if name == "slab" else [0.0, 0.0, 0.0])
        hi = torch.tensor([shape[0], shape[1], shape[2]], dtype=torch.float32)
        pos = (lo + (hi - lo) * torch.rand((P, 3), generator=g)).to(device)
        flags = torch.zeros(shape, dtype=torch.uint8, device=device)
        if name == "owner":
            flags = torch.as_tensor(pipe_flags(shape, 25.0), device=device)
    elif name == "heavy":
        # every vertex in the first tile of a 128^3 box
        shape = (128, 128, 128)
        tile = torch.tensor(binned.gather_tiles(shape), dtype=torch.float32)
        P = 60_000
        pos = ((tile - 1.0) * torch.rand((P, 3), generator=g)).to(device)
        flags = torch.zeros(shape, dtype=torch.uint8, device=device)
    else:
        raise KeyError(name)
    P = pos.shape[0]
    force = randn(P, 3, s=0.8 * f_lim)
    extra = randn(P, 3, s=1e-3)
    active = (torch.rand(P, generator=g) > 0.03).float().to(device)
    return pos.contiguous(), force, extra, active, flags, f_lim


CARD_SHAPES = ("cube256", "cube128", "pipe_cells", "pipe", "slab", "owner", "heavy")


@pytest.mark.card
@pytest.mark.parametrize("body", ["none", "host", "device"])
@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("name", CARD_SHAPES)
def test_k2_equals_the_int64_spread_bitwise(card, name, with_extra, body):
    pos, force, extra, active, flags, f_lim = _card_case(name, card)
    extra = extra if with_extra else None
    bf = {"none": None, "host": torch.tensor([5e-7, -1e-7, 3e-7]),
          "device": torch.tensor([5e-7, -1e-7, 3e-7], device=card)}[body]
    before = kernels.spread.launches, kernels.spread.body_force_stores
    out = kernels.spread(pos, force, active, flags, f_lim, force_extra=extra, body_force=bf)
    again = kernels.spread(pos, force, active, flags, f_lim, force_extra=extra, body_force=bf)
    torch.cuda.synchronize()  # a fault in the kernels surfaces here
    assert kernels.spread.launches == before[0] + 2
    assert kernels.spread.body_force_stores == before[1] + (0 if bf is None else 2)
    ref = _k2_plain_int64(pos, force, active, flags, f_lim, extra, bf)
    assert torch.equal(out, again)
    assert float(ref.abs().max()) > 0
    assert torch.equal(out, ref), float((out - ref).abs().max())
    if bf is not None:
        assert torch.equal(out, kernels.spread(pos, force, active, flags, f_lim,
                                               force_extra=extra) + bf.to(card)[:, None, None,
                                                                                None])


@pytest.mark.card
def test_k2_tiles_are_the_mirrors(card):
    """The C library's tile choice equals ``binned.gather_tiles``."""
    import ctypes

    from hemocell_tpu_torch import _build

    for shape, _, _ in TILE_SHAPES.values():
        got = (ctypes.c_int * 3)()
        assert _build.lib().hc_gather_tiles(*shape, ctypes.addressof(got)) == 0
        assert tuple(got) == binned.gather_tiles(shape), shape


@pytest.mark.card
@pytest.mark.parametrize("body", ["none", "device"])
def test_k2_is_three_device_kernels_a_call(card, body):
    pos, force, extra, active, flags, f_lim = _card_case("cube128", card)
    bf = None if body == "none" else torch.tensor([5e-7, 0.0, 0.0], device=card)
    kernels.spread(pos, force, active, flags, f_lim, force_extra=extra, body_force=bf)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernels.spread(pos, force, active, flags, f_lim, force_extra=extra, body_force=bf)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3, names
    for want, got in zip(("count_k2_kernel", "place_kernel", "tile_gather_kernel"), names):
        assert want in got, names


@pytest.mark.card
@pytest.mark.parametrize("shape,capacity", [((248, 56, 56), 2048), ((128, 128, 128), 8192)])
def test_k11_equals_the_int64_spread_bitwise(card, shape, capacity):
    """K11 (``static.spread_static``) against the int64 spread of its
    records: the first ``capacity`` vertices of each x-slab in vertex
    order, pure periodic weights, the force as it is."""
    from hemocell_tpu_torch.ibm import static

    g = torch.Generator(device="cpu").manual_seed(capacity)
    P = 8 * capacity
    pos = (torch.rand((P, 3), generator=g) * torch.tensor(shape) * 3
           - torch.tensor(shape)).to(card)
    pos[::5, 0] = 3.5  # an overfull slab
    force = (1e-3 * torch.randn((P, 3), generator=g)).to(card)
    field, overflow = static.spread_static(pos, force, shape, capacity)
    torch.cuda.synchronize()
    p = _wrap(pos, shape)
    _, _, rank = binned.bin_vertices_plain(binned.slab_keys(p.cpu().double(), shape[0]),
                                           shape[0])
    kept = (rank < capacity).to(card)
    assert int(overflow) == int((~kept).sum()) > 0
    bound = float(force[kept].abs().amax())
    fluid = torch.ones((P, 8), dtype=torch.bool, device=card)
    ref = _int64_spread(p, force, kept.float(), fluid, shape, bound)
    assert torch.equal(field, ref), float((field - ref).abs().max())
