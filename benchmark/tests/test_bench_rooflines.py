"""Each roofline's bytes and operations at the cells' shapes against values
worked by hand, the roofline arithmetic, and the trace's reduction."""

import glob
import math
import os
import re

import pytest

from benchmark.lib import roofline, spec, trace

CUBE = spec.load_json(os.path.join(spec.ROOT, "benchmark", "configs", "cube256.json"))


def reader(name):
    return spec.load_module(os.path.join(spec.ROOT, "benchmark", "metrics", name + ".py"),
                            "test_" + name.replace(".", "_"))


def test_k8_work_at_256():
    # two steps a launch, the 19 populations of 256^3 nodes read and written
    # once: 16,777,216 x 19 x 2 x 4 B; 800 operations a node
    assert reader("fluid.k8_roofline").call_work(CUBE) == (2_550_136_832, 13_421_772_800)
    t, by = roofline.bound_us(2_550_136_832, 13_421_772_800)
    assert by == "bytes" and math.isclose(t, 761.234875, rel_tol=1e-6)


def test_share_percent():
    share, by = roofline.share_percent(3.35e9, 0.0, 2000.0)  # 1000 us of bytes in 2000
    assert by == "bytes" and math.isclose(share, 50.0)
    share, by = roofline.share_percent(0.0, 67e9, 1000.0)  # 1000 us of float32 operations
    assert by == "flops" and math.isclose(share, 100.0)
    assert roofline.share_percent(1.0, 1.0, 0.0) == (None, None)


@pytest.mark.parametrize("name,short", [
    ("void hc::(anonymous namespace)::tile_gather_kernel(float4 const*, hc::TileBins, "
     "float*, int, int, int, hc::Tiles)", "tile_gather_kernel"),
    ("void stream_collide_kernel<false>(float const*, float*, int)", "stream_collide_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3>)", "vectorized_elementwise_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_kernel_function(name, short):
    assert trace.kernel_function(name) == short


def test_the_readers_name_kernels_of_the_program():
    """Every kernel a roofline reads is a __global__ function of the
    program's CUDA sources."""
    from hemocell_tpu_torch import _build

    library = set()
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu*")):
        with open(path) as fh:
            library.update(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\("
                                      r"(?:[^()]|\([^()]*\))*\)\s*)?(?:void\s+)?(\w+)\s*\(",
                                      fh.read()))
    for m in spec.benchmark_json()["per_layer"]:
        for k in getattr(reader(m["name"]), "KERNELS", ()):
            assert k in library, (m["name"], k)
        for c in getattr(reader(m["name"]), "COUNTERS", ()):
            assert hasattr(trace.resolve_counter(c), "launches"), c


def test_intervals_and_gaps():
    iv = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (30.0, 31.0)]
    assert trace.union_us(iv) == 18.0
    assert trace.gaps(iv) == [(12.0, 20.0), (25.0, 30.0)]
    host = [("aten::index", 11.0, 19.0), ("outer", 0.0, 40.0), ("cudaLaunchKernel", 26.0, 27.0)]
    named = trace.name_gaps(trace.gaps(iv), host, n_named=1)
    assert named == {"aten::index": 8.0, "shorter gaps": 5.0}
    assert trace.name_gaps(trace.gaps(iv), host) == {"aten::index": 8.0, "outer": 5.0}


def test_a_call_is_timed_by_the_mean_of_its_events():
    """An event the profiler dropped changes no mean: a call of two kernels
    takes the sum of their mean event times."""
    r = trace.Reading(iterations=10, window_us=1.0, busy_us=1.0,
                      launches=5, kernels={"a": [3, 30.0], "b": [2, 8.0]}, calls={},
                      config={})
    assert r.call_us(("a", "b")) == 14.0
    assert r.call_us(("a", "missing")) == 0.0


def test_the_device_and_runner_readers():
    """Over one traced window of 10 iterations, 300 us busy of 400 us with 5
    device events: idle share 0.25, busy 30 us and 0.5 events an
    iteration."""
    r = trace.Reading(iterations=10, window_us=400.0, busy_us=300.0, launches=5,
                      kernels={}, calls={}, config={})
    assert reader("device.idle_share").read(r) == 0.25
    assert reader("device.busy_us_per_it").read(r) == 30.0
    assert reader("runner.launches_per_it").read(r) == 0.5
    idle = trace.Reading(iterations=10, window_us=400.0, busy_us=0.0, launches=0,
                         kernels={}, calls={}, config={})
    assert reader("device.idle_share").read(idle) is None


def test_a_gap_that_is_not_finite_fails_and_stays_json():
    import json

    from benchmark.lib import check

    ok, rows = check.verdict({"populations": float("nan")}, {"populations": 1e-7})
    assert ok is False and math.isfinite(rows["populations"]["value"])
    json.loads(json.dumps(rows, allow_nan=False))
    ok, rows = check.verdict({}, {"populations_start": 1e-7})
    assert ok is False
