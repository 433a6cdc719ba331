"""The reduction from a trace: the device's busy time is the union of its operations'
intervals, so overlapping kernels count once."""
import numpy as np
import pytest

from benchmark import harness, trace


class Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU


def synthetic():
    # window [1000, 2000); kernels [1100, 1300), [1200, 1400) overlap (union 300),
    # [1500, 1600), and [1900, 2100) clipped to [1900, 2000): busy 300 + 100 + 100 = 500
    evs = [Ev(trace.WINDOW, 1000, 1000, False),
           Ev("void uttk::ln_kernel(float)", 1100, 200, True),
           Ev("void uttk::k1::attn_kernel<64>(float)", 1200, 200, True),
           Ev("conv3x3_kernel", 1500, 100, True),
           Ev("conv3x3_kernel", 1900, 200, True),
           Ev("cudaLaunchKernel", 1090, 5, False), Ev("cudaLaunchKernel", 1190, 5, False),
           Ev("cudaLaunchKernel", 1490, 5, False),
           Ev("aten::copy_", 1410, 80, False),
           Ev("cudaLaunchKernel", 500, 5, False)]  # outside the window
    return trace.from_events(evs)


def test_busy_is_the_union_of_intervals():
    tr = synthetic()
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(500e-9)
    assert tr.launches == 3
    idle = harness.reader("idle_share.rally").read({"trace": tr})
    assert idle == pytest.approx(50.0)


def test_union_by_hand():
    iv = trace.union(np.array([0, 5, 2, 20]), np.array([3, 8, 4, 30]), 1, 25)
    assert iv.tolist() == [[1, 4], [5, 8], [20, 25]]


def test_idle_gaps_are_named_by_the_host():
    gaps = synthetic().idle_gaps()
    assert gaps[0][1] == pytest.approx(300e-9)  # [1600, 1900): no host op there
    assert ["aten::copy_", pytest.approx(100e-9)] in gaps  # [1400, 1500)
    assert len(gaps) == 3  # and [1000, 1100) before the first kernel


def test_k1_time_takes_its_layernorm_and_projection():
    tr = synthetic()
    assert tr.k1_seconds() == pytest.approx(400e-9)  # ln 200 + attn 200
    assert tr.kernel_seconds(lambda n: "conv3x3_kernel" in n) == pytest.approx(200e-9)


def test_readers_return_nothing_without_a_trace():
    for m in harness.benchmark_spec()["per_layer"]:
        assert harness.reader(m["name"]).read({"trace": None, "frames": 0}) is None


def test_window_between_the_marker_kernels():
    # on the card no annotation is traced: the window runs from the first marker's start to
    # the last's end, and the markers' own launches are not the program's
    evs = [Ev("cudaLaunchKernel", 990, 5, False), Ev("at::cuda::spin_kernel(long)", 1000, 2, True),
           Ev("conv3x3_kernel", 1100, 300, True), Ev("cudaLaunchKernel", 1090, 5, False),
           Ev("cudaLaunchKernel", 1500, 5, False), Ev("at::cuda::spin_kernel(long)", 1998, 2, True)]
    tr = trace.from_events(evs)
    assert tr.window == (1000, 2000) and tr.launches == 1
    assert tr.busy_s == pytest.approx(300e-9) and tr.names == ["conv3x3_kernel"]


def test_markers_inside_the_window_are_not_launches():
    # three markers at each end: all but the first are launched inside the window
    spin = "at::cuda::spin_kernel(long)"
    evs = [Ev("cudaLaunchKernel", 990, 1, False), Ev(spin, 1000, 2, True),
           Ev("cudaLaunchKernel", 1001, 1, False), Ev(spin, 1003, 2, True),
           Ev("cudaLaunchKernel", 1004, 1, False), Ev(spin, 1006, 2, True),
           Ev("cudaLaunchKernel", 1090, 5, False), Ev("conv3x3_kernel", 1100, 300, True),
           Ev("cudaLaunchKernel", 1500, 1, False), Ev(spin, 1990, 2, True),
           Ev("cudaLaunchKernel", 1501, 1, False), Ev(spin, 1993, 2, True),
           Ev("cudaLaunchKernel", 1502, 1, False), Ev(spin, 1996, 4, True)]
    tr = trace.from_events(evs)
    assert tr.window == (1000, 2000) and tr.launches == 1


def test_window_is_the_device_span_where_the_markers_were_lost():
    evs = [Ev("cudaLaunchKernel", 1090, 5, False), Ev("conv3x3_kernel", 1100, 300, True),
           Ev("cudaLaunchKernel", 1400, 5, False), Ev("gemm_kernel", 1500, 100, True)]
    tr = trace.from_events(evs)
    assert tr.window == (1100, 1600) and tr.launches == 1  # the first launch precedes it
    assert tr.busy_s == pytest.approx(400e-9)
    assert trace.from_events([Ev("cudaLaunchKernel", 1090, 5, False)]) is None
