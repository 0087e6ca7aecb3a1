"""The frozen roofline arithmetic at the Rail shapes and the trace
reduction on hand-made events."""

import pytest
import torch

import portbench_tiny  # noqa: F401  (puts the harness on the path)
from pbench import kernels, roofline, trace

N, NDIAG, Q = 79841, 5, 48  # DIA: offsets 0, ±1, ±282
NB, K, BS = 624, 7, 128     # block-ELL


def test_k1_counts_at_rail_shapes():
    nbytes, flops = roofline.k1_counts(NDIAG, N, Q, 8, False)
    assert nbytes == 8 * (NDIAG * N + 2 * N * Q)
    assert flops == 2 * NDIAG * N * Q
    t, by = roofline.bound_s("k1", 8, nbytes, flops)
    assert by == "bytes"
    assert round(t * 1e6, 2) == 19.26  # PERF.md's K1 bound, f64 mmT q = 48
    nbytes_e, flops_e = roofline.k1_counts(NDIAG, N, Q, 8, True)
    assert nbytes_e - nbytes == 8 * N * Q and flops_e - flops == 3 * N * Q


def test_k2_counts_at_rail_shapes():
    nbytes, flops = roofline.k2_counts(NB, K, BS, N, Q, 8)
    assert nbytes == 8 * NB * K * BS * BS + 4 * NB * K + 2 * 8 * N * Q
    assert flops == 2 * NB * K * BS * BS * Q
    t, by = roofline.bound_s("k2", 8, nbytes, flops)
    assert by == "bytes"
    assert round(t * 1e6, 2) == 189.21  # PERF.md's K2 bound, f64 q = 48


def test_k1_f64_operations_against_the_cuda_core_peak():
    assert roofline.PEAK_FLOP_S[("k1", 8)] == 34e12
    t, by = roofline.bound_s("k1", 8, 1.0, 34e12)
    assert by == "operations" and t == pytest.approx(1.0)


def test_wrapper_counts_a_call():
    data = torch.zeros(NDIAG, 1000, dtype=torch.float64)
    Xt = torch.zeros(Q, 1000, dtype=torch.float64)
    nbytes, flops, bound = kernels._k1_mm_t(data, (0,), Xt, Z=Xt, alpha=1.0, beta=2.0)
    assert (nbytes, flops) == roofline.k1_counts(NDIAG, 1000, Q, 8, True)
    assert bound == roofline.bound_s("k1", 8, nbytes, flops)[0]
    assert kernels._k1_mm(data, (0,), torch.zeros(1000, 0, dtype=torch.float64)) == (0, 0, 0.0)


class Ev:
    def __init__(self, dev, name, start, dur, corr=0, linked=0, tid=1, annotation=False):
        self.dev = torch.autograd.DeviceType.CUDA if dev == "cuda" else torch.autograd.DeviceType.CPU
        self.n, self.s, self.d, self.c, self.l, self.t = name, start, dur, corr, linked, tid
        self.a = annotation

    def is_user_annotation(self):
        return self.a

    def device_type(self):
        return self.dev

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.l

    def start_thread_id(self):
        return self.t


def test_reduce_events():
    evs = [
        Ev("cpu", "portbench.k1", 100, 50),
        Ev("cpu", "aten::mul", 10, 20),
        Ev("cpu", "cudaLaunchKernel", 15, 5, corr=7),
        Ev("cpu", "cuLaunchKernel", 110, 5, corr=8),
        Ev("cpu", "cudaStreamSynchronize", 300, 100),
        Ev("cpu", "aten::add", 420, 20),
        Ev("cpu", "cudaLaunchKernel", 425, 5, corr=9),
        Ev("cuda", "mul_kernel", 30, 100, corr=7),
        Ev("cuda", "dia_spmm", 120, 200, corr=8),   # overlaps the first
        Ev("cuda", "portbench.k1", 120, 200),       # the range on the device: no work
        Ev("cpu", "smw.solve", 5, 500, annotation=True),
        Ev("cuda", "smw.solve", 30, 520, annotation=True),  # the program's span: no work
        Ev("cuda", "Memcpy DtoH", 500, 50, corr=9),
    ]
    out = trace.reduce_events(evs, window_s=1e-6)
    assert out["busy_s"] == pytest.approx((320 - 30 + 50) * 1e-9)
    assert out["ranges"]["portbench.k1"] == {"device_s": pytest.approx(200e-9), "kernels": 1}
    assert out["device_ops"][0][0] == "dia_spmm"
    assert out["idle_gaps"] == [["after sync, then aten::add", pytest.approx(180e-9)]]


def test_reduce_events_without_device_work():
    out = trace.reduce_events([Ev("cpu", "aten::mul", 0, 5)], window_s=1.0)
    assert out["busy_s"] == 0.0 and out["ranges"] == {}


def test_shares_are_silent_without_device_time():
    meter = trace.Meter()

    class R:
        pass

    R.trace = {"ranges": {}, "busy_s": 0.0, "window_s": 1.0}
    R.meter = meter
    R.untraced_walls = [0.5]

    assert kernels.roofline_pct(R, kernels.K1_RANGE) is None
    assert kernels.idle_pct(R) is None


def test_idle_share_divides_by_the_untraced_wall():
    """The profiler slows the host, not the device: the busy seconds of the
    traced request count against the mean wall of the untraced ones."""

    class R:
        pass

    R.trace = {"ranges": {}, "busy_s": 1.5, "window_s": 6.0}
    R.untraced_walls = []
    assert kernels.idle_pct(R) is None
    R.untraced_walls = [2.0, 4.0]
    assert kernels.idle_pct(R) == pytest.approx(50.0)


@pytest.mark.cuda
def test_k1_share_on_the_card():
    """On the card: a traced K1 call owns its kernel's device time, and the
    share it gives stays under 100 %."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm

    data = torch.randn(NDIAG, N, dtype=torch.float64, device="cuda")
    Xt = torch.randn(Q, N, dtype=torch.float64, device="cuda")
    offs = (-282, -1, 0, 1, 282)
    dia_spmm.dia_mm_t(data, offs, Xt)
    torch.cuda.synchronize()

    class R:
        pass

    R.meter = trace.Meter()
    with kernels.k1(R):
        _, R.trace = trace.capture(lambda: [dia_spmm.dia_mm_t(data, offs, Xt) for _ in range(5)])
    assert R.trace["ranges"][kernels.K1_RANGE]["kernels"] == 5
    assert R.trace["busy_s"] > 0
    assert 0 < kernels.roofline_pct(R, kernels.K1_RANGE) <= 100
