"""The trace reduction on a small synthetic Chrome trace."""

import pytest

import portbench_helpers  # noqa: F401  (puts the repository on sys.path)
from portbench import trace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_parse_unions_device_time_and_names_gaps_by_the_host():
    data = {"traceEvents": [
        _ev("void k1<float>(float*)", "kernel", 0, 10),
        _ev("void k1<float>(float*)", "kernel", 5, 10),     # overlaps
        _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 40, 5),
        _ev("void k2<float>()", "kernel", 50, 30),
        _ev("aten::stack", "cpu_op", 10, 30),
        _ev("my_step", "user_annotation", 0, 100),
        {"ph": "i", "name": "marker", "ts": 3},
    ]}
    p = trace.parse(data, steps=2, window_s=100e-6)
    assert p["busy_s"] == pytest.approx(50e-6)      # 0-15, 40-45, 50-80
    assert p["kernels"]["void k1<float>(float*)"] == [2, pytest.approx(2e-5)]
    assert p["idle_gaps"][0] == ["aten::stack", pytest.approx(25e-6)]
    assert p["idle_gaps"][1] == ["my_step", pytest.approx(5e-6)]
    assert p["device_ops"][0] == ["void k2<float>()", pytest.approx(3e-5)]
    assert trace.kernel(p, "k1") == (2, pytest.approx(2e-5))
    assert trace.kernel(p, "k") == (0, 0.0)


def test_a_trace_without_device_time_is_an_error():
    data = {"traceEvents": [_ev("aten::mm", "cpu_op", 0, 10)]}
    with pytest.raises(trace.NoDeviceTime):
        trace.parse(data, steps=1, window_s=1.0)
