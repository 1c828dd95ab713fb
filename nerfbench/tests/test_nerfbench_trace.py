"""The trace reduction on a hand-made timeline."""

import pytest

from nerfbench import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_busy_gaps_and_kernels():
    events = [ev("user_annotation", trace.SLICE, 100, 100),
              ev("cpu_op", "aten::item", 140, 20),
              ev("cpu_op", "outer", 130, 50),
              ev("kernel", "k_a", 90, 20),      # clipped to 100..110
              ev("kernel", "k_b", 105, 15),     # overlaps k_a: busy 100..120
              ev("gpu_memcpy", "copy", 170, 10),
              ev("kernel", "k_a", 195, 20)]     # clipped to 195..200
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((20 + 10 + 5) * 1e-6)
    assert s["kernel_s"]["k_a"] == pytest.approx(15e-6)
    assert trace.device_seconds(s, ("k_",)) == pytest.approx(30e-6)
    assert s["gaps"][0] == ["aten::item", pytest.approx(50e-6)]  # 120..170, middle in item
    assert s["gaps"][1] == ["host", pytest.approx(15e-6)]        # 180..195
    assert [n for n, _ in trace.top_ops(s)] == ["k_a", "k_b", "copy"]


def test_summarize_needs_the_slice():
    with pytest.raises(ValueError):
        trace.summarize([ev("kernel", "k", 0, 1)])
