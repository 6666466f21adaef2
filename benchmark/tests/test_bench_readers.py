"""The trace reduction and the metric readers on synthetic events and
step timings."""


import numpy as np
import pytest

from benchmark import common, trace_summary

from conftest import ROOT


def read(name, rec):
    return common.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", name).read(rec)


def test_busy_is_the_union_of_overlapping_intervals():
    dev = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 25.0, "a"), (21.0, 22.0, "c")]
    assert trace_summary.busy_us(dev) == 12.0 + 5.0
    rows = trace_summary.per_name(dev)
    assert rows[0] == {"name": "a", "us": 15.0, "calls": 2}


def test_idle_gaps_are_labelled_by_the_host_event_open():
    dev = [(0.0, 10.0, "k1"), (30.0, 40.0, "k2"), (45.0, 50.0, "k3")]
    host = [(5.0, 35.0, "cudaStreamSynchronize"), (41.0, 42.0, "cudaLaunchKernel")]
    gaps = dict(trace_summary.idle_gaps(dev, host, 0.0, 50.0))
    assert gaps == {"cudaStreamSynchronize": pytest.approx(20e-6),
                    "host between CUDA calls": pytest.approx(5e-6)}


def test_kinds_first_match_wins():
    rows = [dict(name="blur3_kernel<float>", us=1.0, calls=1),
            dict(name="sm80_xmma_fprop_cudnn", us=2.0, calls=1),
            dict(name="elementwise_kernel", us=3.0, calls=1), dict(name="mystery", us=4.0, calls=1)]
    kinds = trace_summary.by_kind(rows)
    assert kinds["hand-written kernels"] == 1.0 and kinds["convolution and GEMM"] == 2.0
    assert kinds["elementwise, copy, fill"] == 3.0 and kinds["other"] == 4.0


def test_p90_is_over_every_step_not_medians_of_pieces():
    steps = [400.0 if i % 5 == 4 else 100.0 for i in range(100)]  # a stall every fifth step
    rec = dict(kind="train", step_ms=steps)
    assert read("train_step_ms_p90", rec) == pytest.approx(np.percentile(steps, 90))
    pieces = [np.median(steps[i:i + 10]) for i in range(0, 100, 10)]
    assert read("train_step_ms_p90", rec) > np.percentile(pieces, 90)


def test_the_window_rate_is_all_work_over_all_time():
    rec = dict(kind="attfind", styles=3 * 157696, window_s=30.0)
    assert read("styles_per_s", rec) == 3 * 157696 / 30.0
    rec = dict(kind="train", images=90 * 32, window_s=45.0)
    assert read("train_images_per_s", rec) == 90 * 32 / 45.0
    assert read("styles_per_s", rec) is None


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = dict(kind="attfind", trace=None, counts=None, stage_walls=[], call_walls=[1.0],
               call_styles=[1], traced_calls=0, chunks_per_call=3)
    for name in ("upsample_roofline.sweep", "blur_roofline.sweep", "chunk_device_ms.sweep",
                 "device_idle.sweep", "sweep_mfu", "phase1_ms.sweep"):
        assert read(name, rec) is None, name
    trace = dict(busy_s=1.0, window_s=2.0, own_kernel_s={"upsample2x_bilinear": 0.0, "blur3": 0.0})
    rec.update(trace=trace, counts={"bytes": {"upsample": 1e9, "blur": 1e9}})
    assert read("upsample_roofline.sweep", rec) is None  # no kernel ran: no share, not 0


def test_a_roofline_share():
    trace = dict(busy_s=1.0, window_s=2.0,
                 own_kernel_s={"upsample2x_bilinear": 0.5, "blur3": 0.25})
    counts = {"bytes": {"upsample": 3.35e11, "blur": 3.35e11}}
    rec = dict(kind="attfind", trace=trace, counts=counts)
    assert read("upsample_roofline.sweep", rec) == pytest.approx(20.0)
    assert read("blur_roofline.sweep", rec) == pytest.approx(40.0)
    assert read("device_idle.sweep", rec) == pytest.approx(50.0)


def test_metric_names_follow_the_benchmark_file():
    from benchmark import run as bench

    spec = common.load_json(ROOT / "BENCHMARK.json")
    e2e = [n for n, _ in bench.metric_names(spec, "ffhq256.train", False)]
    assert e2e == ["train_images_per_s", "train_step_ms_p90", "setup_s"]
    layer = [n for n, _ in bench.metric_names(spec, "plant64.attfind", True)]
    assert "sweep_mfu" in layer and "train_mfu" not in layer
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in spec["workloads"]:
        wl = common.load_json(common.workload_path(w["name"]))
        assert wl["config"] == w["config"] and wl["driver"] == w["traffic"]
        assert wl["chips"] == w["chips"] and wl["why"] == w["why"]
