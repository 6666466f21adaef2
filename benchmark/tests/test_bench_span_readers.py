"""The readers of the program's spans on a synthetic snapshot, and their
None without the program's module or without spans."""

import sys
import types

import pytest

from benchmark import spans

from conftest import ROOT
from test_bench_readers import read

NAMES = ("data_wait_ms.train", "step_host_ms.train", "chunk_host_ms.sweep")
TRAIN = NAMES[:2]
MS = 1_000_000  # ns


def _span(i, name, start_ms, end_ms, parent=None, unit=None):
    return dict(id=i, parent=parent, name=name, unit=unit, start_ns=int(start_ms * MS),
                end_ns=int(end_ms * MS))


def _train_snapshot():
    """Two steps: a block with three loader takes, draws, the step (its
    phases), and a drain that waits once in the second block."""
    out, i = [], 0
    for step, t0 in ((30055, 0.0), (30056, 1000.0)):
        block = i + 1
        out.append(_span(block, "train.block", t0, t0 + 900.0))
        for j in range(3):
            out.append(_span(block + 1 + j, "train.data_wait", t0 + j, t0 + j + 0.5, block))
        out.append(_span(block + 4, "train.draws", t0 + 3.0, t0 + 4.0, block))
        out.append(_span(block + 5, "train.step", t0 + 4.0, t0 + 104.0, block, step))
        out.append(_span(block + 6, "train.d_phase", t0 + 4.0, t0 + 50.0, block + 5, step))
        out.append(_span(block + 7, "train.drain", t0 + 104.0, t0 + 900.0, block))
        if step == 30056:
            out.append(_span(block + 8, "train.wait", t0 + 105.0, t0 + 899.0, block + 7))
        i += 10
    return dict(rank=0, spans=out, counters={"loader.blocked": 1}, launches={"blur3": 0})


def _sweep_snapshot():
    out = [_span(1, "attfind.call", 0.0, 9000.0, unit=0),
           _span(2, "attfind.phase1", 1.0, 30.0, 1, 0), _span(3, "attfind.wait", 30.0, 60.0, 1, 0)]
    for k in range(2):
        b = 10 + 10 * k
        out.append(_span(b, "attfind.block", 100.0 + 1000 * k, 1000.0 + 1000 * k, 1, k))
        out.append(_span(b + 1, "attfind.chunk", 100.0 + 1000 * k, 110.0 + 1000 * k, b, k))
        out.append(_span(b + 2, "attfind.chunk", 110.0 + 1000 * k, 130.0 + 1000 * k, b, k))
        out.append(_span(b + 3, "attfind.wait", 130.0 + 1000 * k, 1000.0 + 1000 * k, b, k))
    return dict(rank=0, spans=out, counters={}, launches={})


@pytest.fixture
def program(monkeypatch):
    """Installs a stand-in of the program's tracing module that returns the
    snapshot given."""
    def install(snap):
        module = types.ModuleType(spans.MODULE)
        module.snapshot = lambda: snap
        monkeypatch.setitem(sys.modules, spans.MODULE, module)

    return install


def test_the_train_readers(program):
    program(_train_snapshot())
    rec = dict(kind="train")
    assert read("data_wait_ms.train", rec) == pytest.approx(6 * 0.5 / 2)
    # the drain's wait lies outside the steps: each step's 100 ms
    assert read("step_host_ms.train", rec) == pytest.approx(100.0)
    assert read("chunk_host_ms.sweep", rec) is None


def test_the_step_host_time_holds_the_waits_inside_a_step(program):
    snap = _train_snapshot()
    snap["spans"][5]["end_ns"] += 20 * MS  # step 30055 ends 20 ms later
    snap["spans"].append(_span(99, "train.wait", 60.0, 80.0, 6, 30055))  # inside step 30055
    program(snap)
    assert read("step_host_ms.train", dict(kind="train")) == pytest.approx((120.0 + 100.0) / 2)


def test_the_sweep_readers(program):
    program(_sweep_snapshot())
    rec = dict(kind="attfind")
    assert read("chunk_host_ms.sweep", rec) == pytest.approx(15.0)
    for name in TRAIN:
        assert read(name, rec) is None, name


def test_nothing_without_the_module_or_its_spans(program, monkeypatch):
    monkeypatch.delitem(sys.modules, spans.MODULE, raising=False)
    for kind in ("train", "attfind"):
        for name in NAMES:
            assert read(name, dict(kind=kind)) is None, name
    program(dict(rank=0, spans=[], counters={"loader.blocked": 3}, launches={}))
    for kind in ("train", "attfind"):
        for name in NAMES:
            assert read(name, dict(kind=kind)) is None, name
    snap = _train_snapshot()
    snap["spans"] = [s for s in snap["spans"] if s["name"] != "train.data_wait"]
    program(snap)
    assert read("data_wait_ms.train", dict(kind="train")) is None


def test_the_new_metrics_are_listed_for_their_cells_only():
    from benchmark import common
    from benchmark import run as bench

    spec = common.load_json(ROOT / "BENCHMARK.json")
    train = [n for n, _ in bench.metric_names(spec, "ffhq256.train", True)]
    sweep = [n for n, _ in bench.metric_names(spec, "plant64.attfind", True)]
    assert set(TRAIN) <= set(train) and "chunk_host_ms.sweep" not in train
    assert "chunk_host_ms.sweep" in sweep and not set(TRAIN) & set(sweep)
