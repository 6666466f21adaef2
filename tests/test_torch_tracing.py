"""The port's spans and counters (``utils/tracing.py``), on the CPU.

* Off (no profiler, no ``recording()``) nothing is recorded; spans nest
  with their parents' ids and units; their start and end lie within 1 ms of
  the ``torch.profiler`` event of the same name (one clock).
* Two ``Trainer.train()`` steps under a CPU profile give one ``train.step``
  per step, with ``train.d_phase``, ``train.g_phase`` and ``train.update``
  under it, and the loop's other spans; the losses and the model are those
  of the same steps with spans off.
* A 16-px ``attfind_extraction`` call gives as many ``attfind.chunk``
  spans as chunks, and the same records with spans on and off.
* A snapshot carries ``ops.LAUNCHES``; ``trace`` writes the region's spans
  beside its Chrome trace.
* ``StepTimer`` and the trainer's drain keep the rolling window of a GPU
  run on the blocks' event deltas (stub events).
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stylex_tpu_torch.attfind.extraction import attfind_extraction
from stylex_tpu_torch.config import ModelConfig, TrainConfig
from stylex_tpu_torch.models.classifiers import build_classifier
from stylex_tpu_torch.models.stylex import build_stylex
from stylex_tpu_torch.ops import LAUNCHES
from stylex_tpu_torch.utils import tracing
from stylex_tpu_torch.utils.profiling import StepTimer, trace

torch.set_num_threads(2)

TINY = ModelConfig(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.reset()
    yield
    tracing.reset()


def _names(snap):
    return collections.Counter(s["name"] for s in snap["spans"])


def test_nothing_is_recorded_when_off():
    assert not tracing.is_recording()
    with tracing.span("a", unit=3):
        tracing.count("c")
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {} and snap["rank"] == 0


def test_spans_nest_with_parent_ids_and_units():
    with tracing.recording():
        with tracing.span("outer", unit=7, k=2):
            with tracing.span("inner"):
                tracing.count("c", 3)
            with tracing.span("other", unit=1):
                pass
        tracing.count("c")
        with tracing.span("root"):
            pass
    with tracing.span("after"):
        pass
    spans = {s["name"]: s for s in tracing.snapshot()["spans"]}
    assert set(spans) == {"outer", "inner", "other", "root"}
    outer = spans["outer"]
    assert outer["parent"] is None and outer["attrs"] == {"k": 2}
    assert spans["inner"]["parent"] == outer["id"] and spans["inner"]["unit"] == 7
    assert spans["other"]["parent"] == outer["id"] and spans["other"]["unit"] == 1
    assert spans["root"]["parent"] is None and spans["root"]["unit"] is None
    assert outer["start_ns"] <= spans["inner"]["start_ns"] <= spans["inner"]["end_ns"]
    assert spans["other"]["end_ns"] <= outer["end_ns"]
    assert tracing.snapshot()["counters"] == {"c": 4}
    tracing.reset()
    assert tracing.snapshot()["spans"] == [] and tracing.snapshot()["counters"] == {}


def test_spans_share_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with tracing.span("clock.outer", unit=i):
                torch.ones(64).add_(1)
                with tracing.span("clock.inner"):
                    torch.ones(64).mul_(2)
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock."):
            events[e.name()].append((e.start_ns(), e.end_ns()))
    spans = tracing.snapshot()["spans"]
    assert _names(tracing.snapshot()) == {"clock.outer": 3, "clock.inner": 3}
    for s in spans:
        start, end = min(events[s["name"]], key=lambda ev: abs(ev[0] - s["start_ns"]))
        assert abs(start - s["start_ns"]) < 1_000_000, s
        assert abs(end - s["end_ns"]) < 1_000_000, s


def _trainer(tmp_path):
    from stylex_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(batch_size=2, gradient_accumulate_every=2, aug_prob=0.0, save_every=1000,
                     evaluate_every=1000, num_image_tiles=2)
    t = Trainer(name="t", base_dir=str(tmp_path), model_cfg=TINY, train_cfg=tc,
                classifier_name="mobilenet", device="cpu")
    t.set_data_src(dataset_name="synthetic")
    t.init_stylex()
    t.state.step = 1  # no save or evaluation after these steps
    return t


def test_train_steps_under_a_profiler(tmp_path):
    timing = ("step_time_s", "steps_per_sec", "imgs_per_sec")
    plain = _trainer(tmp_path / "off")
    t = _trainer(tmp_path / "on")
    try:
        off = [plain.train() for _ in range(2)]
        assert tracing.snapshot()["spans"] == []
        with profile(activities=[ProfilerActivity.CPU]):
            on = [t.train() for _ in range(2)]
        for a, b in zip(on, off):  # the same losses with spans on and off
            assert {k: v for k, v in a.items() if k not in timing} == \
                {k: v for k, v in b.items() if k not in timing}
        for (name, a), b in zip(t.state.model.state_dict().items(),
                                plain.state.model.state_dict().values()):
            assert torch.equal(a, b), name
    finally:
        t.close()
        plain.close()
    snap = tracing.snapshot()
    spans = snap["spans"]
    by_id = {s["id"]: s for s in spans}
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["unit"] for s in steps] == [1, 2]
    for step in steps:
        children = sorted((s["name"] for s in spans if s["parent"] == step["id"]))
        assert children == ["train.d_phase", "train.g_phase", "train.update"]
        assert all(s["unit"] == step["unit"] for s in spans if s["parent"] == step["id"])
        assert by_id[step["parent"]]["name"] == "train.block"
    names = _names(snap)
    assert names["train.block"] == 2 and names["train.draws"] == 2 and names["train.drain"] == 2
    assert all(s["attrs"] == {"k": 1} for s in spans if s["name"] == "train.block")
    # three images stacks of A = 2 micro-batches a step, one take each
    assert names["train.data_wait"] == 2 * 3 * 2
    assert "train.wait" not in names  # the host's blocks land at once
    # the classifier's batch norms on the CPU: every layer on the plain chain
    assert set(snap["counters"]) <= {"loader.blocked", "classifier.bn_plain"}
    assert snap["counters"]["classifier.bn_plain"] > 0
    waits = [s for s in spans if s["name"] == "train.data_wait"]
    assert all(by_id[s["parent"]]["name"] == "train.block" for s in waits)


def _sweep_inputs():
    model = build_stylex(TINY, seed=0, device="cpu").eval()
    clf = build_classifier("mobilenet", 16, TINY.num_classes, None, device="cpu")
    gen = np.random.default_rng(0)
    images = gen.random((2, 16, 16, 3), dtype=np.float32)
    noise = gen.random((1, 16, 16, 1), dtype=np.float32)
    return model, clf, images, noise


def test_an_attfind_call_has_a_chunk_span_per_chunk_and_the_same_records():
    model, clf, images, noise = _sweep_inputs()

    def call():
        return attfind_extraction(model, clf.classify_images, images, noise, coord_batch=64,
                                  chunks_per_dispatch=2, progress=False)

    off = call()
    assert tracing.snapshot()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = call()
    for field in ("style_change", "latents", "base_prob", "style_coordinates", "discriminator"):
        np.testing.assert_array_equal(getattr(on, field), getattr(off, field))
    snap = tracing.snapshot()
    spans = snap["spans"]
    chunks = sum(-(-2 * 2 * (i + o) // 64) for i, o in model.G.block_dims)
    names = _names(snap)
    assert names["attfind.chunk"] == chunks
    assert names["attfind.call"] == 1 and names["attfind.phase1"] == 1
    assert names["attfind.capture"] == 1 and names["attfind.records"] == 1
    assert names["attfind.block"] == len(model.G.block_dims)
    by_id = {s["id"]: s for s in spans}
    blocks = sorted(s["unit"] for s in spans if s["name"] == "attfind.block")
    assert blocks == list(range(len(model.G.block_dims)))
    for s in spans:
        if s["name"] in ("attfind.chunk", "attfind.copy"):
            assert by_id[s["parent"]]["name"] == "attfind.block"
            assert s["unit"] == by_id[s["parent"]]["unit"]
    assert "attfind.wait" not in names  # no device to wait for


def test_a_snapshot_carries_the_launch_counts(monkeypatch):
    assert set(LAUNCHES) >= {"upsample2x_bilinear", "blur3"}
    monkeypatch.setitem(LAUNCHES, "blur3", LAUNCHES["blur3"] + 5)  # counted always
    snap = tracing.snapshot()
    assert snap["launches"] == LAUNCHES and snap["launches"] is not LAUNCHES
    tracing.reset()
    assert tracing.snapshot()["launches"] == LAUNCHES  # reset leaves them


def test_trace_writes_the_regions_spans(tmp_path):
    with tracing.recording():
        with tracing.span("before"):
            pass
    with trace(str(tmp_path)):
        with tracing.span("inside", unit=1):
            tracing.count("n")
    [spans_file] = tmp_path.glob("spans_*.json")
    [trace_file] = tmp_path.glob("trace_*.json")
    assert spans_file.name[len("spans_"):] == trace_file.name[len("trace_"):]
    data = json.loads(spans_file.read_text())
    assert [s["name"] for s in data["spans"]] == ["inside"]
    assert data["counters"] == {"n": 1} and data["rank"] == 0
    assert set(data["launches"]) == set(LAUNCHES)
    assert not tracing.is_recording()


class _Event:
    """A completed CUDA event's stand-in: ``elapsed_time`` in ms from the
    stamps."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms

    def query(self):
        return True

    def synchronize(self):
        pass


def test_step_timer_window_follows_the_event_deltas():
    timer = StepTimer(window=3)
    timer.mark(_Event(100.0))  # no event before it: nothing added
    assert list(timer.durations) == []
    timer.mark(_Event(400.0))
    timer.mark(_Event(1000.0))
    assert list(timer.durations) == pytest.approx([0.3, 0.6])
    timer.mark(_Event(1500.0))
    timer.mark(_Event(1600.0))  # the window keeps the last three
    assert list(timer.durations) == pytest.approx([0.6, 0.5, 0.1])
    assert timer.stats(images_per_step=12)["imgs_per_sec"] == pytest.approx(12 / 0.4)
    timer.restart()
    timer.mark(_Event(5000.0))  # the first after a restart starts the clock again
    assert len(timer.durations) == 3 and timer.last_event.ms == 5000.0
    timer.mark(_Event(5200.0))
    assert timer.durations[-1] == pytest.approx(0.2)


def test_trainer_drain_times_the_blocks_by_their_events(tmp_path):
    from stylex_tpu_torch.train.trainer import _Pending

    t = _trainer(tmp_path)
    try:
        metrics = {"g_loss": torch.tensor(1.0), "d_loss": torch.tensor(2.0)}
        t.step_timer.mark(_Event(0.0))
        for step, steps, ms in ((1, 1, 250.0), (2, 3, 1150.0), (5, 1, 1400.0)):
            block = _Pending(step, [metrics] * steps, "cpu")
            block.event = _Event(ms)
            t._pending.append(block)
        t._drain(0)
        assert list(t.step_timer.durations) == pytest.approx([0.25, 0.9, 0.25])
        assert t.step_timer.last_event.ms == 1400.0
        t.load(-1)  # a load restarts the clock
        assert t.step_timer.last_event is None
    finally:
        t.close()
