"""The readers of the program's host spans (``harness/program_spans.py`` and
the nine ``extract.host.*`` and ``search.bulk.*`` metrics) on a hand-made
slice, with hand-made spans put into the program's recorder."""

import pytest

from conftest import ROOT, load
from harness import runner, spec as hspec, trace

from dirjax_torch.utils import timer

# metric -> (span names it reads, the cell it is listed in, ms or us)
READERS = {
    "extract.host.decode_ms_per_img": (("loader.decode",), "extract", 1e3),
    "extract.host.loader_wait_ms_per_batch": (("extract.wait",), "extract", 1e3),
    "extract.host.upload_ms_per_batch": (("extract.upload",), "extract", 1e3),
    "extract.host.forward_ms_per_batch": (("extract.forward",), "extract", 1e3),
    "extract.host.conv_us_per_call": (("conv.call",), "extract", 1e6),
    "search.bulk.queue_wait_ms": (("batcher.wait",), "search", 1e3),
    "search.bulk.launch_ms": (("index.launch",), "search", 1e3),
    "search.bulk.pull_ms": (("index.pull",), "search", 1e3),
    "search.bulk.front_us_per_request": (("server.parse", "server.reply"), "search", 1e6),
}
CELLS = {"extract": "r101_ap_gem.extract_jpeg1024", "search": "r101_ap_gem.search_bulk64_closed"}
LO, HI = 100.0, 105.0   # the slice's ends on the host clock


@pytest.fixture(autouse=True)
def fresh_spans():
    timer.clear()
    yield
    timer.clear()


def _reading(cell: str, traced: bool = True):
    t = trace.Trace(window_s=HI - LO, busy_s=1.0, events=[], host_start=LO, host_stop=HI)
    return runner.Reading(hspec.load_cell(ROOT, CELLS[cell]), t if traced else None, {})


def _put(name: str, lengths_s):
    """Spans of ``name`` in the slice with the given lengths, and three
    outside it that a reader must not see: before, at its stop, after."""
    for i, length in enumerate(lengths_s):
        timer.record(name, LO + 0.5 * i, LO + 0.5 * i + length, 8)
    for start in (LO - 1.0, HI, HI + 2.0):
        timer.record(name, start, start + 100.0, 8)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_takes_the_mean_of_its_spans_in_the_slice(metric):
    names, cell, scale = READERS[metric]
    lengths = {"loader.decode": [0.002, 0.004], "extract.wait": [0.010, 0.030, 0.020],
               "extract.upload": [0.015], "extract.forward": [0.040, 0.020],
               "conv.call": [30e-6, 40e-6, 50e-6], "batcher.wait": [0.001, 0.003],
               "index.launch": [0.012, 0.016], "index.pull": [0.004, 0.002],
               "server.parse": [100e-6, 300e-6], "server.reply": [50e-6]}
    read = hspec.metric_reader(ROOT, metric)
    assert read(_reading(cell)) is None          # no span yet
    for name in names:
        _put(name, lengths[name])
    want = sum(sum(lengths[n]) / len(lengths[n]) for n in names) * scale
    assert read(_reading(cell)) == pytest.approx(want, rel=1e-6)
    assert read(_reading(cell, traced=False)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_of_a_ring_that_dropped_spans_reads_none(metric, monkeypatch):
    names, cell, _ = READERS[metric]
    monkeypatch.setattr(timer, "CAPACITY", 4)
    for name in names:
        _put(name, [0.001])
    assert hspec.metric_reader(ROOT, metric)(_reading(cell)) is not None
    timer.record(names[-1], LO, LO + 0.001, 8)   # a fifth span of a ring of four
    assert timer.dropped(names[-1]) == 1
    assert hspec.metric_reader(ROOT, metric)(_reading(cell)) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """A program that records no spans (the recorder without ``spans``)
    gives every reader nothing, and none raises."""
    for name in ("loader.decode", "server.parse", "server.reply"):
        _put(name, [0.001])
    monkeypatch.delattr(timer, "spans")
    for metric, (_, cell, _) in READERS.items():
        assert hspec.metric_reader(ROOT, metric)(_reading(cell)) is None


def test_each_reader_is_listed_in_its_cell_alone():
    spec = load(ROOT + "/BENCHMARK.json")
    entries = {m["name"]: m for m in spec["per_layer"]}
    for metric, (_, cell, scale) in READERS.items():
        m = entries[metric]
        assert m["workloads"] == [CELLS[cell]] and m["source"] == "program_span"
        assert m["better"] == "lower" and m["unit"] == ("ms" if scale == 1e3 else "us")
        assert m["moves"] == ("extract_img_per_s" if cell == "extract" else "search_qps")
