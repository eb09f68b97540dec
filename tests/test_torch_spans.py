"""The port's spans (``dirjax_torch.utils.timer``) on the CPU: the recorder
(off, on under ``enable()`` and under a ``torch.profiler`` session, parent
ids, the ring's bound, eight threads at once), and the sites that record
them on the extraction path, the index server's path and ``serve``'s exit
line."""

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from dirjax_torch.utils import timer

torch.set_num_threads(1)

NAMES = ("loader.decode", "extract.wait", "extract.upload", "extract.forward", "conv.call",
         "batcher.wait", "index.launch", "index.pull", "server.parse", "server.reply",
         "server.request")


@pytest.fixture(autouse=True)
def fresh_spans():
    timer.disable()
    timer.clear()
    yield
    timer.disable()
    timer.clear()


def _record_some():
    with timer.span("a", 3):
        pass
    timer.end(timer.begin(), "b", 2)


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def test_nothing_is_recorded_when_neither_enabled_nor_profiled():
    assert not timer.recording()
    assert timer.begin() is None and timer.span("a") is timer.span("b")
    _record_some()
    assert timer.spans("a") == timer.spans("b") == []


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_spans_are_recorded_while_enabled_or_profiled_and_not_after(how):
    if how == "enable":
        timer.enable()
        stop = timer.disable
    else:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        stop = prof.stop
    assert timer.recording()
    t0 = time.perf_counter()
    _record_some()
    stop()
    assert not timer.recording()
    _record_some()
    (a,), (b,) = timer.spans("a"), timer.spans("b")
    assert a[4] == 3 and b[4] == 2 and a[0] != b[0]
    for s in (a, b):
        assert t0 <= s[2] <= s[3]


def test_parent_ids_follow_nested_spans_on_one_thread():
    timer.enable()
    with timer.span("outer") as outer:
        with timer.span("middle") as middle:
            with timer.span("inner"):
                pass
            token = timer.begin()           # a begin/end span is no parent
            with timer.span("after_begin"):
                pass
            timer.end(token, "pair")
        with timer.span("sibling"):
            pass
    with timer.span("top"):
        pass
    (o,), (m,), (i,) = timer.spans("outer"), timer.spans("middle"), timer.spans("inner")
    assert (o[0], m[0]) == (outer.id, middle.id)
    assert o[1] == 0 and m[1] == o[0] and i[1] == m[0]
    assert timer.spans("pair")[0][1] == m[0] and timer.spans("after_begin")[0][1] == m[0]
    assert timer.spans("sibling")[0][1] == o[0] and timer.spans("top")[0][1] == 0
    assert o[2] <= m[2] <= i[2] <= i[3] <= m[3] <= o[3]


@pytest.mark.parametrize("extra", [0, 1, 37])
def test_the_ring_keeps_the_newest_spans_and_counts_the_rest(monkeypatch, extra):
    assert timer.CAPACITY == 65536
    monkeypatch.setattr(timer, "CAPACITY", 64)
    timer.enable()
    for i in range(64 + extra):
        timer.end(timer.begin(), "r", i)
    kept = timer.spans("r")
    assert [s[4] for s in kept] == list(range(extra, 64 + extra))
    assert timer.dropped("r") == extra and timer.dropped("other") == 0
    timer.clear()
    assert timer.spans("r") == [] and timer.dropped("r") == 0


def test_eight_threads_record_every_span_once():
    timer.enable()
    per, barrier = 3000, threading.Barrier(8)

    def work(t):
        barrier.wait()
        for i in range(per):
            with timer.span("thread", t):
                timer.end(timer.begin(), "pair", t)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    outer, pairs = timer.spans("thread"), timer.spans("pair")
    assert len(outer) == len(pairs) == 8 * per
    ids = [s[0] for s in outer + pairs]
    assert len(set(ids)) == len(ids)
    by_id = {s[0]: s for s in outer}
    for p in pairs:   # each pair's parent is a span of its own thread
        assert by_id[p[1]][4] == p[4]
    assert all(s[1] == 0 for s in outer)
    assert timer.dropped("thread") == timer.dropped("pair") == 0


# --------------------------------------------------------------------------
# the sites
# --------------------------------------------------------------------------

def _spans():
    return {name: timer.spans(name) for name in NAMES}


def test_extraction_records_decode_wait_upload_forward_and_each_conv(tmp_path):
    from dirjax_torch.datasets.generic import ImageList
    from dirjax_torch.extraction import FeatureExtractor, extract_image_features
    from dirjax_torch.models import create_model

    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(40, 32)] * 3 + [(32, 40)] * 2):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path, quality=90)
        paths.append(path)
    model = create_model("resnet18_rmac", out_dim=16)
    ex = FeatureExtractor(model, "cpu", dtype=torch.bfloat16)
    timer.enable()
    descs = extract_image_features(ImageList(imgs=paths), "", ex, batching="group",
                                   batch_size=2, threads=2)
    timer.disable()
    got = _spans()
    assert descs.shape == (5, 16) and np.isfinite(descs).all()
    batches = 3   # two of 40x32 and one left over, one of 32x40
    convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert convs == 20
    assert len(got["loader.decode"]) == 5 and all(s[4] == 1 for s in got["loader.decode"])
    for name in ("extract.wait", "extract.upload", "extract.forward"):
        assert sorted(s[4] for s in got[name]) == [1, 2, 2], name
    assert len(got["conv.call"]) == batches * convs
    forwards = {s[0] for s in got["extract.forward"]}
    assert {s[1] for s in got["conv.call"]} == forwards   # each conv inside its forward
    for name in ("batcher.wait", "index.launch", "server.request"):
        assert got[name] == []


def test_index_server_records_each_request_and_dispatch(tmp_path):
    from dirjax_torch.serve import Client, IndexServer
    from dirjax_torch.serving import RetrievalIndex

    rng = np.random.default_rng(1)
    db = rng.standard_normal((500, 32)).astype(np.float32)
    index = RetrievalIndex(db, dtype=torch.bfloat16, device="cpu")
    server = IndexServer(index, str(tmp_path / "s.sock"), max_batch=16, max_wait_ms=1.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    sizes = [1, 3, 5, 2, 4, 1]
    timer.enable()
    try:
        with Client(server.address) as client:
            futs = [client.search_async(rng.standard_normal((n, 32)), k=5) for n in sizes]
            answers = [f.result(timeout=60) for f in futs]
    finally:
        with Client(server.address) as c:
            c.shutdown_server()
        thread.join(timeout=30)
    timer.disable()
    assert not thread.is_alive() and [a[1].shape for a in answers] == [(n, 5) for n in sizes]
    got = _spans()
    for name in ("batcher.wait", "server.parse", "server.reply", "server.request"):
        assert sorted(s[4] for s in got[name]) == sorted(sizes), name
    batches = server.batcher.stats["batches"]
    for name in ("index.launch", "index.pull"):
        assert len(got[name]) == batches and sum(s[4] for s in got[name]) == sum(sizes), name
    parse = sorted(got["server.parse"], key=lambda s: s[2])
    request = sorted(got["server.request"], key=lambda s: s[2])
    reply = sorted(got["server.reply"], key=lambda s: s[2])
    for p, q, r in zip(parse, request, reply):   # both begin inside the request
        assert q[2] <= p[2] <= p[3] and q[2] <= r[2] <= r[3] <= q[3]
    for name in ("loader.decode", "conv.call"):
        assert got[name] == []


def test_serve_prints_its_latency_line_from_the_request_spans(tmp_path, capsys):
    from dirjax_torch.serve import Client, main as serve_main
    from dirjax_torch.serving import RetrievalIndex

    rng = np.random.default_rng(2)
    RetrievalIndex(rng.standard_normal((300, 32)).astype(np.float32), dtype=torch.bfloat16,
                   device="cpu").save(str(tmp_path / "i.npz"))
    sock = str(tmp_path / "m.sock")
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("server", serve_main(
        ["--index", str(tmp_path / "i.npz"), "--socket", sock, "--gpu", "-1",
         "--max-wait-ms", "1", "--warmup-k", "10"])), daemon=True)
    thread.start()
    with Client(sock, connect_timeout=60) as client:
        for n in (1, 4, 2):
            client.search(rng.standard_normal((n, 32)), k=10)
        client.shutdown_server()
    thread.join(timeout=60)
    assert not thread.is_alive() and not timer.recording()
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("latency ms: ")]
    assert len(line) == 1, out
    words = line[0].split()[2:]
    assert words[::2] == ["p50", "p90", "p99", "mean", "max"]
    values = [float(v) for v in words[1::2]]
    assert all(v > 0 for v in values) and values[0] <= values[2] <= values[4]
    assert len(timer.spans("server.request")) == 3   # the warm-up searches are not requests
