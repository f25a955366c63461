"""The port's spans as the traced run reads them: kept among the calling
thread's host operations and out of every card's device work, naming the
idle gaps they cover, read as a union over the window, and reported by a
traced run of each cell that lists a metric read from them."""
import contextlib
import json

import pytest

from portbench import harness, spans
from portbench.tests.cells import BENCHMARK_CELLS
from portbench.tracing import CALL, Context, Trace

SPAN_READERS = {"overflow_pct", "retry_ms", "refetch_pct", "fetch_wait_ms",
                "finalize_ms", "pin_ms"}


class _Event:
    def __init__(self, name, start, end, device="cpu", thread=1,
                 annotation=False, card=0):
        self._n, self._s, self._e = name, start, end
        self._d, self._t, self._a, self._c = device, thread, annotation, card

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return f"DeviceType.{self._d.upper()}"

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return self._t

    def device_index(self):
        return self._c


def _trace(events) -> Trace:
    class Results:
        def events(self):
            return events

    class Profiler:
        kineto_results = Results()

    class Prof:
        profiler = Profiler()
    return Trace(Prof())


def _ctx(tr, calls=1, images=4) -> Context:
    return Context(tr, [0], {}, {}, calls, images, 0, {})


def test_spans_stay_out_of_device_work():
    """A span is a host operation of its thread; a card-side copy of a
    range (a user annotation on a card's timeline) is no device work."""
    tr = _trace([
        _Event(CALL, 0, 1000, annotation=True),
        _Event("jpgenc.retry", 100, 600),
        _Event("jpgenc.retry", 120, 580, device="cuda", annotation=True),
        _Event("k1a_kernel", 150, 300, device="cuda"),
    ])
    assert [n for c in tr.device for _, _, n in tr.device[c]] == \
        ["k1a_kernel"]
    assert ("jpgenc.retry" in [n for _, _, n in tr.host])
    assert tr.busy_s(0) == pytest.approx(150e-9)


def test_an_idle_gap_inside_a_span_takes_its_name():
    """The innermost host operation covering a gap's middle names it; where
    only a span covers it, the span; where nothing does, `python`."""
    tr = _trace([
        _Event(CALL, 0, 1000, annotation=True),
        _Event("k1a_kernel", 0, 100, device="cuda"),
        _Event("jpgenc.finalize_host", 100, 500),
        _Event("aten::cat", 110, 200),
        _Event("k1a_kernel", 200, 220, device="cuda"),
        _Event("k1a_kernel", 500, 900, device="cuda"),
    ])
    gaps = dict(tr.idle_gaps([0]))
    assert gaps["aten::cat"] == pytest.approx(100e-9)
    assert gaps["jpgenc.finalize_host"] == pytest.approx(280e-9)
    assert gaps["python"] == pytest.approx(100e-9)


def test_span_seconds_is_the_union_in_the_window():
    """Nested and overlapping spans of the read names count once; spans of
    other threads and time outside the window do not count."""
    tr = _trace([
        _Event(CALL, 100, 1100, annotation=True),
        _Event("jpgenc.fetch_wait", 50, 200),          # clipped to 100..200
        _Event("jpgenc.fetch_wait", 300, 500),
        _Event("jpgenc.refetch_wait", 400, 600),       # overlaps: 300..600
        _Event("jpgenc.fetch_wait", 350, 450),         # nested
        _Event("jpgenc.fetch_wait", 700, 800, thread=2),
        _Event("jpgenc.finalize_host", 1000, 1300),    # clipped: 1000..1100
    ])
    ctx = _ctx(tr, calls=2)
    wait = ("jpgenc.fetch_wait", "jpgenc.refetch_wait")
    assert spans.seconds(ctx, *wait) == pytest.approx(400e-9)
    assert spans.count(ctx, "jpgenc.fetch_wait") == 3
    assert spans.ms_per_call(ctx, *wait) == pytest.approx(200e-6)
    assert spans.ms_per_call(ctx, "jpgenc.finalize_host") == \
        pytest.approx(50e-6)
    assert spans.ms_per_call(ctx, "jpgenc.retry") == 0.0


def test_without_spans_every_reader_is_silent():
    """A program that marks nothing (as before the spans) leaves each
    metric out of the line: every reader returns None."""
    tr = _trace([_Event(CALL, 0, 1000, annotation=True),
                 _Event("aten::cat", 10, 20),
                 _Event("k1a_kernel", 0, 100, device="cuda")])
    reg = harness.Registry()
    for name in sorted(SPAN_READERS):
        assert reg.reader(name)(_ctx(tr)) is None, name


@pytest.mark.parametrize("cell", BENCHMARK_CELLS)
def test_a_traced_run_reports_the_span_metrics(cell, small_cell, run_small):
    c = small_cell(cell)
    listed = {m["name"] for m in c.per_layer
              if m["name"].split(".", 1)[0] in SPAN_READERS}
    assert listed
    r = run_small(c, trace=True)
    assert r["correct"]
    assert listed <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] >= 0 for m in listed)
    json.dumps(r)


def test_a_traced_run_without_spans_leaves_them_out(small_cell, run_small,
                                                    monkeypatch):
    """The same run with the port's spans switched off, as a program
    without them: the span metrics are left out, the others stay."""
    import torch._C._profiler
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: contextlib.nullcontext())
    c = small_cell(BENCHMARK_CELLS[0])
    r = run_small(c, trace=True)
    assert r["correct"]
    assert not {m for m in r["metrics"]
                if m.split(".", 1)[0] in SPAN_READERS}
    assert "d2h_bytes_per_image" in r["metrics"]
