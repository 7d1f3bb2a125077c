"""The port's span recorder (``soap_tpu_torch/utils/trace.py``) on the
CPU: off it is one shared no-op; on, one ``build_catalogue`` pass gives
the tree of the entry, chunk loop and engine spans (a mock universe of
10 halos, seed 21, and the four groups of ``test_torch_chunks.py``) and
the same catalogue; a span from the caller's own stamps nests like any
other; a span lies inside the torch.profiler range around it on the
profiler's clock, and is a range of its own only where asked; the
read-ahead thread's spans carry their own thread."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from soap_tpu_torch.pipeline import chunks, run
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils import trace
from soap_tpu_torch.utils.mock_data import build_mock_universe

GROUPS = ("BoundSubhalo", "SO/200_crit", "ExclusiveSphere/50kpc",
          "ProjectedAperture/50kpc/projz")


@pytest.fixture(scope="module")
def inputs():
    uni = build_mock_universe(n_halos=10, n_field=6000, boxsize=24.0, seed=21)
    meta = run.mock_metadata(uni)
    wanted = [s for s in build_specs(None, True, 100.0) if s.group in GROUPS]
    ptypes, specs = run.entry_plan(meta, True, None, wanted)
    host = chunks.mock_fields(uni, specs, meta, ptypes, run.age_table(meta))
    return meta, run.mock_catalogue(uni), host, specs


def _entry(inputs, **kw):
    meta, cat, host, specs = inputs
    return run.build_catalogue(meta, cat, host, specs, device="cpu", **kw)


@pytest.fixture(scope="module")
def recorded(inputs):
    plain = _entry(inputs)
    with trace.recording() as rec:
        out = _entry(inputs)
    return plain, out, rec.records()


def test_off_is_one_shared_no_op():
    assert trace.span("engine.bucket", halos=3) is trace.NO_SPAN
    with trace.span("engine.bucket") as s:
        pass
    assert s is trace.NO_SPAN
    t0 = time.perf_counter()
    started = trace.start("entry.prep", t0)
    assert started is trace.NO_SPAN
    started.stop(t0)
    with trace.recording() as rec:
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    assert rec.spans == []
    assert trace.span("x") is trace.NO_SPAN


def test_one_pass_gives_the_tree(recorded):
    _, out, spans = recorded
    by_index = {s["index"]: s for s in spans}

    def ancestors(s):
        while s["parent"] is not None:
            s = by_index[s["parent"]]
            yield s["name"]

    buckets = [s for s in spans if s["name"] == "engine.bucket"]
    assert len(buckets) == out.stats.n_bucket_calls > 0
    for b in buckets:
        children = {s["name"] for s in spans if s["parent"] == b["index"]}
        assert {"engine.issue", "engine.to_host", "engine.resolve"} <= children
        assert "engine.process" in ancestors(b)
        assert b["start"] < b["end"] and b["attrs"]["halos"] > 0
    plans = [s for s in spans if s["name"] == "engine.plan"]
    assert plans and all("engine.process" in ancestors(p) for p in plans)
    issue = {s["index"] for s in spans if s["name"] == "engine.issue"}
    families = [s for s in spans if s["name"] == "dag.family"]
    assert families and all(s["parent"] in issue for s in families)
    assert {f["attrs"]["group"] for f in families} >= {"BoundSubhalo", "SO/200_crit"}
    (prep,) = [s for s in spans if s["name"] == "entry.prep"]
    assert abs((prep["end"] - prep["start"]) * 1e-9 - out.prep_seconds) < 1e-3
    (post,) = [s for s in spans if s["name"] == "entry.post"]
    assert abs((post["end"] - post["start"]) * 1e-9 - out.post_seconds) < 1e-3


def test_catalogue_equal_with_recording_on_and_off(recorded):
    plain, out, _ = recorded
    assert list(plain.catalogue.datasets) == list(out.catalogue.datasets)
    for path, ds in plain.catalogue.datasets.items():
        assert ds.data.tobytes() == out.catalogue.datasets[path].data.tobytes(), path


def test_span_from_stamps_nests_like_any_other():
    with trace.recording() as rec:
        t0 = time.perf_counter()
        with trace.span("inner"):
            torch.ones(64).cumsum(0)
        t1 = time.perf_counter()
        # recorded after its child, from the caller's stamps
        trace.start("outer", t0, chunk=3).stop(t1)
    inner, outer = rec.records()
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == outer["index"] and outer["parent"] is None
    assert outer["attrs"] == {"chunk": 3}
    assert abs((outer["end"] - outer["start"]) * 1e-9 - (t1 - t0)) < 1e-6
    assert outer["start"] <= inner["start"] <= inner["end"] <= outer["end"]


@pytest.mark.parametrize("ranges", [False, True])
def test_spans_are_profiler_ranges_only_where_asked(ranges):
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording(ranges) as rec:
        with trace.span("outer"):
            trace.start("inner").stop()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"outer", "inner"} <= names if ranges else not {"outer", "inner"} & names
    assert [s["name"] for s in rec.records()] == ["outer", "inner"]


def test_span_inside_the_profiler_range_on_its_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording(True) as rec:
        with record_function("m"):
            with trace.span("inner"):
                torch.ones(64).cumsum(0)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    m = events["m"]
    (inner,) = [s for s in rec.records() if s["name"] == "inner"]
    tol = 100_000  # 0.1 ms
    assert m.start_ns() - tol <= inner["start"] <= inner["end"] <= (
        m.start_ns() + m.duration_ns() + tol)
    # the span is a range of the profiler's own too
    assert "inner" in events


def test_reader_thread_spans_carry_their_thread(inputs):
    with trace.recording() as rec:
        out = _entry(inputs, nr_chunks=2, prefetch=True)
    spans = rec.records()
    main = threading.get_native_id()
    reads = [s for s in spans if s["name"] == "chunks.read"]
    assert len(reads) == 2
    assert {s["thread"] for s in reads} == {main, reads[1]["thread"]} != {main}
    # the read-ahead thread's spans have no parent on the main thread
    assert reads[1]["parent"] is None
    stages = [s for s in spans if s["name"] == "chunks.stage"]
    assert [s["attrs"]["side"] for s in stages] == [False, True]
    assert stages[1]["thread"] == reads[1]["thread"]
    assert len([s for s in spans if s["name"] == "chunks.wait"]) == 2
    assert len(out.chunks) == 2 and all(c.store_bytes > 0 for c in out.chunks)
