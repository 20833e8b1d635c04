"""Shared Chrome/Perfetto ``trace_event`` writer (a copy of
``deepspeed_tpu/utils/trace_event.py`` for the PyTorch port; the serving
request tracer, ``serve/request_trace.py``, builds on it).

The byte-stable contract lives in :func:`serialize_trace`: sorted keys, no
whitespace, so the emitted bytes are a pure function of the event dicts'
key/value sets — construction order never matters. The helpers below build
exactly the dict shapes the JAX package's writers emit, so a bundle exported
by either package gives the same bytes.
"""

import json

__all__ = ["serialize_trace", "trace_envelope", "load_bundle",
           "process_name_event", "process_sort_index_event",
           "thread_meta_events", "complete_slice", "counter_event",
           "instant_event"]


def serialize_trace(trace):
    """Byte-stable serialization (sorted keys, no whitespace) — the golden-file
    contract of the timeline exporter tests."""
    return json.dumps(trace, sort_keys=True, separators=(",", ":"))


def trace_envelope(events, generator, **other_data):
    """The top-level trace_event JSON object: ``traceEvents`` plus an
    ``otherData`` block naming the generator (and any exporter-specific
    facts, e.g. stage count or the iteration timebase)."""
    other = {"generator": generator}
    other.update(other_data)
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": other}


def load_bundle(path, kind):
    """Read a dump JSON and return the bundle of ``kind`` — either the file
    itself (``data["kind"] == kind``) or a bundle embedded under the ``kind``
    key of a flight-recorder dump. None when neither form is present."""
    with open(path) as f:
        data = json.load(f)
    if data.get("kind") == kind:
        return data
    embedded = data.get(kind)
    if isinstance(embedded, dict) and embedded.get("kind") == kind:
        return embedded
    return None


def process_name_event(pid, name, tid=0):
    return {"ph": "M", "pid": pid, "tid": tid, "name": "process_name",
            "args": {"name": name}}


def process_sort_index_event(pid, sort_index, tid=0):
    """Pin a process track's vertical position in the Perfetto UI — the merged
    measured-vs-predicted profile timeline uses it to keep the predicted
    schedule above the measured one regardless of pid numbering."""
    return {"ph": "M", "pid": pid, "tid": tid, "name": "process_sort_index",
            "args": {"sort_index": sort_index}}


def thread_meta_events(pid, tid, name, sort_index=None):
    """The (thread_name, thread_sort_index) metadata pair for one track;
    the sort_index event is omitted when ``sort_index`` is None."""
    events = [{"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
               "args": {"name": name}}]
    if sort_index is not None:
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_sort_index",
                       "args": {"sort_index": sort_index}})
    return events


def complete_slice(pid, tid, ts, dur, name, cat, args, cname=None):
    """A complete ("X") slice; zero-length spans render as 1 us so they stay
    visible in the Perfetto UI. ``cname`` picks a reserved color name."""
    ev = {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": max(dur, 1),
          "cat": cat, "name": name, "args": args}
    if cname:
        ev["cname"] = cname
    return ev


def counter_event(pid, tid, ts, name, args):
    return {"ph": "C", "pid": pid, "tid": tid, "ts": ts, "name": name,
            "args": args}


def instant_event(pid, tid, ts, name, args):
    """A thread-scoped ("s": "t") instant marker."""
    return {"ph": "i", "pid": pid, "tid": tid, "ts": ts, "s": "t",
            "name": name, "args": args}
