"""The readers of the program's spans and counters (``bench/spans.py`` and
the metrics that use it) on synthetic records: a traced ``generate`` call
and two train steps, their device events and spans on one epoch clock,
with an idle gap under the capture, one in the replay loop and one that
neither span covers; a root that overlaps no device event reads None."""

from __future__ import annotations

import pytest

from benchlib import ROOT

from bench import harness, spans

T0 = 1_760_000_000_000_000_000          # ns on the epoch clock
US = T0 / 1e3                           # the same, in µs
MS = 1_000_000                          # ns
# a float µs stamp near T0 holds 0.25 µs, its ns a float 256 ns
CLOCK = 1e-3                            # ms


def _ev(name, start_ms, dur_ms, id_, parent=None, rid=0, ph="X", **args):
    e = {"name": name, "ph": ph, "ts": US + start_ms * 1e3, "pid": 1,
         "tid": 1, "id": id_, "parent": parent, "rid": rid}
    if ph == "X":
        e["dur"] = dur_ms * 1e3
    if args:
        e["args"] = args
    return e


def _dev(start_ms, end_ms, name="kernel"):
    return (name, T0 + round(start_ms * MS), round((end_ms - start_ms) * MS))


def serve_events(root_start_ms=0.0):
    """A call entered at ``root_start_ms``: its entry event on the device
    5 µs later, its exit event 20 ms after that; four replays ending at
    8, 10, 12 and 15 ms of the device; the first token at 10 ms."""
    r = root_start_ms
    root = _ev("engine.generate", r, 10.0, "r", device_ms=20.0,
               device_at_ms=20.0, device_entry_ts=US + (r + 0.005) * 1e3,
               batch=64, prompt=3, new=2)
    out = [root,
           _ev("engine.state_init", r, 2.0, "s", "r"),
           _ev("engine.capture", r + 3.0, 3.0, "c", "r"),
           _ev("engine.first_token", r + 7.0, 0, "f", "r", ph="i",
               device_at_ms=10.0),
           _ev("engine.collect", r + 9.5, 0.5, "o", "r")]
    for k, end in enumerate((8.0, 10.0, 12.0, 15.0)):
        out.append(_ev("engine.step", r + 6.0 + k, 0.5, f"p{k}", "r",
                       device_ms=1.5, device_at_ms=end))
    return out


# device busy: the state's fills, the eager step, the replays (with a gap
# at 12.0-12.5 ms), the last pick and the concatenation
SERVE_DEVICE = [_dev(0.5, 1.5), _dev(2.5, 4.0), _dev(6.5, 12.0),
                _dev(12.5, 15.0), _dev(19.0, 20.0)]


def _rec(device, platform="gpu"):
    return {"platform": platform, "trace": {"device_events": device}}


@pytest.fixture
def program(monkeypatch):
    """Points the readers at the given events and counters."""
    state = {"events": [], "counters": {}}
    monkeypatch.setattr(spans, "events", lambda: state["events"])
    monkeypatch.setattr(spans, "counters", lambda: state["counters"])
    return state


def _read(name, rec):
    return harness.reader(ROOT, name).read(rec)


def test_the_serve_readers_read_the_traced_call(program):
    # a second call, later, overlaps none of the slice's device events
    program["events"] = serve_events() + [
        {**e, "id": "x" + e["id"],
         "parent": e["parent"] and "x" + e["parent"]}
        for e in serve_events(root_start_ms=100.0)]
    rec = _rec(SERVE_DEVICE)
    (tree,) = spans.traced(rec, "engine.generate")
    assert tree.root["id"] == "r" and len(tree.events) == 9
    assert _read("ttft_ms.serve", rec) == 10.0
    # replay ends 8, 10, 12, 15: intervals 2, 2, 3; p95 by nearest rank
    assert _read("step_p95_ms.serve", rec) == 3.0
    # idle 0-0.5 ms (under the state's set-up) and 4.0-6.5 (under the
    # capture); 1.5-2.5 lies under neither
    assert _read("idle_setup_ms.serve", rec) == pytest.approx(3.0,
                                                              abs=CLOCK)
    # 12.0-12.5 lies in the replay loop; 15.0-19.0 after the last step
    assert _read("idle_steps_ms.serve", rec) == pytest.approx(0.5,
                                                              abs=CLOCK)


def test_a_root_that_overlaps_nothing_reads_none(program):
    program["events"] = serve_events(root_start_ms=100.0)
    rec = _rec(SERVE_DEVICE)
    assert spans.traced(rec, "engine.generate") == []
    for name in ("ttft_ms.serve", "step_p95_ms.serve",
                 "idle_setup_ms.serve", "idle_steps_ms.serve"):
        assert _read(name, rec) is None


@pytest.mark.parametrize("case", ["cpu", "no_trace", "no_events",
                                  "no_program_read"])
def test_nothing_to_read_reads_none(program, case):
    program["events"] = serve_events()
    rec = _rec(SERVE_DEVICE)
    if case == "cpu":
        rec["platform"] = "cpu"
    elif case == "no_trace":
        rec["trace"] = None
    elif case == "no_events":
        rec["trace"]["device_events"] = []
    else:
        program["events"] = None
    for name in ("ttft_ms.serve", "step_p95_ms.serve",
                 "idle_setup_ms.serve", "idle_steps_ms.serve",
                 "fwd_bwd_ms.train", "optimizer_ms.train"):
        assert _read(name, rec) is None


def test_an_untimed_root_reads_none_where_device_times_are_needed(program):
    evs = serve_events()
    evs[0] = {k: v for k, v in evs[0].items() if k != "args"}
    program["events"] = evs
    rec = _rec(SERVE_DEVICE)
    assert _read("idle_setup_ms.serve", rec) is None
    assert _read("idle_steps_ms.serve", rec) is None
    assert _read("ttft_ms.serve", rec) == 10.0


def test_captures_per_call_reads_the_counters(program):
    rec = _rec(SERVE_DEVICE)
    program["counters"] = {"engine.calls": 12, "engine.captures": 12,
                           "engine.replays": 2400}
    assert _read("captures_per_call.serve", rec) == 1.0
    program["counters"] = {}
    assert _read("captures_per_call.serve", rec) is None
    program["counters"] = {"engine.calls": 2, "engine.captures": 2}
    assert _read("captures_per_call.serve", _rec([], "cpu")) is None


def _train_events(k, start_ms, fwd_ms, opt_ms):
    i = f"t{k}"
    return [_ev("train.step", start_ms, 100.0, i, rid=k),
            _ev("train.feed", start_ms, 1.0, i + "f", i, rid=k),
            _ev("train.fwd_bwd", start_ms + 1.0, 80.0, i + "b", i, rid=k,
                device_ms=fwd_ms),
            _ev("train.optimizer", start_ms + 81.0, 18.0, i + "o", i,
                rid=k, device_ms=opt_ms)]


def test_the_train_readers_average_the_traced_steps(program):
    # steps 0 and 1 traced on the device; step 2, later, overlaps nothing
    program["events"] = (_train_events(0, 0.0, 70.0, 20.0)
                         + _train_events(1, 100.0, 74.0, 30.0)
                         + _train_events(2, 500.0, 999.0, 999.0))
    rec = _rec([_dev(1.0, 99.0), _dev(101.0, 199.0)])
    assert [t.root["rid"] for t in spans.traced(rec, "train.step")] == [0, 1]
    assert _read("fwd_bwd_ms.train", rec) == 72.0
    assert _read("optimizer_ms.train", rec) == 25.0


def test_a_step_without_a_timed_span_reads_none(program):
    evs = _train_events(0, 0.0, 70.0, 20.0)
    del evs[3]["args"]
    program["events"] = evs
    rec = _rec([_dev(1.0, 99.0)])
    assert _read("fwd_bwd_ms.train", rec) == 70.0
    assert _read("optimizer_ms.train", rec) is None


def test_idle_is_the_complement_of_the_busy_time():
    rec = _rec([_dev(1.0, 2.0), _dev(1.5, 3.0), _dev(5.0, 6.0)])
    gaps = spans.idle(rec, T0, T0 + 8 * MS)
    assert [((a - T0) / MS, (b - T0) / MS) for a, b in gaps] == \
        [(0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    assert spans.idle(rec, T0 + 1.2 * MS, T0 + 2.5 * MS) == []
