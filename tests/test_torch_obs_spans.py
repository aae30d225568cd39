"""The port's tracer (repro_torch.obs.trace) as the serving and training
paths use it, on the CPU: the links between spans (id, parent, rid),
when it records (``enable_tracing()`` or a ``torch.profiler`` session),
that it records nothing and makes no CUDA event when it does not, the
epoch clock it shares with the profiler, device times read only when the
buffer is read, and the span trees of ``generate`` and ``train`` at smoke
size.

Every test that reads the process's buffer drains it first, so that
spans another test recorded (under a profiler of its own) do not leak in.
"""

import json
import multiprocessing
import os
import threading
import time

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as TF
from repro_torch.obs import (METRICS, disable_tracing, drain_events,
                             enable_tracing, instant, read_events, recording,
                             save_trace, span, span_counts)
from repro_torch.obs import trace as T
from repro_torch.serve import engine
from repro_torch.serve import serve_lm
from repro_torch.train import train_lm
from repro_torch.train.step import build_train_step, make_train_state


@pytest.fixture
def buffer():
    """An empty buffer, tracing off before and after the test."""
    disable_tracing()
    drain_events()
    yield
    disable_tracing()
    drain_events()


class FakeEvent:
    """Stands in for ``torch.cuda.Event``: ``record`` takes the next tick
    of a shared clock (1 ms a tick); every call is counted."""

    clock = 0
    made = 0
    elapsed_calls = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        FakeEvent.elapsed_calls += 1
        return float(other.t - self.t)


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA made to look initialised and idle, with counted fake events."""
    FakeEvent.clock = FakeEvent.made = FakeEvent.elapsed_calls = 0
    capturing = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    return capturing


def _by_name(events):
    return {e["name"]: e for e in events}


# ---------------------------------------------------------------------------
# links
# ---------------------------------------------------------------------------

def test_spans_link_to_their_parent_and_inherit_the_roots_rid(buffer):
    enable_tracing()
    with span("root", rid=7):
        with span("mid"):
            with span("leaf"):
                pass
            instant("mark")
    with span("other"):
        pass
    ev = _by_name(read_events())
    assert ev["root"]["parent"] is None and ev["root"]["rid"] == 7
    assert ev["mid"]["parent"] == ev["root"]["id"]
    assert ev["leaf"]["parent"] == ev["mid"]["id"]
    assert ev["mark"]["parent"] == ev["mid"]["id"]
    assert {ev[n]["rid"] for n in ("mid", "leaf", "mark")} == {7}
    assert ev["other"]["parent"] is None and ev["other"]["rid"] is None
    ids = [e["id"] for e in ev.values()]
    assert len(set(ids)) == len(ids)
    assert all(i.startswith(f"{os.getpid()}.") for i in ids)


def test_a_span_of_another_thread_has_no_parent_here(buffer):
    enable_tracing()
    with span("main", rid=1):
        t = threading.Thread(target=lambda: span("thread").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    ev = _by_name(read_events())
    assert ev["thread"]["parent"] is None and ev["thread"]["rid"] is None
    assert ev["thread"]["tid"] != ev["main"]["tid"]


def _record_in_child(_):
    from repro_torch.obs import drain_events, enable_tracing, span
    enable_tracing()
    with span("child"):
        pass
    return drain_events()


def test_ids_stay_unique_across_processes(buffer):
    enable_tracing()
    with span("parent"):
        pass
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        child = pool.map(_record_in_child, [0], chunksize=1)[0]
    mine = read_events()
    assert child[0]["pid"] != os.getpid()
    assert child[0]["id"] != mine[0]["id"]
    assert child[0]["id"].startswith(f"{child[0]['pid']}.")


# ---------------------------------------------------------------------------
# when it records
# ---------------------------------------------------------------------------

def test_recording_follows_enable_tracing(buffer):
    assert not recording()
    with span("off"):
        pass
    enable_tracing()
    assert recording()
    with span("on"):
        pass
    disable_tracing()
    assert not recording()
    with span("off_again"):
        pass
    assert span_counts(read_events()) == {"on": 1}


PROFILERS = {
    "profiler": lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]),
    "autograd_profiler": lambda: torch.autograd.profiler.profile(),
}


@pytest.mark.parametrize("profiler", sorted(PROFILERS))
def test_recording_follows_a_profiler_session(buffer, profiler):
    assert not recording()
    with PROFILERS[profiler]():
        assert recording()
        with span("profiled", rid=3):
            instant("profiled_mark")
    assert not recording()
    with span("after"):
        pass
    assert span_counts(read_events()) == {"profiled": 1,
                                           "profiled_mark": 1}


def test_nothing_recorded_and_no_event_made_when_off(buffer, fake_cuda):
    sp = span("dev", device=True)
    with sp:
        instant("dev_mark", device=True)
    assert sp.duration_s > 0
    assert FakeEvent.made == 0 and read_events() == []
    assert T._CURRENT.get() is None


def test_a_device_span_times_its_events_when_read(buffer, fake_cuda):
    enable_tracing()
    with span("root", device=True):            # events at ticks 1 and 5
        with span("step", device=True):        # ticks 2 and 3
            pass
        instant("first", device=True)          # tick 4
    assert FakeEvent.made == 5
    assert FakeEvent.elapsed_calls == 0        # nothing resolved yet
    ev = _by_name(read_events())
    assert ev["step"]["args"]["device_ms"] == 1.0
    assert ev["step"]["args"]["device_at_ms"] == 2.0
    assert ev["first"]["args"]["device_at_ms"] == 3.0
    assert ev["root"]["args"]["device_ms"] == 4.0
    assert ev["root"]["args"]["device_at_ms"] == 4.0
    assert ev["root"]["ts"] <= ev["root"]["args"]["device_entry_ts"] \
        <= ev["step"]["ts"]
    calls = FakeEvent.elapsed_calls
    assert read_events() == list(ev.values())  # shared, resolved once
    assert FakeEvent.elapsed_calls == calls
    json.dumps(read_events())


def test_no_device_event_while_the_stream_is_captured(buffer, fake_cuda):
    enable_tracing()
    fake_cuda["on"] = True
    with span("captured", device=True):
        instant("captured_mark", device=True)
    assert FakeEvent.made == 0
    ev = _by_name(read_events())
    assert "device_ms" not in ev["captured"].get("args", {})
    assert "device_at_ms" not in ev["captured_mark"].get("args", {})


# ---------------------------------------------------------------------------
# one clock with the profiler
# ---------------------------------------------------------------------------

def test_spans_are_on_the_epoch_clock(buffer):
    enable_tracing()
    before = time.time_ns() / 1e3
    with span("now"):
        pass
    after = time.time_ns() / 1e3
    (ev,) = read_events()
    assert before <= ev["ts"] <= ev["ts"] + ev["dur"] <= after


def test_a_span_encloses_a_record_function_on_the_profilers_clock(buffer):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            torch.ones(8).sum()
        with span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones(64).sum()
    (outer,) = read_events()
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"]
    assert len(inner) == 1
    s, e = inner[0].start_ns() / 1e3, (inner[0].start_ns()
                                      + inner[0].duration_ns()) / 1e3
    lo, hi = outer["ts"], outer["ts"] + outer["dur"]
    assert lo <= s and s - lo < 1000
    assert e <= hi and hi - e < 1000


# ---------------------------------------------------------------------------
# the serving and training paths at smoke size
# ---------------------------------------------------------------------------

def _counters():
    snap = METRICS.snapshot()["counters"]
    return [snap.get(f"engine.{k}", 0) for k in ("calls", "captures",
                                                 "replays")]


@pytest.fixture(scope="module")
def nemo():
    cfg = get_config("mistral_nemo_12b", reduced=True)
    params = TF.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    prompts = torch.randint(0, cfg.vocab_size, (2, 3),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    return cfg, params, prompts


def test_generate_records_its_span_tree(buffer, nemo):
    cfg, params, prompts = nemo
    before = _counters()
    enable_tracing()
    out = engine.generate(params, cfg, prompts, max_new=3)
    assert out.shape == (2, 6)
    events = read_events()
    # on the CPU every step is eager: 3 prompt steps and 2 new ones
    assert span_counts(events) == {
        "engine.collect": 1, "engine.first_token": 1, "engine.generate": 1,
        "engine.state_init": 1, "engine.step": 5}
    root = _by_name(events)["engine.generate"]
    assert root["parent"] is None
    assert root["args"] == {"batch": 2, "prompt": 3, "new": 3}
    assert {e["parent"] for e in events if e is not root} == {root["id"]}
    assert {e["rid"] for e in events} == {root["rid"]}
    after = _counters()
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0]


def test_generate_records_nothing_when_off(buffer, nemo):
    cfg, params, prompts = nemo
    before = _counters()
    out = engine.generate(params, cfg, prompts, max_new=2)
    assert out.shape == (2, 5) and read_events() == []
    assert _counters()[0] == before[0] + 1


def test_generate_calls_get_their_own_rids(buffer, nemo):
    cfg, params, prompts = nemo
    enable_tracing()
    engine.generate(params, cfg, prompts, max_new=1)
    engine.generate(params, cfg, prompts, max_new=1)
    roots = [e for e in read_events() if e["name"] == "engine.generate"]
    assert roots[1]["rid"] == roots[0]["rid"] + 1


class _Mon:
    def __init__(self):
        self.seen = []

    def record(self, times):
        self.seen.append(times[0])


def test_train_records_its_span_tree_and_times_steps_by_it(buffer):
    cfg = train_lm.preset("tiny")
    state = make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = build_train_step(cfg, lr=1e-3)
    gen = torch.Generator().manual_seed(2)

    def batches(i):
        toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen,
                             dtype=torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    mon = _Mon()
    enable_tracing()
    train_lm.train(step, state, batches, 4, 6, tokens_per_step=16,
                   mon=mon, log=lambda *_: None)
    events = read_events()
    assert span_counts(events) == {"train.feed": 2, "train.fwd_bwd": 2,
                                   "train.optimizer": 2, "train.step": 2}
    roots = [e for e in events if e["name"] == "train.step"]
    assert [r["rid"] for r in roots] == [4, 5]
    assert all(r["parent"] is None for r in roots)
    for e in events:
        if e["name"] != "train.step":
            (root,) = [r for r in roots if r["id"] == e["parent"]]
            assert e["rid"] == root["rid"]
            assert root["ts"] <= e["ts"] and \
                e["ts"] + e["dur"] <= root["ts"] + root["dur"]
    # the monitor got each step's span time
    assert len(mon.seen) == 2
    for dt, r in zip(mon.seen, roots):
        assert abs(dt - r["dur"] / 1e6) < 1e-3


def test_the_clis_write_their_spans(buffer, tmp_path, capsys):
    out = tmp_path / "serve.json"
    serve_lm.main(["--arch", "mistral_nemo_12b", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "2", "--new", "2",
                   "--trace", str(out)])
    events = json.loads(out.read_text())["traceEvents"]
    counts = span_counts(events)
    assert counts["engine.generate"] == 1 and counts["engine.step"] == 3
    # the counters ride along as counter tracks, at their values at save
    tracks = {e["name"]: e["args"]["value"] for e in events
              if e["ph"] == "C"}
    assert tracks == METRICS.snapshot()["counters"]
    assert {"engine.calls", "engine.captures", "engine.replays"} <= set(tracks)
    disable_tracing()
    drain_events()
    out = tmp_path / "train.json"
    train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                   "--seq", "8", "--ckpt", str(tmp_path / "ckpt"),
                   "--trace", str(out)])
    counts = span_counts(json.loads(out.read_text())["traceEvents"])
    assert counts == {"train.feed": 2, "train.fwd_bwd": 2,
                      "train.optimizer": 2, "train.step": 2}
    assert "trace: " in capsys.readouterr().out


def test_save_trace_keeps_the_buffer(buffer, tmp_path):
    enable_tracing()
    with span("kept"):
        pass
    save_trace(str(tmp_path / "t.json"))
    assert span_counts(read_events()) == {"kept": 1}
    assert span_counts(drain_events()) == {"kept": 1}
    assert read_events() == []


# ---------------------------------------------------------------------------
# on the card: device times of generate's spans, on the profiler's clock
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90); device spans time CUDA "
                    "events")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_generate_on_the_card_times_its_replays_on_the_profilers_clock(
        buffer, card):
    cfg = get_config("mistral_nemo_12b", reduced=True)
    params = TF.init_params(cfg, torch.Generator(card).manual_seed(0), card)
    prompts = torch.randint(0, cfg.vocab_size, (2, 4),
                            generator=torch.Generator(card).manual_seed(1),
                            dtype=torch.int32, device=card)
    engine.generate(params, cfg, prompts, max_new=3)   # build the kernels
    before = _counters()
    torch.cuda.synchronize(card)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        engine.generate(params, cfg, prompts, max_new=3)
        torch.cuda.synchronize(card)
    events = read_events()
    # 6 steps: the first captures, the other 5 replay
    assert span_counts(events) == {
        "engine.capture": 1, "engine.collect": 1, "engine.first_token": 1,
        "engine.generate": 1, "engine.state_init": 1, "engine.step": 5}
    assert [a - b for a, b in zip(_counters(), before)] == [1, 1, 5]
    ev = {e["name"]: e for e in events}
    root = ev["engine.generate"]["args"]
    ends = [e["args"]["device_at_ms"] for e in events
            if e["name"] == "engine.step"]
    assert all(e["args"]["device_ms"] > 0 for e in events
               if e["name"] == "engine.step")
    assert ends == sorted(ends) and ends[-1] <= root["device_ms"]
    # 3 prompt replays, then the first pick
    assert ends[2] <= ev["engine.first_token"]["args"]["device_at_ms"] \
        <= ends[3]
    # the call's kernels lie inside its device extent, placed on the
    # profiler's clock by its entry event's stamp (0.5 ms either side)
    dev = torch.autograd.DeviceType.CUDA
    kernels = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == dev]
    lo = root["device_entry_ts"]
    hi = lo + root["device_ms"] * 1e3
    assert kernels
    assert lo - 500 <= min(s for s, _ in kernels)
    assert max(e for _, e in kernels) <= hi + 500
