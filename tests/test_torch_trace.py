"""The program's tracer (``pql_tpu_torch/utils/trace.py``) on the CPU: spans,
their parents and self times, the no-op when off, the spans of a PQL and a
DDPGV iteration under the benchmark adapters' names, the graph counters,
the device clock through stand-in events, the benchmark's reduction of a
profile holding the program's ``pql:`` ranges, the operator's log and the
readers of ``tools/trace_report.py``; one test on the card (marker ``gpu``).

This file imports nothing of JAX. On the machine with the card:

    python -m pytest tests/test_torch_trace.py -m gpu --noconftest -q
"""

import importlib.util
import itertools
import os
import statistics
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pql_tpu_torch.algos import base
from pql_tpu_torch.algos.ddpgv import DDPGV
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs import rigid
from pql_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
PQL_TOP = ("env.sim", "replay.nstep", "replay.add", "learner.critic", "learner.actor")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
report = _load(os.path.join(ROOT, "tools", "trace_report.py"), "trace_report")


@pytest.fixture(autouse=True)
def _fresh_tracer():
    trace.reset()
    trace.enable(True)
    yield
    trace.enable(True)
    trace.reset()


def _top(record):
    return [s.name for s in record.spans if s.parent < 0]


def _iterations(records):
    return [r for r in records if r.iteration >= 0]


# ------------------------------------------------------------------ spans


def test_nested_spans_record_parents_and_self_time(monkeypatch):
    clock = itertools.count(0, 1_000_000)  # every read 1 ms later
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(clock))
    trace.iteration()
    with trace.span("env.sim"):  # 0 .. 7
        with trace.span("env.actor"):  # 1 .. 4
            with trace.span("env.graph_in"):  # 2 .. 3
                pass
        with trace.span("env.track"):  # 5 .. 6
            pass
    rec = trace.recent()[-1]
    assert [(s.name, s.parent) for s in rec.spans] == [("env.sim", -1), ("env.actor", 0), ("env.graph_in", 1),
                                                       ("env.track", 0)]
    assert rec.host_ms() == {"env.sim": 7 - 3 - 1, "env.actor": 3 - 1, "env.graph_in": 1, "env.track": 1}
    assert rec.iteration == 0 and not rec.profiled and rec.device_ms() is None


def test_disabled_span_is_the_shared_noop_and_records_nothing():
    trace.enable(False)
    trace.iteration()
    first, second = trace.span("env.sim"), trace.span("learner.actor")
    assert first is second
    with first as s:
        trace.count("env.graph_replays")
    assert s.seconds is None
    assert [r.iteration for r in trace.recent()] == [-1] and not trace.recent()[0].spans
    trace.enable(True)
    with trace.span("env.sim") as s:
        pass
    assert s is not first and s.seconds >= 0


def test_spans_keep_their_iteration_and_the_ring_keeps_the_last():
    with trace.span("setup.graph_warmup"):
        pass
    for _ in range(trace.RING + 3):
        trace.iteration()
        with trace.span("env.sim"):
            trace.count("env.graph_replays", 2)
    records = trace.recent()
    assert len(records) == trace.RING
    assert [r.iteration for r in records] == list(range(3, trace.RING + 3))
    assert all(r.counters == {"env.graph_replays": 2} and _top(r) == ["env.sim"] for r in records)
    assert [r.closed for r in records] == [True] * (trace.RING - 1) + [False]


# --------------------------------------------------------- the agents' spans


def _install_spans_names(module_file: str, agent, state) -> tuple:
    adapter = _load(os.path.join(BENCH, "reference", module_file), "trace_test_" + module_file.replace("-", "_"))
    names, undo = adapter.install_spans(agent, state, record_function)
    undo()
    return names


def test_pql_iteration_spans_in_order_with_the_adapter_names():
    cfg = make_config("pql", task="Cartpole", num_envs=8, algo__batch_size=32, algo__memory_size=4096,
                      algo__warm_up=4, algo__critic_sample_ratio=2, algo__critic_actor_ratio=2)
    agent = PQL(cfg, device="cpu")
    state = agent.init(0)
    state, _ = agent.warmup(state)
    for _ in range(2):
        state, _ = agent.train_iter(state)
    records = trace.recent()
    assert records[0].iteration == -1 and _top(records[0])[:3] == ["env.sim", "replay.nstep", "replay.add"]
    iters = _iterations(records)
    assert len(iters) == 2
    for rec in iters:
        assert tuple(_top(rec)) == PQL_TOP
        sim = _top(rec).index("env.sim")
        nested = [s.name for s in rec.spans if s.parent == sim]
        assert nested == ["env.actor", "env.track", "env.track"]  # horizon 1: the step's accounting, the trackers
        assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)
    assert set(PQL_TOP) == set(_install_spans_names("pql_plain.py", agent, state))


def test_ddpgv_iteration_spans_in_order_with_the_adapter_names():
    cfg = make_config("ddpgv", task="ReacherVision", num_envs=8, algo__batch_size=16, algo__memory_size=512,
                      algo__horizon_len=1, algo__update_times=2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        agent = DDPGV(cfg, device="cpu")
        state = agent.init(0)
        state, _ = agent.warmup(state)
        state, _ = agent.train_iter(state)
    finally:
        torch.set_num_threads(threads)
    (rec,) = _iterations(trace.recent())
    top = ["env.collect", "replay.ring_write"] + ["replay.fetch_batch", "learner.update"] * 2
    assert _top(rec) == top
    children = {}
    for s in rec.spans:
        if s.parent >= 0:
            children.setdefault(rec.spans[s.parent].name, []).append(s.name)
    assert children == {"env.collect": ["env.render", "env.render"], "replay.ring_write": ["replay.to_host",
                                                                                           "replay.ring_add"],
                        "replay.fetch_batch": ["replay.gather", "replay.gather"]}
    assert set(top) == set(_install_spans_names("ddpgv-reachervision.py", agent, state))
    assert report.hostring_host_ms([rec]) == pytest.approx(rec.host_ms()["replay.ring_add"]
                                                           + rec.host_ms()["replay.gather"])


# -------------------------------------------------------- the graph counters


class _StubGraph:
    """A CUDA graph's stand-in: the capture runs the function once, eagerly."""

    def __init__(self, keep_graph=False):
        self.replays = 0

    def instantiate(self):
        pass

    def replay(self):
        self.replays += 1


def test_graphed_step_counts_captures_replays_and_kernel_nodes(monkeypatch):
    class _Ctx:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class _Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "device", _Ctx)
    monkeypatch.setattr(torch.cuda, "stream", _Ctx)
    monkeypatch.setattr(torch.cuda, "graph", _Ctx)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(rigid, "graph_kernel_nodes", lambda graph: (1234, 1300))

    def fn(state, action):
        return {"x": state["x"] + action}, action.sum(-1), action[:, 0] > 0, {"y": action * 2}

    step = rigid.GraphedStep(fn, {"x": torch.zeros(4, 2)}, torch.ones(4, 2))
    assert step.kernels == 1234
    assert set(step.build_s) == {"warmup", "capture", "instantiate"} and all(v >= 0 for v in step.build_s.values())
    setup = trace.recent()[-1]
    assert setup.counters == {"env.graph_captures": 1}
    assert [s.name for s in setup.spans] == ["setup.graph_warmup", "setup.graph_capture", "setup.graph_instantiate"]
    for _ in range(2):
        trace.iteration()
        with trace.span("env.sim"):
            out = step({"x": torch.ones(4, 2)}, torch.ones(4, 2))
    assert step.graph.replays == 2
    assert torch.equal(out[0]["x"], step.out[0]["x"]) and out[0]["x"] is not step.out[0]["x"]  # clones
    iters = _iterations(trace.recent())
    assert [r.counters for r in iters] == [{"env.graph_replays": 1, "env.graph_kernels": 1234}] * 2
    assert [s.name for s in iters[0].spans] == ["env.sim", "env.graph_in", "env.graph_replay", "env.graph_out"]
    assert report.counter_per_iter(iters, "env.graph_kernels") == 1234
    trace.enable(False)
    assert rigid.GraphedStep(fn, {"x": torch.zeros(4, 2)}, torch.ones(4, 2)).build_s == dict(
        warmup=None, capture=None, instantiate=None)


def test_learner_graphs_count_captures_replays_and_kernel_nodes(monkeypatch):
    """PQL's phases through stand-in graphs on the CPU (each replay runs the
    phase): the host-only ``setup.learner_capture`` span in each phase's
    second call, the learner's graph counters, a replay's nested spans as
    ``PQL_SHAPE`` has them, and the report's reader of the kernel nodes
    replayed an iteration."""

    class _Graph:
        def __init__(self, fn):
            self.fn, self.out = fn, torch.zeros(())

        def replay(self):
            self.out.copy_(self.fn())

    def capture(fn, device):
        graph = _Graph(fn)
        return graph, graph.out, 321

    monkeypatch.setattr(base, "capture_graph", capture)
    cfg = make_config("pql", task="Cartpole", num_envs=8, algo__batch_size=32, algo__memory_size=4096,
                      algo__warm_up=4, algo__critic_sample_ratio=2, algo__critic_actor_ratio=2)
    agent = PQL(cfg, device="cpu")
    agent.capture_phases = True
    state, _ = agent.warmup(agent.init(0))
    for _ in range(3):
        state, _ = agent.train_iter(state)
    iters = _iterations(trace.recent())

    def nested(rec):
        out = {}
        for s in rec.spans:
            if s.parent >= 0 and rec.spans[s.parent].name.startswith("learner."):
                out.setdefault(rec.spans[s.parent].name, []).append(s.name)
        return out

    shape = {name: list(inner) for name, inner in report.PQL_SHAPE if name.startswith("learner.")}
    assert [nested(r) for r in iters] == [{}, {k: ["setup.learner_capture", *v] for k, v in shape.items()}, shape]
    replayed = {"learner.graph_replays": 2, "learner.graph_kernels": 2 * 321}
    assert [r.counters for r in iters] == [{}, {"learner.graph_captures": 2, **replayed}, replayed]
    assert report.counter_per_iter(iters[1:], "learner.graph_kernels") == 2 * 321


class _FakeEvent:
    """A timing event on a stand-in device clock: ``record`` stamps the
    clock's time; it completes once the clock's ``done`` reaches it."""

    clock = {"now": 0.0, "done": float("inf"), "made": 0}

    def __init__(self, enable_timing=False):
        self.t = None
        _FakeEvent.clock["made"] += 1

    def record(self, stream=None):
        self.t = _FakeEvent.clock["now"]

    def query(self):
        return self.t <= _FakeEvent.clock["done"]

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before it completed"
        return end.t - self.t


@pytest.fixture
def fake_device(monkeypatch):
    _FakeEvent.clock.update(now=0.0, done=float("inf"), made=0)
    capturing = {"on": False}
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: _FakeEvent.clock.update(done=float("inf")))
    return _FakeEvent.clock, capturing


def _device_iteration(clock, marks):
    """One iteration on the stand-in clock: ``marks`` the device times of
    (iteration start, then each top-level span's entry and exit)."""
    it = iter(marks)
    clock["now"] = next(it)
    trace.iteration("cuda")
    for name in ("env.sim", "replay.add", "learner.critic"):
        clock["now"] = next(it)
        with trace.span(name):
            with trace.span(name + ".inner"):
                pass
            clock["now"] = next(it)


def test_events_are_read_only_once_complete_and_tile_the_period(fake_device):
    clock, _ = fake_device
    clock["done"] = -1.0  # nothing has completed
    _device_iteration(clock, (0, 1, 11, 12, 14, 20, 25))
    _device_iteration(clock, (30, 31, 41, 42, 44, 50, 55))
    clock["now"] = 60.0
    trace.iteration("cuda")
    first, second = _iterations(trace.recent())[:2]
    assert first.closed and first.period_ms is None and first.device_ms() is None  # not read: incomplete
    clock["done"] = 35.0  # the first iteration's events, and the second's start
    trace.iteration("cuda")  # the hot path reads nothing
    assert first.period_ms is None
    trace.recent()
    assert first.period_ms == 30 and second.period_ms is None
    assert first.device_ms() == {"env": 10, "replay": 2, "learner": 5, "iteration": 13}
    assert [s.dev for s in first.spans if s.parent < 0] == [(1, 11), (12, 14), (20, 25)]
    assert all(s.dev is None for s in first.spans if s.parent >= 0)  # nested spans: host time only
    assert report.tiles(first)
    made = clock["made"]
    trace.recent(sync=True)
    assert second.period_ms == 30 and report.tiles(second)
    clock["now"] = 70.0
    trace.iteration("cuda")  # pooled events: no new one
    assert clock["made"] == made


def test_records_that_leave_the_ring_unread_return_their_events(fake_device):
    clock, _ = fake_device
    for i in range(5 * trace.RING):
        clock["now"] = float(i)
        trace.iteration("cuda")
        with trace.span("env.sim"):
            pass
    assert clock["made"] <= 3 * (trace.RING + 3)  # an iteration's three events, reused
    rows = [r for r in _iterations(trace.recent()) if r.period_ms is not None]
    assert len(rows) == trace.RING - 1 and all(r.period_ms == 1 for r in rows)


def test_no_event_is_recorded_while_the_stream_captures(fake_device):
    clock, capturing = fake_device
    trace.iteration("cuda")
    with trace.span("setup.graph_capture"):  # host time only, always
        pass
    capturing["on"] = True
    made = clock["made"]
    with trace.span("env.sim"):
        pass
    assert clock["made"] == made
    rec = trace.recent()[-1]
    assert not rec.clock and all(s.enter_ev is None and s.exit_ev is None for s in rec.spans)
    capturing["on"] = False
    trace.iteration("cuda")
    trace.iteration("cuda")
    assert rec.period_ms is None and rec.device_ms() is None  # a record that lost its clock stays unread
    assert _iterations(trace.recent(sync=True))[1].period_ms == 0


def test_spans_before_the_first_iteration_record_host_time_only(fake_device):
    clock, _ = fake_device
    with trace.span("env.sim"):
        pass
    assert clock["made"] == 0 and trace.recent()[0].iteration == -1
    trace.iteration("cpu")
    with trace.span("env.sim"):
        pass
    assert clock["made"] == 0 and trace.recent()[-1].device_ms() is None


# ------------------------------------------- the profile and the benchmark


def _window(program_spans: bool):
    trace.enable(program_spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            for _ in range(2):
                trace.iteration()
                for layer in ("env.sim", "replay.add", "learner.critic"):
                    with trace.span(layer), record_function(layer):
                        with trace.span(layer + ".inner"):
                            torch.ones(8).sum()
    trace.enable(True)
    return prof


def test_benchmark_reduction_is_the_same_with_the_program_spans():
    import tracing

    ranges = ("env.sim", "replay.add", "learner.critic")
    with_spans, without = tracing.summarize(_window(True), 2, ranges), tracing.summarize(_window(False), 2, ranges)
    for field in ("host_s_by_range", "launches_by_layer", "device_s_by_layer"):
        assert sorted(getattr(with_spans, field)) == sorted(getattr(without, field))
    assert sorted(with_spans.host_s_by_range) == sorted(ranges)
    profiled = _iterations(trace.recent())
    assert profiled and all(r.profiled for r in profiled)
    names = {e.name() for e in _window(True).profiler.kineto_results.events() if e.is_user_annotation()}
    assert {"pql:env.sim", "pql:replay.add.inner"} <= names
    assert all(tracing.layer_of(n) not in tracing.LAYERS for n in names if n.startswith(trace.PREFIX))


# ----------------------------------------------------------------- readers


def _record(iteration, spans, period=None, counters=None, profiled=False):
    """A closed record from (name, parent, host ms, device (enter, exit) or None)."""
    rec = trace.Record(iteration, profiled)
    at = 0
    for name, parent, host, dev in spans:
        s = trace.SpanRecord(name, parent)
        s.start_ns, s.end_ns, s.dev = at + 1, at + 1 + int(host * 1e6), dev
        at = s.end_ns if parent < 0 else at
        rec.spans.append(s)
    rec.period_ms, rec.closed, rec.counters = period, True, dict(counters or {})
    return rec


def _pql_record(iteration, profiled=False, period=150.0, clock=True):
    dev = (lambda a, b: (a, b)) if clock else (lambda a, b: None)
    return _record(iteration, [("env.sim", -1, 40, dev(1, 121)), ("env.graph_replay", 0, 5, None),
                               ("replay.nstep", -1, 1, dev(121, 122)), ("replay.add", -1, 1, dev(122, 124)),
                               ("learner.critic", -1, 10, dev(124, 140)), ("learner.actor", -1, 5, dev(140, 148))],
                   period if clock else None, {"env.graph_kernels": 99_000}, profiled)


def test_readers_take_the_four_iterations_before_the_last_unprofiled_one():
    import tracing

    records = [_record(-1, [])] + [_pql_record(i, period=150.0 + i) for i in range(7)]
    records += [_pql_record(7 + i, profiled=True, period=400.0) for i in range(3)]
    rows = report.window(records)
    assert [r.iteration for r in rows] == [2, 3, 4, 5]
    s = tracing.Summary(iters=3, device_s_by_layer={"env": 0.3, "learner": 0.066, "iteration": 0.003})
    idle = report.idle_ms(rows, s)
    assert idle["env"] == pytest.approx(120 - 100) and idle["learner"] == pytest.approx(24 - 22)
    assert idle["replay"] == pytest.approx(3 - 0)  # no device record: busy 0
    assert idle["iteration"] == pytest.approx(statistics.median([152, 153, 154, 155]) - 147 - 1)
    assert report.period_ms(rows) == pytest.approx(153.5)
    assert report.counter_per_iter(rows, "env.graph_kernels") == 99_000
    assert report.hostring_host_ms(rows) is None  # PQL has no host ring
    held = report.closure(idle, 153.5, 100 * sum(idle.values()) / 150.0, 150.0)
    assert held["idle_held"] and held["period_held"]
    assert not report.closure(idle, 170.0, 5.0, 150.0)["idle_held"]


def test_readers_return_none_without_a_device_clock():
    import tracing

    rows = [_pql_record(i, clock=False) for i in range(4)]
    s = tracing.Summary(iters=3, device_s_by_layer={"env": 0.3})
    assert report.idle_ms(rows, s) is None and report.period_ms(rows) is None
    assert report.idle_ms([], s) is None and report.counter_per_iter([], "env.graph_kernels") is None


def test_operator_log_takes_closed_unprofiled_iterations():
    records = [_record(-1, [("env.sim", -1, 3, None)]), _pql_record(0, period=150.0), _pql_record(1, period=160.0),
               _pql_record(2, profiled=True, period=400.0)]
    records[-1].closed = False
    log = trace.log_values(records)
    assert log["trace/period_ms"] == 155.0 and log["trace/env.device_ms"] == 120.0
    assert log["trace/iteration.device_ms"] == pytest.approx(155.0 - 147)
    assert log["trace/env.sim.host_ms"] == pytest.approx(35.0) and log["trace/env.graph_replay.host_ms"] == 5.0
    assert log["trace/env.graph_kernels"] == 99_000
    assert trace.log_values([_pql_record(0, clock=False)]).keys() == {
        "trace/env.sim.host_ms", "trace/env.graph_replay.host_ms", "trace/replay.nstep.host_ms",
        "trace/replay.add.host_ms", "trace/learner.critic.host_ms", "trace/learner.actor.host_ms",
        "trace/env.graph_kernels"}


# -------------------------------------------------------------- on the card


@pytest.mark.gpu
def test_device_segments_tile_the_iteration_on_the_card():
    """PQL Ant at 256 envs on the card: every read iteration's top-level
    spans lie in order inside its period, the layers' segments and the
    ``iteration`` rest sum to it, and the graph counters match libcuda's
    count of the captured step and of the learner's two phase graphs
    (eager in the first iteration, captured in the second), beside the
    clip and AdamW pair's launches, counted through the replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device clock is CUDA events")
    from pql_tpu_torch.algos.base import set_precision

    cfg = make_config("pql", task="Ant", num_envs=256, algo__batch_size=1024, algo__memory_size=100_000,
                      algo__warm_up=4)
    set_precision(cfg)
    agent = PQL(cfg, device="cuda")
    state = agent.init(0)
    state, _ = agent.warmup(state)
    for _ in range(6):
        state, _ = agent.train_iter(state)
    rows = [r for r in _iterations(trace.recent(sync=True)) if r.period_ms is not None]
    assert len(rows) == 5
    (graph,) = agent.env.task._graphs.values()
    kernels = rigid.graph_kernel_nodes(graph.graph)[0]
    learner = sum(g.kernels for g in agent._graphs.graphs.values())  # the critic's and the actor's graph
    for rec in rows:
        assert tuple(_top(rec)) == PQL_TOP and report.tiles(rec)
        dev = rec.device_ms()
        assert sum(dev.values()) == pytest.approx(rec.period_ms) and dev["iteration"] >= 0
        replayed = {} if rec.iteration == 0 else {"learner.graph_replays": 2, "learner.graph_kernels": learner}
        captured = {"learner.graph_captures": 2} if rec.iteration == 1 else {}
        # the clip and AdamW pair: two launches an update, but each optimizer's first (``opt.step()``)
        tail = {"learner.clip_adamw_steps": 2 * (agent.n_critic + agent.n_actor - (2 if rec.iteration == 0 else 0))}
        assert rec.counters == {"env.graph_replays": 1, "env.graph_kernels": kernels, **replayed, **captured, **tail}
