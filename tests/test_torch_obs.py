"""The port's obs tier (host half) against the JAX package's.

`obs/trace.py`, `export.py`, `diff.py` and `slo.py` are stdlib-only in
both packages, so the JAX modules run in this process. The same publish
and span sequence gives the same trace and span ids; the Chrome export of
the same spans and recorder events is the same document; `diff_streams`
finds the same first divergence; the same recorded series drives both
SLO engines to the same alert transitions and status. The CLI runs as
`python -m jax_mapping_torch.obs`. On a stack, obs is inert: a short port
stack with obs on equals the same stack with obs off, and two same-seed
scenario runs emit identical span and recorder streams. The obs mission
tests (spans, /trace, /status.slo, the `jax_mapping_slo_*` families,
Server-Timing, the span stream against JAX's) run on the shared scenario
mission in `tests/test_torch_scenarios.py`.
"""

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jax_mapping_torch.config import ObsConfig, SloObjective, tiny_config
from jax_mapping_torch.obs import diff as D
from jax_mapping_torch.obs import export as E
from jax_mapping_torch.obs import slo as S
from jax_mapping_torch.obs import trace as T
from jax_mapping_torch.obs.pipeline import PipelineLedger
from tests.torch_jaxref import REPO
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _jax_obs():
    from jax_mapping.obs import diff, export, pipeline, slo, trace
    return trace, export, diff, slo, pipeline


def _drive_tracer(mod, seed):
    """One publish / span sequence: bus roots, a traced callback that
    publishes (children), timed spans with keys, instants with explicit
    parents, HTTP-style roots."""
    tr = mod.Tracer(seed=seed, capacity=1000)
    for k in range(3):
        ctx = tr.on_publish("robot0/scan")
        with tr.use(ctx):
            tr.emit("mapper.fuse", key=(0, k))
            tr.on_publish("/frontiers")
        tr.on_publish("robot1/odom")
    with tr.span("mapper.tick", key=7) as tick:
        tr.on_publish("/pose")
        with tr.span("inner"):
            tr.emit("leaf", key="x")
    tr.emit("mapper.fuse", parent=tick, key=(1, 1))
    with tr.span("http:/tiles"):
        pass
    with tr.span("http:/tiles"):
        tr.on_publish("/goal_pose")
    return tr


def _rows(spans):
    return [(s["seq"], s["name"], s["trace_id"], s["span_id"],
             s["parent_span"]) for s in spans]


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_tracer_ids_equal_jax(seed):
    jtrace = _jax_obs()[0]
    mine, theirs = _drive_tracer(T, seed), _drive_tracer(jtrace, seed)
    assert _rows(mine.spans_since(0)) == _rows(theirs.spans_since(0))
    assert mine.last_seq() == theirs.last_seq() == 20
    assert mine.stats() == theirs.stats()
    assert _rows(mine.spans_since(12)) == _rows(theirs.spans_since(12))
    for parts in [("trace", seed, "robot0/scan", 1), ("span", 1, 2, "n", 0)]:
        assert T.h64(*parts) == jtrace.h64(*parts)


def test_tracer_ring_is_bounded_and_ids_stay_deterministic():
    a, b = T.Tracer(seed=3, capacity=4), T.Tracer(seed=3, capacity=4)
    for tr in (a, b):
        for _ in range(10):
            tr.on_publish("t")
    assert len(a.spans_since(0)) == 4 and a.last_seq() == 10
    assert _rows(a.spans_since(0)) == _rows(b.spans_since(0))


def _spans_and_events():
    tr = _drive_tracer(T, 5)
    spans = tr.spans_since(0)
    for i, s in enumerate(spans):
        s["ts_us"], s["dur_us"], s["tid"] = 10.0 * i, 1.5 * (i % 3), 7
    events = [{"seq": 1, "kind": "fault", "wall_ts": 1.0, "step": 3,
               "desc": "door_close door0"},
              {"seq": 2, "kind": "slo_alert", "wall_ts": 2.0, "tick": 9,
               "objective": "staleness", "state": "firing"}]
    return spans, events


def test_chrome_export_equals_jax(tmp_path):
    jexport = _jax_obs()[1]
    spans, events = _spans_and_events()
    assert E.chrome_events(spans) == jexport.chrome_events(spans)
    assert E.recorder_events_as_chrome(events) \
        == jexport.recorder_events_as_chrome(events)
    dump = {"reason": "supervisor_restart_jax_mapper", "spans": spans,
            "events": events}
    assert E.dump_to_chrome(dump) == jexport.dump_to_chrome(dump)
    a = E.write_chrome_trace(str(tmp_path / "a.json"), spans, events)
    b = jexport.write_chrome_trace(str(tmp_path / "b.json"), spans, events)
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("where", ["none", "field", "length", "first"])
def test_diff_finds_the_same_first_divergence(where):
    jdiff = _jax_obs()[2]
    spans, events = _spans_and_events()
    a = [dict(s) for s in spans]
    b = [dict(s, seq=s["seq"] + 100, ts_us=0.0) for s in spans]
    if where == "field":
        b[6]["span_id"] += 1
    elif where == "length":
        b = b[:-2]
    elif where == "first":
        b[0]["name"] = "other"
    mine, theirs = D.diff_streams(a, b), jdiff.diff_streams(a, b)
    if where == "none":
        assert mine is None and theirs is None
        return
    assert mine.index == theirs.index == {"field": 6, "length": len(b),
                                          "first": 0}[where]
    assert mine.describe() == theirs.describe()
    da = {"events": events, "spans": a}
    db = {"events": events, "spans": b}
    r1, r2 = D.diff_dumps(da, db), jdiff.diff_dumps(da, db)
    assert r1["identical"] == r2["identical"] is False
    assert r1["spans"].index == r2["spans"].index
    assert D.normalize_events(events) == jdiff.normalize_events(events)


def _objectives(mod):
    return (mod.SloObjective(name="staleness", metric="tile_staleness_revs",
                             threshold=5.0, fast_window_ticks=4,
                             slow_window_ticks=12, fast_burn=0.5,
                             slow_burn=0.25),
            mod.SloObjective(name="fresh", metric="scan_to_served_p99_ms",
                             threshold=1e9, max_silent_ticks=6,
                             fast_window_ticks=3, slow_window_ticks=9),
            mod.SloObjective(name="deadline", metric="tick_deadline_ms",
                             threshold=50.0, fast_window_ticks=5,
                             slow_window_ticks=10),
            mod.SloObjective(metric="no_such_metric"))


def _series(n=80):
    """A recorded mission series: per tick, whether a scan installs a
    revision, whether a client is served, and the tick's duration."""
    rng = np.random.default_rng(11)
    rows = []
    for t in range(1, n + 1):
        stall = 30 <= t < 45                      # an ingest outage
        rows.append((t, (not stall) and rng.random() < 0.8,
                     t % 15 == 0 or t > 70, float(rng.uniform(5, 90))))
    return rows


def _run_slo(slo_mod, pipe_mod, objectives):
    led = pipe_mod.PipelineLedger()
    eng = slo_mod.SloEngine(objectives, pipeline=led)
    rev = 0
    for t, install, serve, ms in _series():
        led.note_tick(t)
        if install:
            rev += 1
            led.installed(rev, enq_t=None, tick=t)
            led.notified(rev)
        if serve and rev:
            led.delivered(rev)
        eng.evaluate(t, tick_ms=ms, map_revision=rev)
    status = eng.status()
    for o in status["objectives"]:
        o.pop("value")            # p99 of wall-clock hops
    return eng.alerts(), status


def test_slo_engine_transitions_equal_jax():
    """The same recorded series drives both engines to the same alert
    transitions at the same ticks, the same burn rates and counters."""
    from jax_mapping.config import SloObjective as JaxObjective
    from jax_mapping_torch.obs.recorder import flight_recorder
    _t, _e, _d, jslo, jpipe = _jax_obs()
    mark = flight_recorder.mark()
    from jax_mapping_torch.obs import pipeline as P
    mine = _run_slo(S, P, _objectives(SimpleNamespace(
        SloObjective=SloObjective)))
    theirs = _run_slo(jslo, jpipe, _objectives(SimpleNamespace(
        SloObjective=JaxObjective)))
    assert mine[0] == theirs[0]
    assert mine[1] == theirs[1]
    states = {(name, st) for _t2, name, st in mine[0]}
    assert ("staleness", "firing") in states and ("fresh", "firing") \
        in states and ("fresh", "clear") in states
    recorded = [(e["tick"], e["objective"], e["state"])
                for e in flight_recorder.events_since(mark)
                if e["kind"] == "slo_alert"]
    assert recorded == mine[0]
    fams = {f.name for f in S.SloEngine(
        (SloObjective(name="x"),), PipelineLedger()).metric_families()}
    assert fams == {"jax_mapping_slo_firing",
                    "jax_mapping_slo_burn_rate_fast",
                    "jax_mapping_slo_burn_rate_slow",
                    "jax_mapping_slo_breach_ticks_total",
                    "jax_mapping_slo_alerts_fired_total",
                    "jax_mapping_slo_alerts_cleared_total"}


def _dump(tmp_path, name, spans, events, pipeline=()):
    p = tmp_path / name
    p.write_text(json.dumps({"reason": "x", "spans": spans,
                             "events": events,
                             "pipeline": list(pipeline)}))
    return str(p)


def test_cli_diff_export_critical_path_and_refusal(tmp_path, capsys):
    from jax_mapping_torch.obs.__main__ import main
    spans, events = _spans_and_events()
    a = _dump(tmp_path, "a.json", spans, events)
    b = _dump(tmp_path, "b.json", spans[:-1], events)
    assert main(["diff", a, a]) == 0
    assert main(["diff", a, b]) == 1
    out = capsys.readouterr().out
    assert f"first divergence at event #{len(spans) - 1}" in out
    assert main(["export", a, "-o", str(tmp_path / "t.json")]) == 0
    doc = json.load(open(tmp_path / "t.json"))
    assert len(doc["traceEvents"]) == len(spans) + len(events)
    assert main(["critical-path", a]) == 2          # no records
    rec = {"revision": 3, "tick": 4, "tenant": "", "total_ms": 5.0,
           "critical": "fuse", "hops_ms": {"fuse": 4.0, "deliver": 1.0}}
    c = _dump(tmp_path, "c.json", spans, events, [rec])
    assert main(["critical-path", c, c]) == 0
    # cost-ledger runs on the card by default; without one it refuses
    # (no fallback to the CPU). Its CPU run is tests/test_torch_devprof.py's.
    import torch
    if not torch.cuda.is_available():
        capsys.readouterr()
        assert main(["cost-ledger"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
    assert main(["cost-ledger", "--device", "nope"]) == 2
    assert main(["nope"]) == 2


def test_cli_runs_as_a_module(tmp_path):
    spans, events = _spans_and_events()
    a = _dump(tmp_path, "a.json", spans, events)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "jax_mapping_torch.obs",
                        "diff", a, a], capture_output=True, text=True,
                       cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "spans: identical" in r.stdout


def _short_stack(obs: bool):
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config(2)
    cfg = cfg.replace(robot=dataclasses.replace(cfg.robot,
                                                speed_noise_frac=0.0))
    if obs:
        cfg = cfg.replace(obs=ObsConfig(enabled=True, slo=(SloObjective(
            name="s", metric="tile_staleness_revs", threshold=3.0,
            fast_window_ticks=4, slow_window_ticks=8),)))
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, seed=0, device="cpu")
    st.brain.start_exploring()
    st.run_steps(15)
    return st


def test_obs_is_inert_on_the_stack():
    """A short stack with obs on equals the same stack with obs off: the
    truth, the odometry, the grid, the key scans and the counters
    bit-equal, the estimates within the same-seed 1e-6 m (ROADMAP C);
    obs on built the tracer, the ledger and the engine and traced."""
    off, on = _short_stack(False), _short_stack(True)
    try:
        assert off.tracer is None and off.pipeline is None \
            and off.slo is None
        assert on.bus.tracer is on.tracer and on.tracer.last_seq() > 100
        assert on.slo.n_evaluations == on.mapper._tick_no
        np.testing.assert_array_equal(off.sim.truth_poses(),
                                      on.sim.truth_poses())
        np.testing.assert_array_equal(off.brain.poses, on.brain.poses)
        assert torch.equal(off.mapper.shared_grid, on.mapper.shared_grid)
        for a, b in zip(off.mapper.states, on.mapper.states):
            assert torch.equal(a.n_keyscans, b.n_keyscans)
            assert float((a.pose - b.pose).abs().max()) <= 1e-6
        assert off.mapper.n_scans_fused == on.mapper.n_scans_fused
        assert off.mapper.map_revision == on.mapper.map_revision
    finally:
        off.shutdown()
        on.shutdown()


def test_same_seed_runs_emit_identical_streams():
    """JAX's stream-identity acceptance on the port (24 of its 36 steps:
    past the door's clear and three decay passes): two same-seed scenario
    runs with tracing on emit identical span and recorder streams (no
    divergence under `diff_streams`), and another seed diverges at the
    very first span (two steps of it suffice)."""
    from jax_mapping_torch.config import DecayConfig
    from jax_mapping_torch.obs.recorder import flight_recorder
    from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan
    from jax_mapping_torch.scenarios import launch_scenario_stack
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config().replace(
        decay=DecayConfig(enabled=True, every_n_ticks=8, factor=0.9,
                          evidence_cap=1.5),
        obs=ObsConfig(enabled=True))
    world, doors = W.arena_with_door(96, cfg.grid.resolution_m)

    def drive(seed, steps=24):
        mark = flight_recorder.mark()
        st = launch_scenario_stack(cfg, world, doors=doors, n_robots=2,
                                   seed=seed, device="cpu")
        st.brain.start_exploring()
        st.attach_fault_plan(FaultPlan([FaultEvent(
            step=4, kind="door_close", name="door0", duration=10)],
            seed=seed))
        st.run_steps(steps)
        spans = st.tracer.spans_since(0)
        events = flight_recorder.events_since(mark)
        st.shutdown()
        return spans, events

    spans_a, events_a = drive(0)
    spans_b, events_b = drive(0)
    div = D.diff_streams(spans_a, spans_b)
    assert div is None, div.describe()
    div = D.diff_streams(events_a, events_b)
    assert div is None, div.describe()
    spans_c, _ = drive(1, steps=2)
    div = D.diff_streams(spans_a, spans_c)
    assert div is not None and div.index == 0
