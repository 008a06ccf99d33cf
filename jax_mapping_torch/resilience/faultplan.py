"""Deterministic chaos injection: a scripted, seeded schedule of faults.

A copy of the JAX package's `resilience/faultplan.py` (host Python): the
same kinds, refusals, composition rules, log and boundary calls.
`cache_wipe` acts on a stack with the cold-start tier's compile cache,
and the tenant kinds and `controlplane_crash` on a stack with the tenancy
control plane (`cfg.tenancy.enabled`); a stack without that tier takes
the JAX branch: the fault notes "skipped" and does nothing else.

The fault-injection knobs this repo accumulated — bus drop/reorder
probabilities, driver read-failure injection, transport disconnects,
checkpoint files that can rot — are islands: each is reachable only from
hand-written test code, so no test can exercise a *mission* where several
of them fire in sequence. A `FaultPlan` is that mission script: an
ordered list of `FaultEvent`s, each firing at a specific `Stack.run_steps`
step index and auto-clearing after `duration` steps, injected at the
EXISTING boundaries (bus partition/probability setters, driver injection
fields, node kill) — no monkeypatching, so the chaos path exercises the
same code real faults would.

Determinism: events fire on the deterministic step clock; the only
randomness is the constructor's seeded RNG, used by `random_plan` to
GENERATE schedules — applying a given plan is fully deterministic, so a
chaos soak can assert two same-seed runs produce identical maps.

Fault kinds and their boundaries:

    lidar_dead          bus.partition("{ns}scan") — the robot's scan
                        stream goes dark (transport dead / sensor loss);
                        heals after `duration`.
    driver_offline      driver.fail_reads_after = now — the next read
                        raises DriverError; the brain's catch-all drops
                        the link (the reference server's semantics); clears
                        after `duration` (reconnect probe then succeeds).
    bus_drop            bus.set_fault_injection(drop_prob=value) for the
                        window — lossy-Wi-Fi weather (report.pdf §V.A).
    bus_reorder         same, reorder_prob.
    kill_node           Stack.kill_node(name) — destroy the node
                        mid-mission; the Supervisor notices the silent
                        heartbeat and restarts it (mapper: from the
                        latest checkpoint, pose re-anchored).
    kill_robot          partition the robot's scan topic AND disable its
                        motors (driver.set_robot_enabled) — mid-mission
                        robot loss; FleetHealth declares it DEAD and the
                        fleet reassigns its frontier work.
    rejoin_robot        undo kill_robot — the robot relocalizes through
                        the mapper's normal matching against the shared
                        map.
    corrupt_checkpoint  truncate the file at `name` (default: the
                        stack's auto-checkpoint) — the power-loss /
                        bit-rot case the CRC32 + last-good rotation in
                        io/checkpoint.py exists for.

Adversarial SENSOR faults: unlike the kinds above, these do
not silence anything — the sensors keep reporting, plausibly and
wrongly, which is precisely what the recovery/ watchdog exists to
catch. Injected at the sim boundaries (`SimNode.set_*`, which delegate
to `sim/thymio.apply_wheel_slip` / `sim/lidar.apply_lidar_miscal` /
`apply_ghost_returns`); ghost beams are seeded per (launch seed, step,
robot), so same-seed chaos runs stay bit-identical.

    wheel_slip          measured wheel speeds biased by `value`
                        (e.g. 1.3 = odometry reads 30% fast; ground
                        truth motion untouched) — slip / miscalibrated
                        SPEED_COEFF (report.pdf §V.B: 13% CV).
    lidar_miscal        lidar mount rotated by `value` radians — every
                        beam reports a rotated world angle under its
                        old label.
    ghost_returns       a seeded `value` fraction of live beams replaced
                        with spurious short ranges (dust / multipath /
                        hostile reflector).
    scan_jam            ranges frozen at the jam-onset reading, stamps
                        stay fresh — a wedged sensor that looks alive.

WORLD kinds (the scenario engine): the world ITSELF changes —
nothing is faulty, but evidence the mapper fused honestly goes stale
and must heal (DecayConfig semantics). Injected at the SimNode's world-
dynamics boundary (`SimNode.set_door`/`set_crowd`, which delegate to a
`scenarios.WorldDynamics` attached at launch); both compose by the same
refcount/worst-of rules as every other windowed kind, and two same-seed
runs mutate the world bit-identically.

    door_close          fill door rectangle `name` (registered with the
                        WorldDynamics) with wall for the window;
                        overlapping windows on one door refcount — the
                        first to clear must not re-open a door another
                        window still holds shut.
    crowd               a moving occupied blob (seeded deterministic
                        orbit) of radius `value` metres; `robot` is the
                        crowd id (its path seed). Overlapping windows
                        on one crowd id run the WORST (largest) radius.

INFRASTRUCTURE kind (the warm-restart tier): the fault targets
the restart path's own acceleration layer — the mission must keep its
results bit-identical while restarts degrade from warm to cold.

    cache_wipe          delete the stack's compile-cache root
                        (persistent XLA cache + AOT snapshots) and
                        suppress cache writes for the window
                        (`CompileCacheManager.wipe_hold/release`);
                        overlapping windows refcount — the first to
                        clear must not re-enable a cache another still
                        holds wiped. A restart inside the window is a
                        genuinely cold restart; the stack degrades to
                        plain recompile, never crashes. No-op (noted in
                        the log) on stacks without a cold-start tier,
                        like corrupt_checkpoint with no file.

TENANT kinds (blast-radius containment): the fault targets
ONE tenant of a megabatched control plane — the containment contract
is that co-tenants never notice (bit-identical to a no-fault twin)
while the sentinels quarantine the victim. Injected at the plane's
own chaos seams (`TenantControlPlane.set_tenant_poison` /
`state_jump_tenant`), never by reaching into the batch from outside.
`name` is the tenant id for both. No-op (noted) on stacks without a
tenancy plane.

    tenant_poison       NaN the tenant's est-pose lane inputs every
                        tick of the window (covariance collapse /
                        odometry blow-up); overlapping windows on one
                        tenant refcount — the first to clear must not
                        un-poison a lane another window still holds.
                        The NONFINITE sentinel quarantines the lane
                        within the hysteresis budget.
    tenant_state_jump   teleport the tenant's estimated poses by
                        `value` metres (one-shot): survivable-state
                        corruption — the poses stay finite, but scan
                        matching against the tenant's own map degrades,
                        which the MATCH-FLOOR sentinel catches.
    controlplane_crash  kill the plane mid-mission and rebuild it from
                        its journal + checkpoints
                        (`Stack.crash_controlplane`): the in-memory
                        registry is lost, `restore()` replays
                        snapshot+journal, and every tenant comes back
                        with its epoch advanced (clients resync via
                        the epoch protocol).

MEMORY kinds (the bounded-memory world): the fault targets the
windowed world store's retention tiers — the contract is that memory
starvation DEGRADES (shed harder, coarsen, refuse admission; tiles
re-read as unknown) and storage rot is DETECTED (CRC), never a crash
or silent wrong-map. Injected at the store's own chaos seams
(`WorldStore.hold_pressure` / `corrupt_spill`). No-op (noted) on
stacks without a windowed world.

    memory_pressure     synthetic host-budget squeeze: the effective
                        LRU budget shrinks by `value` (0.55 = the
                        governor plans against 45% of the configured
                        tiles) for the window; overlapping windows
                        compose WORST-OF through the governor's named
                        holds — the first to clear must not relax a
                        squeeze another window still holds.
    spill_corrupt       flip a CRC-detectable bit in up to `value`
                        spilled tiles (frame checksum re-stamped =
                        silent at-rest rot); one-shot and permanent —
                        the next rehydrate of a hit tile must degrade
                        it to unknown with a flight event, never raise.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Optional

#: Adversarial sensor-fault kinds (SimNode boundary; recovery/ targets).
SENSOR_KINDS = frozenset({
    "wheel_slip", "lidar_miscal", "ghost_returns", "scan_jam",
})

#: Dynamic-world scenario kinds (SimNode world-dynamics boundary;
#: the decaying mapper's healing path is their target).
WORLD_KINDS = frozenset({"door_close", "crowd"})

#: Tenant blast-radius kinds (TenantControlPlane chaos-seam boundary;
#: the containment ladder + durable registry are their targets).
TENANT_KINDS = frozenset({
    "tenant_poison", "tenant_state_jump", "controlplane_crash",
})

#: Bounded-memory world kinds (WorldStore chaos-seam boundary; the
#: pressure governor + spill CRC integrity are their targets).
MEMORY_KINDS = frozenset({"memory_pressure", "spill_corrupt"})

KINDS = frozenset({
    "lidar_dead", "driver_offline", "bus_drop", "bus_reorder",
    "kill_node", "kill_robot", "rejoin_robot", "corrupt_checkpoint",
    "cache_wipe",
}) | SENSOR_KINDS | WORLD_KINDS | TENANT_KINDS | MEMORY_KINDS


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. `step` is the Stack.run_steps index it fires
    at; `duration` > 0 auto-clears that many steps later (0 = permanent
    or cleared by a paired event, e.g. kill_robot/rejoin_robot)."""

    step: int
    kind: str
    robot: int = 0
    duration: int = 0
    value: float = 0.0          # kind-specific (drop/reorder probability)
    name: str = ""              # node name / file path

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {sorted(KINDS)})")
        if self.step < 0 or self.duration < 0:
            raise ValueError("step and duration must be >= 0")
        # Value-carrying sensor kinds refuse the 0.0 default: for
        # wheel_slip it is the worst possible fault (a 0x measured-speed
        # factor is total odometry blackout, not slip — 1.0 is healthy),
        # and for miscal/ghosts it is a silent no-op that would let a
        # chaos test "pass" while never injecting the fault it scripted.
        if self.kind == "wheel_slip" and self.value <= 0.0:
            raise ValueError(
                "wheel_slip needs value > 0: the measured-speed factor "
                "(1.0 = healthy, e.g. 1.3 = odometry reads 30% fast)")
        if self.kind in ("lidar_miscal", "ghost_returns") \
                and self.value == 0.0:
            raise ValueError(
                f"{self.kind} needs a nonzero value (the angular offset "
                "in rad / the ghosted beam fraction) — 0.0 injects "
                "nothing")
        if self.kind == "door_close" and not self.name:
            raise ValueError(
                "door_close needs name = a door registered with the "
                "stack's WorldDynamics (an unnamed close is a no-op a "
                "scenario would silently 'pass' with)")
        if self.kind == "crowd" and self.value <= 0.0:
            raise ValueError(
                "crowd needs value > 0: the blob radius in metres "
                "(0.0 stamps nothing)")
        if self.kind in ("tenant_poison", "tenant_state_jump") \
                and not self.name:
            raise ValueError(
                f"{self.kind} needs name = the target tenant id (an "
                "unnamed tenant fault is a no-op a chaos drill would "
                "silently 'pass' with)")
        if self.kind == "tenant_state_jump" and self.value <= 0.0:
            raise ValueError(
                "tenant_state_jump needs value > 0: the teleport "
                "distance in metres (0.0 jumps nowhere)")
        if self.kind == "memory_pressure" \
                and not 0.0 < self.value <= 1.0:
            raise ValueError(
                "memory_pressure needs 0 < value <= 1: the budget "
                "squeeze fraction (0.0 squeezes nothing, and a chaos "
                "test would silently 'pass' without it)")
        if self.kind == "spill_corrupt" and self.value < 1.0:
            raise ValueError(
                "spill_corrupt needs value >= 1: the number of spilled "
                "tiles to rot (0 corrupts nothing)")


class FaultPlan:
    """Apply a schedule of FaultEvents against a running Stack.

    `apply(stack, step)` is called once per step (Stack.run_steps does
    this automatically when a plan is attached); it runs due clears,
    then fires due events. `log` records every action as
    (step, description) — two same-seed runs of the same plan produce
    identical logs, the soak test's determinism anchor."""

    def __init__(self, events: List[FaultEvent], seed: int = 0):
        self.events = sorted(events, key=lambda e: (e.step, e.kind,
                                                    e.robot))
        self.seed = seed
        self._rng = random.Random(seed)
        #: Faults random_plan ASKED for but could not place (same-
        #: resource overlap rejection saturated its resample budget) —
        #: 0 for hand-written plans. A soak that believes it injected
        #: n_faults must be able to see how many it actually got.
        self.generation_shortfall = 0
        self._fired = [False] * len(self.events)
        #: (due_step, callable, description) pending auto-clears.
        self._clears: List[tuple] = []
        self.log: List[tuple] = []
        # Overlap bookkeeping: clears are REFCOUNTED so two windows on
        # the same resource compose — the first window's clear must not
        # heal a partition (or restore weather) the second still holds.
        self._partition_refs: Dict[str, int] = {}
        self._robot_kill_refs: Dict[int, int] = {}
        self._driver_refs = 0
        #: knob -> (baseline captured at first fire, active values).
        self._weather: Dict[str, tuple] = {}
        #: (kind, robot) -> active values for the sensor-fault kinds —
        #: the weather pattern per robot: overlapping windows compose by
        #: running the WORST active value, the identity baseline returns
        #: when the last window clears.
        self._sensor: Dict[tuple, list] = {}
        #: door name -> held-closure refcount (the partition pattern:
        #: last window out re-opens the door).
        self._door_refs: Dict[str, int] = {}
        #: crowd id -> active radii (the sensor pattern: the sim runs
        #: the WORST = largest active blob, gone when none remain).
        self._crowd: Dict[int, list] = {}
        #: tenant id -> held-poison refcount (the partition pattern:
        #: last window out un-poisons the lane).
        self._tenant_poison_refs: Dict[str, int] = {}

    # -- boundary helpers ----------------------------------------------------

    @staticmethod
    def _scan_topic(stack, robot: int) -> str:
        from jax_mapping_torch.bridge.brain import robot_ns
        return f"{robot_ns(robot, stack.brain.n_robots)}scan"

    def _note(self, step: int, desc: str) -> None:
        self.log.append((step, desc))
        # Every window open/clear is a load-bearing transition: the
        # flight recorder stream interleaves the chaos script with the
        # system's reactions, which is the whole point of a postmortem
        # ("the gate failed two events after `door_close door0`").
        from jax_mapping_torch.obs.recorder import flight_recorder
        flight_recorder.record("fault", step=step, desc=desc)

    # -- the per-step hook ---------------------------------------------------

    def apply(self, stack, step: int) -> None:
        still_pending = []
        for due, fn, desc in self._clears:
            if step >= due:
                fn()
                self._note(step, f"clear: {desc}")
            else:
                still_pending.append((due, fn, desc))
        self._clears = still_pending
        for i, ev in enumerate(self.events):
            if not self._fired[i] and ev.step <= step:
                self._fired[i] = True
                self._fire(stack, ev, step)

    # -- refcounted resource holds (overlapping windows compose) -----------

    def _hold_partition(self, bus, topic: str) -> None:
        self._partition_refs[topic] = \
            self._partition_refs.get(topic, 0) + 1
        bus.partition(topic)

    def _release_partition(self, bus, topic: str) -> None:
        n = self._partition_refs.get(topic, 1) - 1
        self._partition_refs[topic] = max(0, n)
        if n <= 0:
            bus.heal(topic)                  # last window out heals

    def _apply_weather(self, bus, key: str, value: Optional[float]
                       ) -> None:
        """Add (value) or remove (None pops the given value via the
        caller) one active weather window; the bus runs the WORST of the
        active windows, reverting to the pre-chaos baseline when the
        last one clears."""
        base, active = self._weather.setdefault(
            key, (getattr(bus, key), []))
        if value is not None:
            active.append(value)
        bus.set_fault_injection(**{key: max(active) if active else base})

    def _apply_sensor(self, stack, kind: str, robot: int,
                      value: Optional[float]) -> None:
        """Add (value) or remove (None; caller popped the list) one
        active sensor-fault window for (kind, robot); the sim runs the
        WORST of the active windows, identity when none remain."""
        active = self._sensor.setdefault((kind, robot), [])
        if value is not None:
            active.append(value)
        sim = stack.sim
        if kind == "wheel_slip":
            # Worst = farthest from the healthy 1.0 factor.
            worst = max(active, key=lambda v: abs(v - 1.0)) \
                if active else 1.0
            sim.set_wheel_slip(robot, worst)
        elif kind == "lidar_miscal":
            worst = max(active, key=abs) if active else 0.0
            sim.set_lidar_miscal(robot, worst)
        elif kind == "ghost_returns":
            sim.set_ghost_returns(robot, max(active) if active else 0.0)
        elif kind == "scan_jam":
            sim.set_scan_jam(robot, bool(active))

    # -- world-kind holds (scenarios/dynamics.py boundary) -------------------

    def _hold_door(self, sim, name: str) -> None:
        self._door_refs[name] = self._door_refs.get(name, 0) + 1
        sim.set_door(name, True)

    def _release_door(self, sim, name: str) -> None:
        n = self._door_refs.get(name, 1) - 1
        self._door_refs[name] = max(0, n)
        if n <= 0:
            sim.set_door(name, False)        # last window out re-opens

    def _apply_crowd(self, sim, cid: int,
                     radius: Optional[float]) -> None:
        """Add (radius) or remove (None; caller popped the list) one
        active crowd window for `cid`; the sim runs the WORST (largest)
        active blob, none when the last window clears."""
        active = self._crowd.setdefault(cid, [])
        if radius is not None:
            active.append(radius)
        sim.set_crowd(cid, max(active) if active else None)

    def _fire(self, stack, ev: FaultEvent, step: int) -> None:
        bus = stack.bus
        if ev.kind == "door_close":
            self._hold_door(stack.sim, ev.name)
            self._note(step, f"door_close {ev.name}")
            if ev.duration:
                def _reopen(name=ev.name):
                    self._release_door(stack.sim, name)
                self._clears.append((step + ev.duration, _reopen,
                                     f"door_close {ev.name}"))
        elif ev.kind == "crowd":
            self._apply_crowd(stack.sim, ev.robot, ev.value)
            self._note(step, f"crowd {ev.robot} r={ev.value}m")
            if ev.duration:
                def _clear_crowd(cid=ev.robot, value=ev.value):
                    self._crowd[cid].remove(value)
                    self._apply_crowd(stack.sim, cid, None)
                self._clears.append((step + ev.duration, _clear_crowd,
                                     f"crowd {ev.robot}"))
        elif ev.kind in SENSOR_KINDS:
            self._apply_sensor(stack, ev.kind, ev.robot, ev.value)
            self._note(step, f"{ev.kind} robot{ev.robot}={ev.value}")
            if ev.duration:
                def _clear_sensor(kind=ev.kind, robot=ev.robot,
                                  value=ev.value):
                    self._sensor[(kind, robot)].remove(value)
                    self._apply_sensor(stack, kind, robot, None)
                self._clears.append((step + ev.duration, _clear_sensor,
                                     f"{ev.kind} robot{ev.robot}"))
        elif ev.kind == "lidar_dead":
            topic = self._scan_topic(stack, ev.robot)
            self._hold_partition(bus, topic)
            self._note(step, f"lidar_dead robot{ev.robot}")
            if ev.duration:
                self._clears.append((
                    step + ev.duration,
                    lambda: self._release_partition(bus, topic),
                    f"lidar_dead robot{ev.robot}"))
        elif ev.kind == "driver_offline":
            drv = stack.driver
            self._driver_refs += 1
            drv.fail_reads_after = drv._n_reads
            self._note(step, "driver_offline")
            if ev.duration:
                def _heal_driver():
                    self._driver_refs -= 1
                    if self._driver_refs <= 0:
                        drv.fail_reads_after = None
                self._clears.append((step + ev.duration, _heal_driver,
                                     "driver_offline"))
        elif ev.kind in ("bus_drop", "bus_reorder"):
            key = "drop_prob" if ev.kind == "bus_drop" else "reorder_prob"
            self._apply_weather(bus, key, ev.value)
            self._note(step, f"{ev.kind}={ev.value}")
            if ev.duration:
                def _clear_weather(key=key, value=ev.value):
                    self._weather[key][1].remove(value)
                    self._apply_weather(bus, key, None)
                self._clears.append((step + ev.duration, _clear_weather,
                                     f"{ev.kind}"))
        elif ev.kind == "kill_node":
            stack.kill_node(ev.name or "jax_mapper")
            self._note(step, f"kill_node {ev.name or 'jax_mapper'}")
        elif ev.kind == "kill_robot":
            topic = self._scan_topic(stack, ev.robot)
            self._hold_partition(bus, topic)
            self._robot_kill_refs[ev.robot] = \
                self._robot_kill_refs.get(ev.robot, 0) + 1
            stack.driver.set_robot_enabled(ev.robot, False)
            self._note(step, f"kill_robot robot{ev.robot}")
            if ev.duration:
                self._clears.append((
                    step + ev.duration,
                    lambda: self._rejoin(stack, ev.robot),
                    f"kill_robot robot{ev.robot}"))
        elif ev.kind == "rejoin_robot":
            self._rejoin(stack, ev.robot)
            self._note(step, f"rejoin_robot robot{ev.robot}")
        elif ev.kind == "cache_wipe":
            mgr = getattr(stack, "compile_cache", None)
            if mgr is None:
                self._note(step, "cache_wipe skipped (no compile "
                                 "cache on this stack)")
            else:
                mgr.wipe_hold()
                self._note(step, "cache_wipe")
                if ev.duration:
                    def _rearm(m=mgr):
                        m.wipe_release()
                    self._clears.append((step + ev.duration, _rearm,
                                         "cache_wipe"))
        elif ev.kind in ("tenant_poison", "tenant_state_jump"):
            plane = getattr(stack, "tenancy", None)
            if plane is None:
                self._note(step, f"{ev.kind} skipped (no tenant "
                                 "control plane on this stack)")
            elif ev.kind == "tenant_poison":
                self._hold_tenant_poison(plane, ev.name)
                self._note(step, f"tenant_poison {ev.name}")
                if ev.duration:
                    def _unpoison(tid=ev.name):
                        # Re-read the plane at clear time: a
                        # controlplane_crash inside the window must
                        # clear against the RESTORED plane, not the
                        # dead one.
                        self._release_tenant_poison(
                            getattr(stack, "tenancy", None), tid)
                    self._clears.append((step + ev.duration, _unpoison,
                                         f"tenant_poison {ev.name}"))
            else:
                plane.state_jump_tenant(ev.name, ev.value)
                self._note(step,
                           f"tenant_state_jump {ev.name}={ev.value}m")
        elif ev.kind == "controlplane_crash":
            crash = getattr(stack, "crash_controlplane", None)
            if crash is None or getattr(stack, "tenancy", None) is None:
                self._note(step, "controlplane_crash skipped (no "
                                 "tenant control plane on this stack)")
            else:
                report = crash()
                self._note(step, "controlplane_crash restored="
                                 f"{len(report.get('restored', []))} "
                                 f"lost={len(report.get('lost', []))}")
        elif ev.kind in MEMORY_KINDS:
            store = getattr(stack, "world", None) or \
                getattr(getattr(stack, "mapper", None), "world", None)
            if store is None:
                self._note(step, f"{ev.kind} skipped (no windowed "
                                 "world store on this stack)")
            elif ev.kind == "memory_pressure":
                # One named hold per EVENT (step disambiguates two
                # same-kind windows): overlapping holds compose
                # worst-of inside the governor, and each window's
                # clear releases only its own name.
                hold = f"chaos@{ev.step}"
                store.hold_pressure(hold, ev.value)
                self._note(step, f"memory_pressure={ev.value}")
                if ev.duration:
                    def _relax(name=hold):
                        # Re-read the store at clear time: a kill_node
                        # inside the window replaced the mapper (and
                        # its store), and the governor holds died with
                        # it — releasing against the dead store is the
                        # harmless branch.
                        s = getattr(stack, "world", None) or \
                            getattr(getattr(stack, "mapper", None),
                                    "world", None)
                        if s is not None:
                            s.release_pressure(name)
                    self._clears.append((step + ev.duration, _relax,
                                         "memory_pressure"))
            else:
                hit = store.corrupt_spill(max(1, int(ev.value)))
                if hit:
                    self._note(step, f"spill_corrupt {len(hit)} "
                                     f"tile(s): {sorted(hit)}")
                else:
                    self._note(step, "spill_corrupt skipped (no "
                                     "spilled tiles to rot)")
        elif ev.kind == "corrupt_checkpoint":
            path = ev.name or getattr(stack, "auto_checkpoint_path", "")
            if path and os.path.exists(path):
                size = os.path.getsize(path)
                with open(path, "rb+") as f:
                    f.truncate(max(1, int(size * 0.6)))
                self._note(step, f"corrupt_checkpoint {path} "
                                 f"({size} -> {max(1, int(size * 0.6))}B)")
            else:
                self._note(step, f"corrupt_checkpoint skipped "
                                 f"(no file at {path!r})")

    def _hold_tenant_poison(self, plane, tid: str) -> None:
        self._tenant_poison_refs[tid] = \
            self._tenant_poison_refs.get(tid, 0) + 1
        plane.set_tenant_poison(tid, True)

    def _release_tenant_poison(self, plane, tid: str) -> None:
        n = self._tenant_poison_refs.get(tid, 1) - 1
        self._tenant_poison_refs[tid] = max(0, n)
        if n <= 0 and plane is not None:
            plane.set_tenant_poison(tid, False)  # last window out

    def _rejoin(self, stack, robot: int) -> None:
        if self._robot_kill_refs.get(robot, 0) <= 0:
            # No kill held: a stray rejoin_robot must not heal a
            # partition some OTHER window (e.g. lidar_dead) still owns.
            return
        self._robot_kill_refs[robot] -= 1
        self._release_partition(stack.bus, self._scan_topic(stack, robot))
        if self._robot_kill_refs[robot] == 0:
            stack.driver.set_robot_enabled(robot, True)

    def done(self) -> bool:
        return all(self._fired) and not self._clears

    def summary(self) -> List[str]:
        return [f"step {s}: {d}" for s, d in self.log]


def _fault_resource(kind: str, robot: int, name: str = "") -> tuple:
    """The resource a fault window occupies, for overlap rejection:
    two windows on one resource would need refcount composition at
    APPLY time (hand-written plans may still do that deliberately);
    generated fuzz keeps windows disjoint so each fault's effect — and
    the recovery it provokes — is attributable to one event."""
    if kind in ("lidar_dead", "lidar_miscal", "ghost_returns",
                "scan_jam"):
        return ("scan", robot)
    if kind == "wheel_slip":
        return ("odom", robot)
    if kind == "driver_offline":
        return ("driver",)
    if kind == "door_close":
        return ("door", name)
    if kind == "crowd":
        return ("crowd", robot)          # robot field = crowd id
    if kind == "cache_wipe":
        return ("cache",)                # one compile cache per stack
    if kind in ("tenant_poison", "tenant_state_jump"):
        return ("tenant", name)          # name field = tenant id
    if kind == "controlplane_crash":
        return ("controlplane",)         # one plane per stack
    if kind == "memory_pressure":
        return ("memory",)               # one host LRU per stack
    if kind in ("spill_corrupt", "corrupt_checkpoint"):
        # One durable-storage resource: rotting the spill file AND
        # truncating a checkpoint in one window would make the
        # degradation unattributable (both heal through re-anchor /
        # rehydrate paths that share the postmortem).
        return ("checkpoint",)
    return ("bus", kind)                 # bus_drop / bus_reorder


def _sample_value(rng: random.Random, kind: str) -> float:
    """Kind-appropriate magnitudes: bus weather as before; wheel slip a
    1.15-1.5x odometry bias; miscal 0.05-0.3 rad (sign sampled);
    ghosts on 10-40% of beams; crowd blobs 0.15-0.4 m radius."""
    if kind.startswith("bus_"):
        return round(rng.uniform(0.2, 0.7), 3)
    if kind == "wheel_slip":
        return round(rng.uniform(1.15, 1.5), 3)
    if kind == "lidar_miscal":
        return round(rng.choice((-1.0, 1.0)) * rng.uniform(0.05, 0.3), 3)
    if kind == "ghost_returns":
        return round(rng.uniform(0.1, 0.4), 3)
    if kind == "crowd":
        return round(rng.uniform(0.15, 0.4), 3)
    if kind == "tenant_state_jump":
        # Well past any honest per-tick translation, well inside the
        # arena: the jump must corrupt, not escape the map.
        return round(rng.uniform(0.5, 2.0), 3)
    if kind == "memory_pressure":
        # Deep enough that the governor must climb a rung, shy of the
        # budget floor (1.0 would plan against a single tile).
        return round(rng.uniform(0.4, 0.9), 3)
    if kind == "spill_corrupt":
        return float(rng.randrange(1, 4))
    return 0.0


def random_plan(mission_steps: int, n_faults: int = 3, seed: int = 0,
                n_robots: int = 1, door_names=(),
                n_crowds: int = 0,
                allow_cache_wipe: bool = False,
                tenant_ids=(),
                allow_controlplane_crash: bool = False,
                allow_world_faults: bool = False) -> FaultPlan:
    """Generate a reproducible schedule: `seed` fully determines the
    fault mix, placement, and durations (fuzz-style soak variety with
    CI-replayable failures). Samples the adversarial sensor kinds
    alongside the transport/driver faults, and REJECTS overlapping
    windows on the same resource at generation time (resampling,
    bounded) — generated chaos keeps each fault's effect attributable.
    Short missions can saturate every resource before n_faults place;
    the dropped count is exposed as `plan.generation_shortfall`, never
    silently swallowed.

    Dynamic-world kinds join the pool only when the stack can run them:
    `door_names` (the doors registered with its WorldDynamics) admits
    `door_close` windows (one door = one resource), `n_crowds` > 0
    admits `crowd` windows with kind-appropriate blob radii (one crowd
    id = one resource), `allow_cache_wipe` admits `cache_wipe` windows
    (stacks with a cold-start compile cache; the one cache = one
    resource), `tenant_ids` (ids live on the stack's tenancy plane)
    admits `tenant_poison` / `tenant_state_jump` windows (one tenant =
    one resource), `allow_controlplane_crash` admits ONE
    `controlplane_crash` per plan (the one plane = one resource), and
    `allow_world_faults` admits `memory_pressure` windows (the one
    host LRU = one resource) and one-shot `spill_corrupt` rots (the
    one durable-storage resource, shared with checkpoint truncation)
    for stacks running a windowed world store. Default arguments
    reproduce the pre-scenario sampler bit-for-bit."""
    rng = random.Random(seed)
    kinds = ["lidar_dead", "driver_offline", "bus_drop", "bus_reorder",
             "wheel_slip", "lidar_miscal", "ghost_returns", "scan_jam"]
    door_names = list(door_names)
    tenant_ids = list(tenant_ids)
    if door_names:
        kinds.append("door_close")
    if n_crowds > 0:
        kinds.append("crowd")
    if allow_cache_wipe:
        kinds.append("cache_wipe")
    if tenant_ids:
        kinds += ["tenant_poison", "tenant_state_jump"]
    if allow_controlplane_crash:
        kinds.append("controlplane_crash")
    if allow_world_faults:
        kinds += ["memory_pressure", "spill_corrupt"]
    events: List[FaultEvent] = []
    occupied: List[tuple] = []           # (resource, start, end)
    shortfall = 0
    for _ in range(n_faults):
        for _attempt in range(64):       # bounded resample budget
            kind = rng.choice(kinds)
            step = rng.randrange(1, max(2, mission_steps - 10))
            duration = rng.randrange(3, 12)
            robot = rng.randrange(n_crowds) if kind == "crowd" \
                else rng.randrange(n_robots)
            name = ""
            if kind == "door_close":
                name = rng.choice(door_names)
            elif kind in ("tenant_poison", "tenant_state_jump"):
                name = rng.choice(tenant_ids)
            res = _fault_resource(kind, robot, name)
            start, end = step, step + duration
            if kind == "controlplane_crash":
                # The crash occupies the plane for the WHOLE mission:
                # one crash per plan (a second restore would re-bump
                # every epoch and make no fault attributable to either).
                start, end = 0, mission_steps
            if any(r == res and start <= e and s <= end
                   for r, s, e in occupied):
                continue                 # same-resource overlap: reject
            occupied.append((res, start, end))
            events.append(FaultEvent(
                step=step, kind=kind, robot=robot, duration=duration,
                value=_sample_value(rng, kind), name=name))
            break
        else:
            shortfall += 1               # every resource window taken
    plan = FaultPlan(events, seed=seed)
    plan.generation_shortfall = shortfall
    return plan
