"""Entry: a hosting deployment, `missions` fleet missions admitted to one
`tenancy/controlplane.py::TenantControlPlane` and stepped together.

Set-up admits every mission (mission m on the traffic's world made with
seed + m, moved on to the traffic's preroll), journal and checkpoints
under the run's temporary folder. A tick is one `TenantControlPlane.step`
with every mission's seed-made wheel normals forced, and it ends when all
missions' wheel targets are on the host. A kept tick's input batch,
output states, diagnostics and health words are copied to the host as
the tick ends. The check steps the plain reference, lane by lane, from
each kept input batch, and compares every lane's output state, its
diagnostics and its health word; it compares one mission's fresh state
with the reference's, and reads that mission's admission back from the
journal and its checkpoint."""

from __future__ import annotations

import os

import numpy as np

from port_bench.harness import compare, durability, preroll
from port_bench.harness.refcheck import (Out, control_gaps, load_reference,
                                          reference_types, step_reference)

HEALTH_TARGET = "jax_mapping_torch.tenancy.megabatch:megabatch_tick"


def _lane(tree, i: int):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_lane(x, i) for x in tree))
    return tree[i]


class Entry:
    def __init__(self, run):
        from jax_mapping_torch.models import fleet as FL
        from jax_mapping_torch.tenancy import controlplane as CP
        self.run, self.FL, self.CP = run, FL, CP
        self.kept = []
        self.slots = []
        self.health = None

    def _capture_health(self, fn):
        def captured(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.health = out[2]
            return out
        return captured

    def setup(self) -> None:
        run = self.run
        self.M = int(run.config["missions"])
        self.R = run.cfg.fleet.n_robots
        self.tids = [f"m{m:02d}" for m in range(self.M)]
        self.ckpt_dir = os.path.join(run.tmp, "plane")
        self.plane = self.CP.TenantControlPlane(
            run.cfg, world_res_m=run.resolution_m,
            checkpoint_dir=self.ckpt_dir, device=run.device)
        _, rcfg = load_reference(run)
        self.drawn = int(run.seed) % self.M   # the mission read back
        for m, tid in enumerate(self.tids):
            fresh = self.FL.init_fleet_state(
                run.cfg, device=run.device,
                radius_uniforms=run.inputs.uniforms[m])
            st = preroll.mid_mission(
                run.cfg, rcfg, fresh, run.inputs.worlds[m],
                run.resolution_m, run.cell.traffic["preroll"], run.seed, m)
            if m == self.drawn:
                self.fresh = compare.to_device(fresh, "cpu")
                self.admitted = compare.to_device(st, "cpu")
            self.plane.admit(tid, run.inputs.worlds[m], seed=run.seed + m,
                             state=st)
            del fresh, st
        run.patches.wrap(HEALTH_TARGET, self._capture_health)
        self.k = 0

    def offered(self) -> int:
        return self.M * self.R

    def step(self) -> None:
        self.pre = self.plane.live_batch()
        self.noise_k = self.k
        noise = self.run.inputs.noise(self.k)                # (M, R, 2)
        forced = {tid: noise[m].numpy() for m, tid in enumerate(self.tids)}
        self.diag = self.plane.step(1, wheel_normals=forced)

    def read(self):
        """Every mission's wheel targets to the host; (offered, carried,
        finite flag): a quarantined lane's scans are not carried."""
        torch = self.run.torch
        self.targets = self.diag.policy.targets.cpu()
        self.post = self.plane.live_batch()
        flag = torch.isfinite(self.post.states.est_poses).all() & \
            torch.isfinite(self.post.states.grid).all()
        held = sum(self.plane.tenant_lifecycle(t) != "active"
                   for t in self.tids)
        self.k += 1
        return self.M * self.R, (self.M - held) * self.R, flag

    def keyed(self) -> bool:
        """Whether a robot of any mission keyed a scan in the last tick."""
        return bool(self.diag.is_key.any())

    def _tree(self):
        return (self.pre, self.post.states, self.diag)

    def reserve(self, n: int) -> None:
        """Host room for n kept ticks, shaped as the last tick's."""
        pinned = self.run.device.type == "cuda"
        self.slots = [compare.host_like(self._tree(), pinned)
                      for _ in range(n)]

    def room(self) -> int:
        return len(self.slots) - len(self.kept)

    def keep(self, tick: int) -> None:
        slot = self.slots[len(self.kept)]
        compare.copy_into(slot, self._tree())
        health = None if self.health is None else np.array(self.health)
        self.kept.append((tick, self.noise_k, slot, health))

    def samples(self):
        return list(self.kept)

    def release(self) -> None:
        self.plane = self.pre = self.post = self.diag = None

    def _read_back(self) -> int:
        """Elements of the drawn mission's admission that the journal and
        its checkpoint do not give back: a missing admit record or seed,
        a leaf missing or failing its CRC, and every element that differs
        from the state admitted."""
        tid = self.tids[self.drawn]
        bad = 0
        rec = durability.journal_admits(
            os.path.join(self.ckpt_dir, "controlplane")).get(tid)
        if rec is None or int(rec.get("seed", -1)) != \
                self.run.seed + self.drawn:
            bad += 1
        path = os.path.join(self.ckpt_dir, f"tenant_{tid}.live.ckpt")
        got = (durability.checkpoint_leaves(path)
               if os.path.exists(path) else {})
        for name, want in compare.leaves(self.admitted):
            a = got.get("fleet." + name)
            w = want.numpy()
            if a is None or a.shape != w.shape or a.dtype != w.dtype:
                bad += max(1, w.size)
            else:
                bad += int((a != w).sum())
        return bad

    def check(self, samples, control: bool = False) -> dict:
        """The numbers of `compare.NUMBERS`, each its worst over the drawn
        mission's fresh state, its read-back admission and every lane of
        the kept ticks; with `control`, also the control's, its lane ticks
        in the program's place."""
        run = self.run
        torch = run.torch
        R, rcfg = load_reference(run)
        types = reference_types(R)
        dev = run.device
        ref = R["fleet"].init_fleet_state(
            rcfg, device=dev,
            radius_uniforms=run.inputs.uniforms[self.drawn])
        first = compare.gaps(self.fresh, ref)
        first["mismatches"] += self._read_back()
        readings, ctrl = [first], []
        for tick, nk, (pre, post, diag), health in samples:
            noise = run.inputs.noise(nk)
            active = pre.active.tolist()
            for i in range(len(active)):
                pre_i = _lane(pre.states, i)
                post_i = _lane(post, i)
                if not active[i]:        # a pad lane is frozen exactly
                    readings.append(compare.gaps(post_i, pre_i))
                    continue
                pre_i = compare.to_device(pre_i, dev)
                world = pre.worlds[i].to(dev)
                n_i = noise[i].to(dev)
                ref = Out(*step_reference(R, rcfg, pre_i, run.resolution_m,
                                          world, n_i, types))
                g = compare.gaps(Out(post_i, _lane(diag, i)), ref)
                word = R["health"].lane_health(rcfg, pre_i, *ref)
                g["mismatches"] += int(health is None
                                       or int(health[i]) != word)
                readings.append(g)
                if control:
                    ctrl.append(control_gaps(R, rcfg, pre_i,
                                             run.resolution_m, world, n_i,
                                             types, ref))
                del ref, pre_i
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        self.kept = []
        out = {"program": compare.worst(readings),
               "checked": [s[0] for s in samples]}
        if control:
            out["control"] = compare.worst(ctrl)
        return out
