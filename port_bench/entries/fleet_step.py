"""Entry: one fleet mission driven by `models/fleet.py::fleet_step`.

Set-up makes the program's fresh state and moves it on to the traffic's
preroll (`harness/preroll.py`). A tick is one call of `fleet_step` with
the tick's seed-made wheel normals, and it ends when its (R, 2) wheel
targets are on the host. A kept tick's input state, output state and
diagnostics are copied to the host as the tick ends. The check steps the
plain reference from each kept input state and compares the whole output
state and the tick's diagnostics; it also compares the program's fresh
state with the reference's."""

from __future__ import annotations

from port_bench.harness import compare, preroll
from port_bench.harness.refcheck import (Out, control_gaps, load_reference,
                                          reference_types, step_reference)


class Entry:
    def __init__(self, run):
        from jax_mapping_torch.models import fleet as FL
        self.run, self.FL = run, FL
        self.kept = []
        self.slots = []

    def setup(self) -> None:
        run = self.run
        torch = run.torch
        self.world = torch.as_tensor(run.inputs.worlds[0],
                                     device=run.device)
        fresh = self.FL.init_fleet_state(
            run.cfg, device=run.device,
            radius_uniforms=run.inputs.uniforms[0])
        self.fresh = compare.to_device(fresh, "cpu")
        _, rcfg = load_reference(run)
        self.state = preroll.mid_mission(
            run.cfg, rcfg, fresh, self.world, run.resolution_m,
            run.cell.traffic["preroll"], run.seed, 0)
        del fresh
        self.normals = run.inputs.normals[:, 0].to(run.device)
        self.R = run.cfg.fleet.n_robots
        self.k = 0

    def offered(self) -> int:
        return self.R

    def step(self) -> None:
        self.pre = self.state
        self.noise_k = self.k % self.normals.shape[0]
        self.state, self.diag = self.FL.fleet_step(
            self.run.cfg, self.pre, self.run.resolution_m, self.world,
            wheel_normals=self.normals[self.noise_k])

    def read(self):
        """Wheel targets to the host; (offered, carried, finite flag)."""
        torch = self.run.torch
        self.targets = self.diag.policy.targets.cpu()
        flag = torch.isfinite(self.state.est_poses).all() & \
            torch.isfinite(self.state.grid).all()
        self.k += 1
        return self.R, self.R, flag

    def keyed(self) -> bool:
        """Whether a robot keyed a scan in the last tick."""
        return bool(self.diag.is_key.any())

    def _tree(self):
        return (self.pre, self.state, self.diag)

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
        self.kept.append((tick, self.noise_k, slot))

    def samples(self):
        return list(self.kept)

    def release(self) -> None:
        self.state = self.pre = self.diag = None

    def check(self, samples, control: bool = False) -> dict:
        """The numbers of `compare.NUMBERS`, each its worst over the fresh
        state and the kept ticks; with `control`, also the control's, its
        tick in the program's place."""
        run = self.run
        R, rcfg = load_reference(run)
        types = reference_types(R)
        dev = run.device
        ref_init = R["fleet"].init_fleet_state(
            rcfg, device=dev, radius_uniforms=run.inputs.uniforms[0])
        readings = [compare.gaps(self.fresh, ref_init)]
        ctrl = []
        for tick, nk, (pre, post, diag) in samples:
            pre = compare.to_device(pre, dev)
            noise = run.inputs.noise(nk)[0].to(dev)
            ref = Out(*step_reference(R, rcfg, pre, run.resolution_m,
                                      self.world, noise, types))
            readings.append(compare.gaps(Out(post, diag), ref))
            if control:
                ctrl.append(control_gaps(R, rcfg, pre, run.resolution_m,
                                         self.world, noise, types, ref))
            del pre, ref
        self.kept = []
        out = {"program": compare.worst(readings),
               "checked": [s[0] for s in samples]}
        if control:
            out["control"] = compare.worst(ctrl)
        return out
