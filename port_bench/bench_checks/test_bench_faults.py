"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell of this benchmark can have. The run skips the
look for a card and is otherwise whole (set-up, window, check); the cells
run on one chip, so there is no exchange between chips to leave out."""

import pytest

from port_bench.bench_checks import tinybench


def _fleet_fault(kind):
    from jax_mapping_torch.models import fleet as FL
    real = FL.fleet_step

    def broken(cfg, state, res, world, wheel_normals=None, generator=None):
        new, diag = real(cfg, state, res, world, wheel_normals, generator)
        if kind == "unchanged":              # the step returns its state
            return state, diag
        if kind == "half":                   # half the robots left out
            h = new.est_poses.shape[0] // 2
            est = new.est_poses.clone()
            est[h:] = state.est_poses[h:]
            sim = new.sim.poses.clone()
            sim[h:] = state.sim.poses[h:]
            return new._replace(est_poses=est, sim=new.sim._replace(
                poses=sim)), diag
        est = new.est_poses.clone()          # an answer altered
        est[0, 0] += 0.01
        return new._replace(est_poses=est), diag
    return FL, "fleet_step", broken


def _plane_fault(kind):
    from jax_mapping_torch.tenancy import megabatch as MB
    real = MB.megabatch_tick

    def broken(cfg, batch, res, wheel_normals=None, generator=None):
        new, diag, health = real(cfg, batch, res, wheel_normals, generator)
        if kind == "unchanged":
            return batch, diag, health
        states = new.states
        if kind == "half":                   # half the lanes left out
            h = batch.active.shape[0] // 2
            grid = states.grid.clone()
            grid[h:] = batch.states.grid[h:]
            est = states.est_poses.clone()
            est[h:] = batch.states.est_poses[h:]
            states = states._replace(grid=grid, est_poses=est)
        else:                                # one lane's map cell altered
            grid = states.grid.clone()
            grid[0, 5, 5] += 0.25
            states = states._replace(grid=grid)
        return new._replace(states=states), diag, health
    return MB, "megabatch_tick", broken


@pytest.mark.parametrize("cell, fault", [
    ("tiny2.rooms", _fleet_fault), ("tinyplane.rooms", _plane_fault)])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault, kind):
    reg = tinybench.write(tmp_path)
    mod, attr, broken = fault(kind)
    monkeypatch.setattr(mod, attr, broken)
    out = tinybench.run(reg, cell, seed=2 ** 31 + 3, seconds=1.0)
    assert out["window"]["checked"], out["window"]
    assert out["correct"] is False, out["checks"]


def test_a_checkpoint_that_does_not_read_back_is_not_correct(tmp_path,
                                                             monkeypatch):
    from jax_mapping_torch.tenancy import controlplane as CP
    reg = tinybench.write(tmp_path)
    real = CP.TenantControlPlane._checkpoint_tenant

    def lossy(self, tid, state, world, key_state):
        grid = state.grid.clone()
        grid[7, 7] += 0.5
        return real(self, tid, state._replace(grid=grid), world, key_state)
    monkeypatch.setattr(CP.TenantControlPlane, "_checkpoint_tenant", lossy)
    out = tinybench.run(reg, "tinyplane.rooms", seed=2 ** 31 + 3,
                        seconds=0.5)
    assert out["checks"]["mismatches"]["value"] >= 1, out["checks"]
    assert out["correct"] is False


def test_the_plane_cell_is_correct_unbroken(tmp_path):
    reg = tinybench.write(tmp_path)
    out = tinybench.run(reg, "tinyplane.rooms", seed=2 ** 31 + 3,
                        seconds=3.0)
    assert out["correct"] is True, out["checks"]
    assert out["window"]["checked"], out["window"]
    assert out["attempted"] == out["window"]["ticks"] * 3 * 2

