"""The harness with the timed path broken underneath: run.run_cell on the
CPU (the look for a card skipped) at a toy size, once sound and once for
each fault a cell can have, and ``correct`` read: true when sound, false
for every fault.

- a step that returns its state unchanged;
- half of the elements left out of the step, the rest stepped;
- the exchange between cards left out (the TGV cell's toy in two shards
  through the program's sharded solver, as a cell on several cards runs:
  the halo receive buffers hold a uniform state instead of the
  neighbours');
- an answer altered where it is produced: the monitor row's residual
  norms, its kinetic energy (the TGV's monitor integrates it), or one
  value of the state after the step.
"""

import numpy as np
import pytest

from bench_h100 import run, spec
from bench_h100.tests.test_h100_reference import CHANNEL, toy


def step_unchanged(mp):
    import hifiles_tpu_torch.solver.solver as sv
    mp.setattr(sv.BlockLoop, "_step_body", lambda self: None)


def half_left_out(mp):
    import hifiles_tpu_torch.solver.solver as sv
    body = sv.BlockLoop._step_body

    def half(self):
        E = self.u_soa.shape[-1]
        keep = self.u_soa[..., E // 2:].clone()
        body(self)
        self.u_soa[..., E // 2:] = keep
    mp.setattr(sv.BlockLoop, "_step_body", half)


def exchange_left_out(mp):
    import hifiles_tpu_torch.parallel.soa_sharding as ss
    ex = ss.ShardedLoop._exchange

    def stale(self, bufs):
        return [x.mean(dim=1, keepdim=True).expand_as(x).contiguous()
                for x in ex(self, bufs)]
    mp.setattr(ss.ShardedLoop, "_exchange", stale)


def row_altered(mp):
    import hifiles_tpu_torch.io.history as hist
    write = hist.HistoryWriter.write

    def altered(self, i):
        out = write(self, i)
        out["residual"] = np.asarray(out["residual"]) * 1.1
        return out
    mp.setattr(hist.HistoryWriter, "write", altered)


def ke_altered(mp):
    import hifiles_tpu_torch.io.history as hist
    write = hist.HistoryWriter.write

    def altered(self, i):
        out = write(self, i)
        out["kineticenergy"] *= 1.001
        return out
    mp.setattr(hist.HistoryWriter, "write", altered)


def value_altered(mp):
    import hifiles_tpu_torch.solver.solver as sv
    body = sv.BlockLoop._step_body

    def altered(self):
        body(self)
        self.u_soa[0, 1, 0] += 0.1 * self.u_soa[:, 1].abs().max()
    mp.setattr(sv.BlockLoop, "_step_body", altered)


FAULTS = {"step_unchanged": step_unchanged, "half_left_out": half_left_out,
          "row_altered": row_altered, "value_altered": value_altered}
CASES = ([("tgv_re1600_160.mon50", f) for f in [None, *FAULTS]]
         + [("tgv_re1600_160.mon50", "ke_altered")]
         + [(CHANNEL, f) for f in [None, *FAULTS]]
         + [("tgv_re1600_160.mon50", f"{f}, 2 shards")
            for f in (None, "exchange_left_out")])


@pytest.mark.parametrize("name,fault", CASES)
def test_correct_reads_the_fault(name, fault, monkeypatch):
    cell = toy(name)
    cell.traffic["chunk_steps"] = 2
    if fault is not None and fault.endswith(", 2 shards"):
        cell.chips = 2
        cell.config["mesh"]["n"] = [2, 3, 2]
        fault = fault.split(",")[0]
        if fault == "exchange_left_out":
            exchange_left_out(monkeypatch)
        else:
            fault = None
    elif fault == "ke_altered":
        ke_altered(monkeypatch)
    elif fault is not None:
        FAULTS[fault](monkeypatch)
    result, lines = run.run_cell(cell, 2 ** 31 + 12345, 0.0, 0,
                                 device="cpu")
    assert result["correct"] is (fault is None), lines
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 2


def test_result_line_without_a_card():
    """The CPU run's device entry says so and carries no memory reading."""
    cell = toy("tgv_re1600_160.mon50")
    cell.traffic["chunk_steps"] = 1
    result, _ = run.run_cell(cell, 3, 0.0, 0, device="cpu")
    assert result["device"]["platform"] == "cpu"
    assert result["device"]["memory_peak_bytes"] is None
    assert "peak_mem_gib" not in result["metrics"]
    assert set(result["metrics"]) == {"dof_stage_per_s", "setup_s"}
    assert spec.Cell(spec.load(), "tgv_re1600_160.mon50").e2e == [
        "dof_stage_per_s", "peak_mem_gib", "setup_s"]
