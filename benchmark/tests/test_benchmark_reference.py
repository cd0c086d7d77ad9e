"""The plain reference agrees with the program's plain path, its control
does not, and a broken timed path makes the run not correct.

The program runs its plain PyTorch tick here (the CPU has no kernel); the
reference (``benchmark/reference``) works the state out again from the
benchmark's inputs and judges every tick. The control is the reference's
own solve in bfloat16 put in the program's place. The faults break the
program underneath the harness, which otherwise runs as on the card."""

import numpy as np
import pytest
import torch

from benchmark.control import control_run
from benchmark.judge import LIMITS, judge

from small_cells import AUCTION, RANK_CHURN, SINKHORN, run_small

CELLS = [AUCTION, SINKHORN, RANK_CHURN]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_plain_path(name):
    r = run_small(name)
    v = r["verdict"]
    assert v.correct, (v.numbers, v.notes)
    assert v.failed_ticks == 0 and v.ticks == len(r["record"]) >= 10
    assert r["placed"] > 0
    for k, limit in v.limits.items():
        assert v.numbers[k] <= limit


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    r = run_small(name)
    tr = r["traffic"]
    record, outputs, final = control_run(tr.config, tr, len(r["record"]))
    c = judge(tr.config, tr, record, final, outputs)
    assert not c.correct, c.numbers
    if name == SINKHORN:
        assert c.numbers["potential_gap"] > LIMITS["potential_gap"]
    else:
        assert c.numbers["tick_mismatch"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_at_full_precision_is_correct(monkeypatch, name):
    """The control's loop with its rounding switched off is the reference
    itself, and is judged correct: the control fails by its precision, not
    by its bookkeeping."""
    from benchmark import control

    monkeypatch.setattr(control, "to_bf16",
                        lambda x: np.asarray(x, dtype=np.float32))
    r = run_small(name)
    tr = r["traffic"]
    record, outputs, final = control.control_run(tr.config, tr,
                                                 len(r["record"]))
    c = judge(tr.config, tr, record, final, outputs)
    assert c.correct, (c.numbers, c.notes)
    assert sum(len(res.placed) for e in record for res in e[3]) > 0


def _wrap_tick(monkeypatch, after):
    """Break the program's tick: ``after(packet, state, out, new_state)``
    returns what the broken tick returns."""
    from tpu_faas_torch.sched import fused_tick

    real = fused_tick.fused_resident_tick

    def broken(packet, st, *, flush=False, **kw):
        res = real(packet, st, flush=flush, **kw)
        if flush:
            return res
        out, new = res
        return after(packet, st, out, new)

    monkeypatch.setattr(fused_tick, "fused_resident_tick", broken)


def _state_unchanged(packet, st, out, new):
    return out, st


def _answer_altered(packet, st, out, new):
    rows = out.placed_rows.clone()
    W = new.speed.shape[0]
    rows[0] = torch.where(rows[0] >= 0, (rows[0] + 1) % W, rows[0])
    return out._replace(placed_rows=rows), new


def _half_batch_left_out(packet, st, out, new):
    # report only the first half of the tick's placements: the rest stay
    # invalid on the device and are never dispatched
    slots = out.placed_slots.clone()
    n = int((slots >= 0).sum())
    slots[(n + 1) // 2:] = -1
    rows = torch.where(slots >= 0, out.placed_rows, -1)
    return out._replace(placed_slots=slots, placed_rows=rows), new


FAULTS = {
    "state_unchanged": _state_unchanged,
    "answer_altered": _answer_altered,
    "half_batch_left_out": _half_batch_left_out,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _wrap_tick(monkeypatch, FAULTS[fault])
    r = run_small(name, seconds=0.5)
    assert not r["verdict"].correct, r["verdict"].numbers
