"""SimFleet in the PyTorch port against the JAX reference: the same seed
drives the same fleet through the batch tick in both packages, so the
completed and lost counts, the tick count and the makespan must be equal."""

import numpy as np
import pytest

from tpu_faas.sim import SimFleet as JFleet
from tpu_faas_torch.sim import SimFleet as TFleet


def _run(cls, seed, churn, **kw):
    rng = np.random.default_rng(seed)
    fleet = cls(n_workers=32, max_pending=256, rng=rng, hetero=True,
                time_to_expire=1.0, **kw)
    sizes = rng.uniform(0.5, 3.0, 300).astype(np.float32)
    return fleet.run(sizes, dt=0.5, churn=churn, max_ticks=2000)


@pytest.mark.parametrize("churn", [0.0, 0.05])
def test_sim_fleet_matches_jax(churn):
    want = _run(JFleet, 2, churn)
    got = _run(TFleet, 2, churn, device="cpu")
    assert (got.completed, got.lost, got.ticks, got.makespan) == (
        want.completed, want.lost, want.ticks, want.makespan)
    assert got.lost == 0 and got.completed == 300


@pytest.mark.parametrize("churn", [0.01, 0.05])
def test_sim_churn_no_lost_tasks(churn):
    res = _run(TFleet, 3, churn, device="cpu")
    assert res.lost == 0 and res.completed == 300
    assert len(res.tick_seconds) == res.ticks
