"""The port's copies of the planner, the scheduler service and the wave
materializer give plans and buffers identical to the reference's."""
import dataclasses

import numpy as np
import pytest

from repro.configs.registry import get_config as jax_config
from repro.core.planner import PlanSpec as JSpec
from repro.data.loader import WaveMaterializer as JMat
from repro.sched.service import SchedulerService as JService
from repro_torch.configs.registry import get_config
from repro_torch.core.planner import PlanSpec
from repro_torch.data.loader import WaveMaterializer
from repro_torch.sched.service import SchedulerService
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

POOLS = [
    [3000, 1800, 900, 400, 200, 120, 64, 33],
    [17, 9, 5],
    [4096, 1, 2, 3, 4000, 700],
    [250] * 12 + [3900, 7000],
]


class _Tokens:
    """A deterministic provider for both materializers."""

    def tokens(self, step, seq_id, start, end):
        return ((np.arange(start, end) * 31 + seq_id * 7 + step)
                % 1000).astype(np.int32)


def _plan_tree(plan):
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("hdp,capacity", [(1, 4096), (4, 1024), (8, 512)])
def test_plan_pool_and_materializer_identical(hdp, capacity):
    jcfg = jax_config("llama3.2-3b")
    cfg = get_config("llama3.2-3b")
    jsvc = JService(None, JSpec.for_config(jcfg, capacity=capacity, hdp=hdp,
                                           use_offload=False))
    svc = SchedulerService(None, PlanSpec.for_config(
        cfg, capacity=capacity, hdp=hdp, use_offload=False))
    jmat = JMat(_Tokens(), jcfg, capacity)
    mat = WaveMaterializer(_Tokens(), cfg, capacity)
    # successive rounds share the template registry and the load, as the
    # engine's admission rounds do
    for pool in POOLS:
        jplan, plan = jsvc.plan_pool(pool), svc.plan_pool(pool)
        assert _plan_tree(plan) == _plan_tree(jplan)
        for jw, w in zip(jplan.waves, plan.waves):
            jb, b = jmat.materialize(0, jw).batch, mat.materialize(0, w).batch
            assert sorted(b) == sorted(jb)
            for key in jb:
                np.testing.assert_array_equal(b[key], jb[key], err_msg=key)
    assert svc.templates == jsvc.templates
    np.testing.assert_array_equal(svc.load, jsvc.load)
