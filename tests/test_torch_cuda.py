"""Card-only tests of the port's CUDA kernel (marker ``cuda``).

They skip where no CUDA device is visible.  This file imports no JAX, so it
also runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import dqn, env
from repro_torch.core.types import fleet_cluster
from repro_torch.kernels import ops, sdqn_score as ss
from repro_torch.sched import daemon


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(n, b, device, seed):
    cfg = dataclasses.replace(fleet_cluster(n), unhealthy_prob=0.2,
                              randomize_workload=True)
    gen = torch.Generator().manual_seed(seed)
    state = env.reset(gen, cfg, device=device)
    params = dqn.init_qnet(gen, device=device)
    rng = np.random.default_rng(seed)
    pods = convert.pods_from_numpy(*(rng.uniform(10, 900, b) for _ in range(4)),
                                   device=device)
    return cfg, state, params, pods


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 1000, 5000, 131072])
@pytest.mark.parametrize("b", [1, 32])
def test_kernel_matches_plain_on_card(cuda_device, n, b):
    cfg, state, params, pods = _case(n, b, cuda_device, n + b)
    before = ss.sdqn_score_afterstate.launches
    got = ops.sdqn_score_afterstate(state, pods, cfg, params, mode="cuda")
    torch.cuda.synchronize()
    assert ss.sdqn_score_afterstate.launches == before + 1
    want = ops.sdqn_score_afterstate(state, pods, cfg, params, mode="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_propagates_nan_weights(cuda_device):
    """A diverged net must reach the daemon's NaN guard, not read as 0."""
    cfg, state, params, pods = _case(300, 4, cuda_device, 1)
    params = dict(params, b1=torch.full_like(params["b1"], float("nan")))
    q = ops.sdqn_score_afterstate(state, pods, cfg, params, mode="cuda")
    assert bool(torch.isnan(q).all())


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    cfg, state, params, pods = _case(64, 2, cuda_device, 2)
    inputs = list(ops._afterstate_inputs(state, pods, cfg, params))
    cols = list(inputs[0])
    cols[3] = cols[3].to(torch.int64)                # num_pods must be int32
    with pytest.raises(ValueError, match="num_pods"):
        ss.sdqn_score_afterstate(cols, *inputs[1:])
    cols = list(inputs[0])
    cols[0] = torch.zeros(128, device=cuda_device)[::2]   # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ss.sdqn_score_afterstate(cols, *inputs[1:])


@pytest.mark.cuda
def test_daemon_batch_is_one_kernel_launch(cuda_device):
    cfg = fleet_cluster(5000)
    gen = torch.Generator().manual_seed(0)
    d = daemon.PlacementDaemon(
        daemon.ClusterSubstrate(env.reset(gen, cfg, device=cuda_device), cfg,
                                device=cuda_device),
        dqn.init_qnet(gen, device=cuda_device),
        daemon.DaemonConfig(batch_size=32, max_wait_s=1e9))
    d.warmup()
    before = ss.sdqn_score_afterstate.launches
    for _ in range(70):
        d.submit(env.default_pod(cfg))
    d.drain()
    m = d.metrics
    # identical pods collide on one node and re-queue, so batches > 3
    assert m.bound + m.dropped == m.submitted == 70
    assert m.device_launches == m.batches >= 3
    assert ss.sdqn_score_afterstate.launches - before == m.device_launches
