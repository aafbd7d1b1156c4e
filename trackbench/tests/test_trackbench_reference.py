"""The reference against the port at a tiny size on the CPU; the control
and the timed path's faults make `correct` false."""

import numpy as np
import pytest
import torch

from trackbench.tests.tiny import tiny_run


def test_the_port_equals_its_frozen_plain_copy_on_the_cpu():
    res = tiny_run()
    assert res["correct"] and res["info"]["samples"] == 2
    assert all(v["value"] == 0.0 for v in res["check"].values())


def test_the_lfnet_port_equals_its_frozen_plain_copy_on_the_cpu():
    res = tiny_run("lfnet.s8")
    assert res["correct"]
    assert all(v["value"] == 0.0 for v in res["check"].values())


@pytest.mark.parametrize("workload", ["classical.s8", "lfnet.s8"])
def test_the_control_fails_the_check(workload):
    """The reference one precision below the stated one, in the program's place."""
    res = tiny_run(workload, control=True)
    limits = {k: v["limit"] for k, v in res["check"].items()}
    failed = [k for k, v in res["control"].items() if k in limits and v > limits[k]]
    assert failed, res["control"]


def _after_warmup(fault):
    """Break the step from its fourth call on (after the tiny cell's warm-up)."""
    def wrap(step):
        calls = [0]

        def broken(state, obs, init_pose, *rest):
            calls[0] += 1
            new, out = step(state, obs, init_pose, *rest)
            return (new, out) if calls[0] <= 3 else fault(state, new, out)
        return broken
    return wrap


def _state_unchanged(state, new, out):
    return state, out


def _half_the_streams_left_out(state, new, out):
    from bundletrack_tpu_torch.geometry.se3 import se3_inverse
    from bundletrack_tpu_torch.tracker.state import _put_streams, _take_streams

    S = out.ob_in_cam.shape[0]
    rest = list(range(S // 2, S))
    new = _put_streams(new, rest, _take_streams(state, rest))
    pose = out.ob_in_cam.clone()
    pose[rest] = se3_inverse(state.prev_pose[rest])
    return new, out._replace(ob_in_cam=pose)


def _pose_altered(state, new, out):
    pose = out.ob_in_cam.clone()
    pose[0, 0, 3] += 0.002  # 2 mm where the pose is produced
    return new, out._replace(ob_in_cam=pose)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_streams_left_out, _pose_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(fault):
    res = tiny_run(fault=_after_warmup(fault))
    assert res["correct"] is False, res["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["classical.s8", "lfnet.s8"])
def test_the_cell_is_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import io
    import time

    from trackbench import harness

    res = harness.run(workload, 2**31 + 3, 3.0, False, time.perf_counter(), log=io.StringIO())
    assert res["correct"], res["check"]
    assert np.isfinite(res["metrics"]["frames_per_s"]["value"])


@pytest.mark.parametrize("shape, per_channel, round_bf16", [
    ((2, 16, 40, 40), False, True), ((3, 64, 16, 16), False, True), ((8, 512), False, True),
    ((1, 1, 68, 68), True, False), ((2, 3, 7, 9), False, False), ((4, 128, 8, 8), False, True)])
def test_the_reference_sums_equal_the_ports_plain_sums_bit_for_bit(shape, per_channel, round_bf16):
    """The reference adds on the tensor's device, the port's plain version on the host with numpy."""
    from bundletrack_tpu_torch.kernels import norm_sums as port
    from trackbench.reference.kernels import norm_sums as ref

    x = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape))) * 3
    for a, b in zip(port.xla_order_sums_reference(x, per_channel, round_bf16),
                    ref.xla_order_sums_reference(x, per_channel, round_bf16)):
        assert torch.equal(a, b)
    maps = [x.reshape(-1, 1, *x.shape[-2:])] if x.dim() == 4 else []
    for pa, pb in zip(port.xla_order_instance_stats_reference(maps), ref.xla_order_instance_stats_reference(maps)):
        assert all(torch.equal(a, b) for a, b in zip(pa, pb))


@pytest.mark.parametrize("K, P, B", [(16, 120, 1), (16, 120, 8), (2, 300, 1), (16, 1500, 2)])
def test_the_reference_block_sums_equal_the_ports_plain_sums_bit_for_bit(K, P, B):
    """The reference adds each entry's terms in a fixed order on any device (the kernel's
    and the CPU index_add_'s order), not with atomics."""
    from bundletrack_tpu_torch.kernels import normal_blocks as port
    from trackbench.reference.kernels import normal_blocks as ref

    g = torch.Generator().manual_seed(K * P + B)
    pi, pj = torch.randint(0, K, (P,), generator=g), torch.randint(0, K, (P,), generator=g)
    lead = (B, P) if B > 1 else (P,)
    blocks = [torch.randn(*lead, 6, 6, generator=g) * 100 for _ in range(3)]
    vecs = [torch.randn(*lead, 6, generator=g) for _ in range(2)]
    for a, b in zip(port.scatter_blocks_reference(K, pi, pj, *blocks, *vecs),
                    ref.scatter_blocks_reference(K, pi, pj, *blocks, *vecs)):
        assert torch.equal(a, b)
