"""The plain references against the port at toy widths on the CPU, in
float32 with dense attention and one rank: the same losses, first
gradients and changes to rounding, with remat on and off. Then the trace
arithmetic on a schedule whose answer is known."""

import types

import pytest

import portbench_tiny as tiny
from portbench import readers, trace, yardstick

# float32 on both sides, the same operations in another order (batch
# norm over 4 images of 32 px is ill-conditioned enough to reach 1e-4;
# the toy cell runs 8 of 64 px)
AGREE = 1e-5


@pytest.mark.parametrize("remat", [True, False])
def test_lm_reference_matches_the_port(tmp_path, remat):
    cell = tiny.tiny_cell(str(tmp_path), tiny.LM, remat=remat)
    record = tiny.run_tiny(cell)
    from portbench import judge

    nums = judge.numbers(record["program"], record["reference"])
    assert all(v["value"] < AGREE for v in nums.values()), nums


def test_resnet_reference_matches_the_port(tmp_path):
    cell = tiny.tiny_cell(str(tmp_path), tiny.RN)
    record = tiny.run_tiny(cell)
    from portbench import judge

    nums = judge.numbers(record["program"], record["reference"])
    assert all(v["value"] < AGREE for v in nums.values()), nums


def _event(name, start_us, dur_us, cuda):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: int(start_us * 1e3),
        duration_ns=lambda: int(dur_us * 1e3),
        device_type=lambda: DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=lambda: name.startswith("portbench."))


def _schedule():
    """A 1000 us window: kernels at 100-300 (gemm), 250-400 (nccl,
    overlapping it by 50), 600-700 (nccl alone), 900-950 (flash fwd);
    the host in aten::mm over 280-650 during the backward phase."""
    return [
        _event("portbench.window", 0, 1000, False),
        _event("portbench.backward", 0, 800, False),
        _event("aten::mm", 280, 370, False),
        _event("nvjet_tst_gemm", 100, 200, True),
        _event("ncclDevKernel_AllReduce", 250, 150, True),
        _event("ncclDevKernel_AllReduce", 600, 100, True),
        _event("fwd_wgmma_kernel<128>", 900, 50, True),
    ]


def test_trace_summary_on_a_known_schedule():
    s = trace.summarize(_schedule())
    assert s["window_s"] == pytest.approx(1e-3)
    # busy: 100-400, 600-700, 900-950
    assert s["busy_s"] == pytest.approx(450e-6)
    gaps = dict(s["idle_gaps"])
    # 0-100 and 400-600 end inside aten::mm or before it; 700-900 and
    # 950-1000 end outside it
    assert gaps["backward:aten::mm"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(550e-6)
    s["steps"] = 1
    run = readers.Run(types.SimpleNamespace(
        config={"n_embd": 2048, "n_head": 16, "dtype": "bfloat16"},
        traffic={"batch": 16, "seq_len": 2048}, chips=1),
        {}, [{"trace": s}])
    assert readers.idle_share(run) == pytest.approx(55.0)
    # nccl alone: 300-400 and 600-700
    assert readers.exposed_ms(run, "nccl") == pytest.approx(0.2)
    assert readers.family_ms(run, ["matmul"]) == pytest.approx(0.2)
    bound = readers.flash_bounds(run)["flash_fwd"]
    assert readers.roofline(run, ["flash_fwd"], bound) == pytest.approx(
        100 * bound / 0.05)
    assert readers.family_ms(run, ["batch_norm"]) is None


def test_host_issue_leaves_out_the_waits():
    """Two steps of 300 us on the host; the second waits 120 us on a full
    launch queue and 30 us in a synchronise, overlapping by 10: the host's
    own cost is 300 and 160 us."""
    events = [
        _event("portbench.window", 0, 1000, False),
        _event("portbench.forward", 0, 100, False),
        _event("portbench.backward", 100, 150, False),
        _event("portbench.opt_step", 250, 50, False),
        _event("portbench.forward", 400, 100, False),
        _event("portbench.backward", 500, 150, False),
        _event("Command Buffer Full", 520, 120, False),
        _event("portbench.opt_step", 650, 50, False),
        _event("cudaStreamSynchronize", 630, 30, False),
        _event("cudaLaunchKernel", 660, 5, False),
        _event("nvjet_tst_gemm", 100, 800, True),
    ]
    s = trace.summarize(events)
    assert s["host_steps"] == [pytest.approx([300e-6, 0.0]),
                               pytest.approx([300e-6, 140e-6])]
    run = readers.Run(None, {}, [{"trace": s}])
    assert readers.host_issue_ms(run) == pytest.approx(0.23)


def test_uncovered():
    spans = trace.union([(0, 10), (5, 12), (20, 30)])
    cover = trace.union([(2, 4), (8, 22), (25, 26)])
    # uncovered: 0-2, 4-8, 22-25, 26-30
    assert trace.uncovered(spans, cover) == pytest.approx(13)
    assert yardstick.family("ncclDevKernel_AllReduce_Sum") == "nccl"
    assert yardstick.family("void dq_rows_wgmma_kernel<128>") == \
        "flash_bwd_dq"
