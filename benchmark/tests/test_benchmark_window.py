"""The window arithmetic: a rate over the whole window, the traced pass,
the idle share and the rooflines from an event list."""

import pytest

from benchmark import counts, mixes, traces
from benchmark.tests import toy


def _ctx(events, window=(0.0, 100.0), steps=2, launches=(), counters=None, kind="train"):
    return traces.TraceContext(list(events), window, steps, list(launches), counters or {},
                               1e12, 1.0, 1, kind)


def test_union_and_idle_share():
    ev = [traces.Event("a", True, 10, 30), traces.Event("b", True, 20, 40),
          traces.Event("c", True, 90, 120), traces.Event("host", False, 0, 100)]
    assert traces.union_us([(e.start_us, e.end_us) for e in ev if e.device], 0, 100) == 40
    ctx = _ctx(ev)
    assert traces.busy_s(ctx) == pytest.approx(40e-6)
    assert traces.idle_pct(ctx) == pytest.approx(60.0)
    assert traces.idle_pct(_ctx(ev[3:])) is None


def test_roofline_needs_the_counted_launches():
    ln = counts.Launch("lstm_scan", 989.4e12 * 1e-5, 0.0, "bfloat16")  # 10 us of operations
    ev = [traces.Event("void lstm_scan_tc_kernel<false, 0, 8>(ScanArgs, unsigned int*)", True, 0, 20)]
    import re
    pat = re.compile(r"\blstm_scan_tc_kernel\b")
    assert traces.roofline_pct(_ctx(ev, launches=[ln], counters={"lstm_scan": 1}), pat,
                               ("lstm_scan",)) == pytest.approx(50.0)
    # a route other than the counted one reads nothing
    assert traces.roofline_pct(_ctx(ev, launches=[ln, ln], counters={"lstm_scan": 2}), pat,
                               ("lstm_scan",)) is None
    assert traces.roofline_pct(_ctx(ev, launches=[ln], counters={"lstm_scan": 0}), pat,
                               ("lstm_scan",)) is None
    assert traces.roofline_pct(_ctx([], launches=[ln], counters={"lstm_scan": 1}), pat,
                               ("lstm_scan",)) is None


def test_other_kernels_and_breakdown():
    ev = [traces.Event("void lstm_bwd_tc_kernel<true, 8>", True, 0, 10),
          traces.Event("ampere_sgemm", True, 10, 14), traces.Event("ncclKernel_AllReduce", True, 14, 20),
          traces.Event("aten::mm", False, 30, 60), traces.Event("step", False, 0, 100)]
    ctx = _ctx(ev, steps=2)
    assert traces.other_kernels_ms(ctx) == pytest.approx(4e-3 / 2)
    bd = traces.breakdown(ctx)
    assert bd["device_ops"][0] == ["void lstm_bwd_tc_kernel<true, 8>", pytest.approx(10e-6)]
    assert bd["idle_gaps"][0] == ["step", pytest.approx(80e-6)]


def test_mfu_over_the_traced_window():
    ctx = _ctx([], kind="train")._replace(flops=989.4e12 * 0.5, seconds=2.0)
    assert traces.mfu_pct(ctx, "train") == pytest.approx(25.0)
    assert traces.mfu_pct(ctx, "decode") is None


def test_rate_is_over_the_whole_window(tmp_path):
    root = toy.make_root(str(tmp_path))
    outcome, _ = toy.run_cell(root, "toy.train", seconds=0.5)
    plans_b = 4  # the toy mix's batch
    rate = outcome.end_to_end["train_utt_s"]
    assert outcome.attempted >= 1
    # utterances of all steps over the window's seconds
    assert rate * (outcome.attempted * plans_b / rate) == pytest.approx(outcome.attempted * plans_b)
    assert rate <= outcome.attempted * plans_b / 0.5


def test_the_traced_run_holds_the_windows_first_whole_pass(tmp_path):
    root = toy.make_root(str(tmp_path))
    outcome, run = toy.run_cell(root, "toy.train", trace=True, seconds=0.5)
    cell = run.cell
    plans = mixes.plan_batches(cell.mix, cell.config)
    ctx = outcome.trace
    assert ctx.steps == len(plans) and outcome.attempted % len(plans) == 0
    lo, hi = ctx.window_us
    steps = [e for e in ctx.events if not e.device and e.name == "bench.train_step"]
    assert len(steps) == len(plans) and all(lo <= e.start_us and e.end_us <= hi for e in steps)
    # every batch once: the launches counted are those of one step of each
    want = [ln for p in plans for ln in counts.train_step_launches(
        cell.config["model"], cell.config["compute_dtype"], p.t_pad, p.l_pad, p.lx)]
    assert ctx.launches == want
    # the step's share of the peak is read over the same pass
    assert ctx.flops == sum(counts.train_step_flops(cell.config["model"], p.lx, p.ly) for p in plans)
    assert ctx.seconds == pytest.approx(traces.window_s(ctx))
