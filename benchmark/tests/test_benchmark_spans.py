"""The readers of the port's spans (``benchmark/spans.py``) on hand-built
traces: idle time split by the innermost span, launches counted inside the
optimizer, the kernel calls' host time tied to the launch counters."""

import pytest

from benchmark import harness, spans, traces

IDLE = ("listener_idle_ms.train", "speller_idle_ms.train", "optimizer_idle_ms.train",
        "step_glue_idle_ms.train", "between_steps_idle_ms.train")
READERS = IDLE + ("optimizer_launches.train", "kernel_call_host_ms.train")


def _ctx(events, window=(0.0, 100.0), steps=1, counters=None, kind="train"):
    return traces.TraceContext(list(events), window, steps, [], counters or {}, 0.0, 1.0, 1,
                               kind)


def _read(name, ctx):
    return harness.metric_reader(name)(ctx)


def _host(name, s, e):
    return traces.Event(name, False, s, e)


def _dev(s, e):
    return traces.Event("kernel", True, s, e)


def test_idle_is_split_by_self_time_of_nested_spans():
    """One idle stretch, 10-90, under a step that holds the listener (20-50),
    a kernel call inside it (30-40) and the optimizer (60-80): each part goes
    to the innermost span, the step's own time to the glue, and the device's
    own time to nobody."""
    ev = [_dev(0, 10), _dev(90, 100), _host("las.train_step", 5, 95),
          _host("las.listener", 20, 50), _host("las.launch.lstm_scan_train", 30, 40),
          _host("las.optimizer", 60, 80), _host("aten::mul", 65, 66)]
    ctx = _ctx(ev, steps=2)
    got = {name: _read(name, ctx) for name in IDLE}
    assert got == pytest.approx({"listener_idle_ms.train": 30e-3 / 2,
                                 "speller_idle_ms.train": 0.0,
                                 "optimizer_idle_ms.train": 20e-3 / 2,
                                 "step_glue_idle_ms.train": 30e-3 / 2,
                                 "between_steps_idle_ms.train": 0.0})
    total = traces.idle_pct(ctx) / 100 * traces.window_s(ctx) * 1e3 / ctx.steps
    assert sum(got.values()) == pytest.approx(total)


def test_idle_under_no_span_is_between_steps():
    ev = [_dev(0, 10), _host("las.train_step", 10, 40), _dev(40, 60),
          _host("las.train_step", 70, 90), _dev(90, 100), _host("bench.draws", 60, 70)]
    ctx = _ctx(ev, steps=2)
    assert _read("between_steps_idle_ms.train", ctx) == pytest.approx(10e-3 / 2)
    assert _read("step_glue_idle_ms.train", ctx) == pytest.approx(50e-3 / 2)
    assert sum(_read(name, ctx) for name in IDLE) == pytest.approx(60e-3 / 2)


@pytest.mark.parametrize("inner,metric", [("las.backward.speller", "speller_idle_ms.train"),
                                          ("las.launch.speller_decode_bwd",
                                           "speller_idle_ms.train"),
                                          ("las.launch.bilstm_scan_fused",
                                           "listener_idle_ms.train"),
                                          ("las.backward.listener", "listener_idle_ms.train")])
def test_spans_on_two_threads_resolve_to_the_innermost(inner, metric):
    """``las.backward`` waits on the main thread while the autograd engine's
    thread opens the adjoint's span: the shorter span takes the idle time,
    whatever thread it is on (threads are not told apart)."""
    ev = [_host("las.train_step", 0, 100), _host("las.backward", 10, 90),
          _host(inner, 20, 60), _dev(0, 10), _dev(90, 100)]
    ctx = _ctx(ev)
    assert _read(metric, ctx) == pytest.approx(40e-3)
    assert _read("step_glue_idle_ms.train", ctx) == pytest.approx(40e-3)


def test_launches_counted_inside_the_optimizer_only():
    ev = [_host("las.train_step", 0, 100), _host("las.optimizer", 50, 90),
          _host("cudaLaunchKernel", 10, 11), _host("cudaLaunchKernel", 50, 51),
          _host("cudaLaunchKernelExC", 60, 61), _host("cuLaunchKernelEx", 70, 71),
          _host("cudaMemcpyAsync", 75, 76), _host("cudaLaunchKernel", 90, 91),
          traces.Event("cudaLaunchKernel", True, 80, 81)]
    assert _read("optimizer_launches.train", _ctx(ev, steps=2)) == 1.5
    # no launch call traced at all (no card): nothing to read
    assert _read("optimizer_launches.train", _ctx(ev[:2])) is None


def test_kernel_call_host_time_needs_the_counters():
    ev = [_host("las.train_step", 0, 100), _host("las.launch.lstm_scan_train", 10, 20),
          _host("las.launch.lstm_scan_train", 15, 30), _host("las.launch.speller_decode_bwd",
                                                             60, 65), _dev(0, 100)]
    counters = {"lstm_scan_train": 2, "speller_decode_bwd": 1, "lstm_bwd": 0}
    assert _read("kernel_call_host_ms.train", _ctx(ev, steps=1, counters=counters)) == \
        pytest.approx(25e-3)
    # a counter moved without its span, or a span without its counter
    assert _read("kernel_call_host_ms.train",
                 _ctx(ev, counters={**counters, "lstm_bwd": 1})) is None
    assert _read("kernel_call_host_ms.train",
                 _ctx(ev, counters={"lstm_scan_train": 2})) is None


@pytest.mark.parametrize("name", READERS)
def test_every_reader_needs_the_step_span(name):
    """A program without the spans (only the benchmark's own), another
    entry, or no traced step: nothing is read."""
    ev = [_host("bench.train_step", 0, 100), _host("las.optimizer", 50, 90),
          _host("las.launch.lstm_scan_train", 10, 20), _host("cudaLaunchKernel", 60, 61),
          _dev(0, 10)]
    counters = {"lstm_scan_train": 1}
    assert _read(name, _ctx(ev, counters=counters)) is None
    with_step = ev + [_host("las.train_step", 0, 100)]
    assert _read(name, _ctx(with_step, counters=counters)) is not None
    assert _read(name, _ctx(with_step, counters=counters, kind="decode")) is None
    assert _read(name, _ctx(with_step, counters=counters, steps=0)) is None


def test_the_groups_cover_every_span_name():
    assert spans.group(None) == "between_steps"
    for name, want in (("las.train_step", "step_glue"), ("las.specaug", "step_glue"),
                       ("las.loss", "step_glue"), ("las.backward", "step_glue"),
                       ("las.listener", "listener"), ("las.launch.lstm_bwd_dw", "listener"),
                       ("las.speller.operands", "speller"), ("las.speller.decode", "speller"),
                       ("las.launch.speller_decode_train", "speller"),
                       ("las.optimizer", "optimizer")):
        assert spans.group(name) == want, name
