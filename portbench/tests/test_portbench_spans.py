"""The span readers: idle gaps named under the batched engine's phases
(``metrics/_spans.py``) through ``trace.summarize``."""

import pytest

from portbench import registry, trace

from portbench.tests.test_portbench_trace import _ev

READERS = ("respond_idle_share.serve", "tick_idle_share.serve",
           "turnover_idle_share.serve")


def _read(name, summary):
    return registry.metric_reader(name)({"trace": summary}, {})


def _window():
    """A 1000 us window, busy [0, 100], [200, 300], [500, 600], [900,
    1000]: gaps [100, 200] under ``multistream.respond`` (an
    ``aten::mul`` inside a decode span at its middle), [300, 500] under
    ``multistream.admit`` (no op inside), [600, 900] under no span."""
    return [_ev("user_annotation", trace.WINDOW, 0, 1000),
            _ev("kernel", "nvjet_a", 0, 100),
            _ev("kernel", "nvjet_b", 200, 100),
            _ev("kernel", "nvjet_c", 500, 100),
            _ev("kernel", "nvjet_d", 900, 100),
            _ev("user_annotation", "multistream.respond", 50, 200),
            _ev("user_annotation", "multistream.respond.decode", 120, 70),
            _ev("cpu_op", "aten::mul", 140, 20),
            _ev("user_annotation", "multistream.admit", 260, 280),
            _ev("cpu_op", "aten::cat", 650, 10)]


def test_gaps_count_for_their_phase():
    s = trace.summarize(_window())
    assert s["idle"] == {
        "multistream.respond > aten::mul": pytest.approx(100e-6),
        "multistream.admit": pytest.approx(200e-6),
        "host (no recorded op)": pytest.approx(300e-6)}
    assert _read("respond_idle_share.serve", s) == pytest.approx(10.0)
    assert _read("tick_idle_share.serve", s) == pytest.approx(20.0)
    # a trace with engine spans reads 0 for a phase with no gap under it
    assert _read("turnover_idle_share.serve", s) == 0.0
    # the gap under no span counts for none: the three stay below the
    # device's idle share
    total = sum(_read(n, s) for n in READERS)
    assert total == pytest.approx(30.0)
    assert total < registry.metric_reader("device_idle_share.serve")(
        {"trace": s}, {}) == pytest.approx(60.0)


@pytest.mark.parametrize("name,span", [
    ("respond_idle_share.serve", "multistream.respond"),
    ("tick_idle_share.serve", "multistream.ingest"),
    ("tick_idle_share.serve", "multistream.settle"),
    ("turnover_idle_share.serve", "multistream.input"),
    ("turnover_idle_share.serve", "multistream.close")])
def test_each_phase_has_one_reader(name, span):
    s = {"window_s": 1.0, "busy_s": 0.5,
         "idle": {span: 0.1, span + " > aten::empty": 0.05,
                  # a name that only begins like the span is another span
                  span + "x > aten::mul": 0.2}}
    for other in READERS:
        assert _read(other, s) == (pytest.approx(15.0) if other == name
                                   else 0.0)


def test_no_engine_span_reads_nothing():
    # the existing fixture of test_portbench_trace: its summary is as it
    # was, and a program that opens no span gives no reading
    ev = [_ev("user_annotation", trace.WINDOW, 100, 100),
          _ev("kernel", "nvjet_x", 90, 30),
          _ev("kernel", "k2_fwd_x", 110, 20),
          _ev("gpu_memcpy", "Memcpy HtoD", 150, 10),
          _ev("kernel", "decode_merge_kernel<1>", 190, 50),
          _ev("user_annotation", "step", 100, 100),
          _ev("cpu_op", "aten::_local_scalar_dense", 131, 18),
          _ev("cuda_runtime", "cudaStreamSynchronize", 135, 10)]
    s = trace.summarize(ev)
    assert s["idle"] == {"step > cudaStreamSynchronize": pytest.approx(20e-6),
                         "step": pytest.approx(30e-6)}
    assert s["gaps"] == 2
    for name in READERS:
        assert _read(name, s) is None
    assert _read(READERS[0], None) is None
