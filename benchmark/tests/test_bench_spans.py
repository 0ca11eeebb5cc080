"""The program's spans in the trace's arithmetic: trace.summarize charges a
gap to the innermost program span open at its start, and the span readers
(step_device_ms, step_idle_ms, encode_device_ms) and benchmark/spans.py's
lead, share and MIRAGE report read hand-computed values from synthetic
rows; the spans tool runs a tiny MIRAGE cell on the CPU."""
from __future__ import annotations

import pytest

from benchmark.harness import Run, reader
from benchmark.spans import encode_leads_ms, measure, mirage_report, program_share
from benchmark.tests import tiny
from benchmark.trace import summarize

MS = 1_000_000


def _k(name, s, e):
    return (name, True, s * MS, e * MS, False)


# the card: encode's conv 1-3 ms; step 0's stacks 10-20 and 22-30 ms with a
# gap inside stack_001 (20-22); step 1's 42-50 after a gap in step 0's own
# update (30-42); the copy to the host 60-61 after the decode's last host work
EVENTS = [_k("cudnn_conv_fprop", 1, 3), _k("gn_apply_kernel", 10, 20),
          _k("cudnn_conv_fprop", 22, 30), _k("elementwise_kernel", 42, 50),
          ("Memcpy DtoH", True, 60 * MS, 61 * MS, False)]
HARNESS = [("encode", 0, 5 * MS), ("decode", 8 * MS, 62 * MS)]


def _row(i, name, t0, t1, parent=None, device_ms=None, step=None):
    return {"id": i, "name": name, "parent": parent, "t0_ns": t0 * MS, "t1_ns": t1 * MS,
            "requests": [], "step": step, "device_ms": device_ms}


ROWS = [_row(1, "dvae.encode", 0.5, 4, device_ms=2.5),
        _row(2, "dvae.decode", 9, 59),
        _row(3, "vddim.step", 9.5, 31, 2, device_ms=21.0, step=0),
        _row(4, "unet.stack_000", 9.6, 19, 3),
        _row(5, "unet.stack_001", 19, 21, 3),
        _row(6, "vddim.step", 31, 45, 2, device_ms=19.0, step=1),
        _row(7, "unet.stack_000", 31.5, 33, 6)]


def _summary():
    return summarize(EVENTS, HARNESS + [(r["name"], r["t0_ns"], r["t1_ns"]) for r in ROWS])


def test_a_gap_goes_to_the_innermost_program_span():
    idle = _summary()["idle_by_host"]
    assert idle["unet.stack_001/convolution"] == pytest.approx(0.002)      # 20-22 ms
    assert idle["vddim.step/elementwise_and_glue"] == pytest.approx(0.012)  # 30-42: step 0
    assert idle["dvae.decode/Memcpy"] == pytest.approx(0.010)               # 50-60
    assert idle["dvae.encode/k1_groupnorm_apply"] == pytest.approx(0.007)   # 3-10
    assert sum(idle.values()) == pytest.approx(0.031)
    without = summarize(EVENTS, HARNESS)["idle_by_host"]
    assert set(without) == {"encode/k1_groupnorm_apply", "decode/convolution",
                            "decode/elementwise_and_glue", "decode/Memcpy"}


def test_the_span_readers_on_a_synthetic_run():
    run = Run(summary=_summary(), program_spans=ROWS)
    assert reader("step_device_ms.destructo")(run) == pytest.approx(20.0)
    assert reader("step_idle_ms.destructo")(run) == pytest.approx(1e3 * 0.014 / 2)
    assert reader("encode_device_ms.destructo")(run) == pytest.approx(2.5)


def test_the_span_readers_are_silent_without_program_spans():
    for run in (Run(summary=_summary()), Run(summary=_summary(), program_spans=[])):
        for name in ("step_device_ms", "step_idle_ms", "encode_device_ms"):
            assert reader(f"{name}.destructo")(run) is None


def test_the_encode_lead_and_the_share_inside_decode():
    assert encode_leads_ms(EVENTS, ROWS) == [pytest.approx(0.5)]
    assert program_share(_summary()["idle_by_host"]) == pytest.approx(1.0)
    assert program_share(summarize(EVENTS, HARNESS)["idle_by_host"]) == 0.0
    assert program_share({}) is None


def test_the_mirage_report_on_synthetic_rows():
    rows = [_row(1, "serve.request", 0, 900), _row(2, "serve.queue", 1, 51),
            _row(3, "serve.batch", 52, 880, device_ms=820.0),
            _row(4, "clapdae.generate", 53, 879, 3, device_ms=810.0),
            _row(5, "clapdae.inner", 53, 400, 4, device_ms=500.0),
            _row(6, "kdiff.step", 53, 60, 5, device_ms=9.0, step=0),
            _row(7, "kdiff.step", 60, 64, 5, device_ms=11.0, step=1),
            _row(8, "clapdae.outer", 400, 800, 4, device_ms=250.0),
            _row(9, "clapdae.ae_decode", 800, 870, 4, device_ms=50.0),
            _row(10, "serve.wav", 881, 884, 1)]
    generates = [(1.0, 1.9, 1, {"inner_s": 0.5, "outer_s": 0.25, "decode_s": 0.05}, {})]
    rep = mirage_report(rows, generates, 0.05)
    assert rep["queue_ms"] == [pytest.approx(50.0)] and rep["queue_wait_s"] == 0.05
    assert rep["request_s"] == [pytest.approx(0.9)] and rep["wav_ms"] == [pytest.approx(3.0)]
    assert rep["batch_device_s"] == [pytest.approx(0.82)]
    assert rep["generate_device_s"] == [pytest.approx(0.81)]
    assert rep["stage_device_s"] == {"clapdae.inner": pytest.approx(0.5),
                                     "clapdae.outer": pytest.approx(0.25),
                                     "clapdae.ae_decode": pytest.approx(0.05)}
    (gen,) = rep["generates"]
    assert gen["wall_s"] == pytest.approx(0.9)
    assert gen["stages_over_wall"] == pytest.approx(0.8 / 0.9)
    assert rep["step_ms"]["kdiff.step"] == {"n": 2, "host_median": pytest.approx(5.5),
                                            "device_median": 10.0}
    assert rep["step_ms"]["vddim.step"] == {"n": 0, "host_median": None,
                                            "device_median": None}


def test_the_spans_tool_runs_a_tiny_mirage_cell():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = measure("mirage_serve_c4", 2**31 + 77, 1, 1, device="cpu", config=tiny.mirage(),
                    mix=tiny.mirage_mix(4))
    finally:
        torch.set_num_threads(threads)
    rep = r["mirage"]
    assert r["correct"] and not r["failed"]
    assert len(rep["queue_ms"]) == len(rep["request_s"]) == len(rep["wav_ms"]) == 4
    assert rep["queue_wait_s"] == pytest.approx(1e-3 * sum(rep["queue_ms"]))
    (gen,) = rep["generates"]
    assert gen["rows"] == 4 and set(gen["stage_times"]) == {"inner_s", "outer_s", "decode_s"}
    assert 0 < gen["stages_over_wall"] <= 1
    assert rep["step_ms"]["kdiff.step"]["n"] == tiny.mirage_mix(4)["request"]["steps"]
    assert r["metrics"]["coalesced_per_run"] == 4.0
    assert [w["on"] for w in r["windows"]] == [False, True]
