"""The result line: exactly the contract's keys, the numbers compared
beside their limits last; no result without a card; the trace's
arithmetic on a made-up trace."""

import io
import json

import pytest

from conftest import CPU_BATCH, small_cell
from mfbench import run, trace

TOP = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def brain_runs():
    cell = small_cell("brain_mix", voxels=20, judge_all=False)
    cell.traffic["judge"] = {k: 3 for k in cell.traffic["judge"]}
    return cell, [run.run_cell(cell, 2 ** 31 + 5, 0.0, t, device="cpu",
                               fit_kw={"batch_size": CPU_BATCH},
                               log=io.StringIO()) for t in (0, 1)]


def test_untraced_line(brain_runs):
    cell, ((res, rows), _traced) = brain_runs
    assert list(res) == TOP + ["checks"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 20
    assert [r[0] for r in rows] == list(res["checks"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_line(brain_runs):
    cell, (_plain, (res, _rows)) = brain_runs
    assert list(res) == TOP + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    names = {m["name"] for m in cell.per_layer}
    # the CPU has no device trace: only the host's and the counters'
    assert set(res["metrics"]) <= names
    assert "host_dispatch_s" in res["metrics"]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for extra in (["--seconds", "1", "--trace", "0"], ["--control"]):
        assert run.main(["--workload", "wm_crossing_xla", "--seed", "1"]
                        + extra) != 0
    assert capsys.readouterr().out == ""


def _events():
    ann = {"name": trace.RANGE, "cat": "user_annotation", "ts": 100,
           "dur": 100}
    k = lambda name, ts, dur, cat="kernel": {"name": name, "cat": cat,
                                             "ts": ts, "dur": dur}
    host = {"name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 150,
            "dur": 30}
    return [ann, host,
            k("void rowmin3_kernel<1>(float const*)", 90, 20),   # clipped
            k("elementwise_kernel", 105, 10),
            k("Memcpy HtoD", 140, 10, "gpu_memcpy"),
            k("finalize_kernel(int)", 190, 30)]                  # clipped


def test_trace_arithmetic():
    tr = trace.Trace(_events())
    assert tr.window == (100.0, 200.0) and tr.window_s == 1e-4
    assert tr.busy_intervals() == [[100.0, 115.0], [140.0, 150.0],
                                   [190.0, 200.0]]
    assert tr.busy_s() == pytest.approx(35e-6)
    assert tr.gaps() == [(115.0, 140.0), (150.0, 190.0)]
    b = tr.breakdown()
    assert b["idle_gaps"][0] == ["cudaGraphLaunch", pytest.approx(40e-6)]
    assert b["idle_gaps"][1][0] == "python"
    assert [n for n, _ in b["device_ops"]][0] == "finalize_kernel"
    assert trace.port_kernel("void rowmin3_kernel<1>(float const*)") == \
        "rowmin3_kernel"
    assert trace.port_kernel("elementwise_kernel") is None


def test_glue_and_roofline_readers():
    cell = small_cell("brain_mix")
    ctx = run.Context(cell, 512)
    ctx.trace = trace.Trace(_events())
    glue = run.reader("glue_busy_share")(ctx)
    assert glue == pytest.approx(100 * 10 / 60)
    idle = run.reader("device_idle_share")(ctx)
    assert idle == pytest.approx(65.0)
    assert ctx.kernel_roofline("rowmin3_kernel", 0.001) == pytest.approx(5.0)
    assert ctx.kernel_roofline("rowmin4_kernel", 0.001) is None
