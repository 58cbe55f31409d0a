"""BENCHMARK.json against the benchmark's contract, and the harness found
by names: a configuration, a traffic mix and a metric added as files
are run without an edit of any file that is there."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import PKG, ROOT, all_workloads, held_out

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["mfbench"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("mfbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(PKG, "traffic",
                                           w["traffic"] + ".json"))
    assert configs == {w["config"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(PKG, "metrics",
                                           m["name"] + ".py"))
        if m["name"].startswith("roofline."):
            assert m["unit"] == "%"
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_command_names_only_the_benchmark():
    b = bench()
    assert len(b["command"]) <= 32
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word


def test_held_out_cells_are_whole():
    """``held_out.json``: cells kept out of the benchmark, each with its
    configuration, traffic mix, limits and per-layer readers, none of
    them a cell of the benchmark, so that putting one back is an entry
    of BENCHMARK.json."""
    held, b = held_out(), bench()
    assert set(held) == {"why", "configs", "workloads", "per_layer"}
    names = {w["name"] for w in held["workloads"]}
    assert not names & {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in held["configs"] + b["configs"]}
    for c in held["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in held["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and len(w["why"]) <= 200
        for kind, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(PKG, kind, name + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in held["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= names
        assert os.path.exists(os.path.join(PKG, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("workload", all_workloads())
def test_limits_of_every_cell(workload):
    """Each cell's limits file holds every number compared to a limit;
    ``invalid`` is exact."""
    from mfbench import judge
    with open(os.path.join(PKG, "limits", workload + ".json")) as f:
        limits = json.load(f)
    assert set(limits) == set(judge.NUMBERS) and limits["invalid"] == 0
    held = [v for v in limits.values() if v is not None]
    assert all(isinstance(v, (int, float)) and v >= 0 for v in held)
    assert len(held) == len(limits)


ADDED = {
    "configs/tiny_new.json": None,    # filled from an existing file
    "traffic/tiny_mix.json": {
        "voxels": 24, "mix": [{"K": 2, "csf": 1, "ear": 0, "share": 0.5},
                              {"K": 1, "csf": 1, "ear": 0, "share": 0.5}],
        "weights": [0.3, 1.3], "scale": 400.0, "snr_b0": 50.0,
        "judge": {"2,1,0": 4, "1,1,0": 4}},
    "limits/tiny_cell.json": {"obj_gap": 1e-7, "mse_gap": 2e-8,
                              "r2_gap": 3e-8, "invalid": 0},
    "metrics/fits_in_window.py": (
        '"""Fits completed in the window."""\n\n\n'
        'def read(ctx):\n    return len(ctx.fits)\n'),
}


def test_new_files_are_found_without_edits(tmp_path):
    """A copy of the benchmark with a configuration, a traffic mix, a
    cell's limits and a per-layer metric added as files and entries of
    BENCHMARK.json: the cell loads, its volumes are made and its metric
    is read."""
    shutil.copytree(PKG, tmp_path / "mfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (tmp_path / "mfbench" / p).read_bytes()
              for p in os.listdir(tmp_path / "mfbench")
              if p.endswith(".py")}
    with open(os.path.join(PKG, "configs", "dense552_2fasc_csf.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_new", num_atom=40)
    cfg["scheme"].update(n_shells=2, dirs_per_shell=8, n_b0=2)
    ADDED["configs/tiny_new.json"] = cfg
    for rel, body in ADDED.items():
        text = body if isinstance(body, str) else json.dumps(body)
        (tmp_path / "mfbench" / rel).write_text(text)
    b = bench()
    b["configs"].append({"name": "tiny_new", "source": "a test",
                         "file": "mfbench/configs/tiny_new.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny_cell", "config": "tiny_new",
                           "traffic": "tiny_mix", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "fits_in_window", "unit": "fits",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "voxels_per_s",
                           "workloads": ["tiny_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    probe = (
        "import json\n"
        "from mfbench import generator, run\n"
        "cell = run.Cell.load('tiny_cell')\n"
        "vols = generator.volumes(cell.cfg, cell.traffic, 5, 'cpu')\n"
        "ctx = run.Context(cell, 16)\n"
        "ctx.fits = [{}, {}]\n"
        "print(json.dumps({'file': run.__file__,\n"
        "    'buckets': generator.bucket_counts(cell.traffic),\n"
        "    'shape': list(vols[0]['data'].shape),\n"
        "    'metrics': [m['name'] for m in cell.per_layer],\n"
        "    'limits': cell.limits,\n"
        "    'read': run.reader('fits_in_window')(ctx)}))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["buckets"] == {"2,1,0": 12, "1,1,0": 12}
    assert got["shape"] == [24, 1, 1, 2 + 2 * 8]
    assert "fits_in_window" in got["metrics"] and got["read"] == 2
    assert got["limits"] == ADDED["limits/tiny_cell.json"]
    after = {p: (tmp_path / "mfbench" / p).read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("workload", all_workloads())
def test_each_cell_reports_its_metrics(workload):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric, each with a reader."""
    from mfbench.run import Cell, reader
    cell = Cell.load(workload)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]))
