"""The port's examples (``microstructure_fingerprinting_torch/examples``),
each ``main`` at a tiny size on the CPU, with the gates each example
holds (exact planted atoms, R^2), and their imports."""

import os
import subprocess
import sys

import pytest
import torch

import re

from microstructure_fingerprinting_torch.examples import (
    demo_synthetic, df2_probe, ear_rsweep, exactness_check, finalize_probe,
    hoist_probe, kernel_phases, profile_stages, trials, whole_brain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def test_demo_synthetic(tmp_path, capsys):
    """The demo's 32 noisy voxels: the first fascicle's d_par exact in the
    median voxel, median R^2 above 0.999, 14 maps written."""
    out = demo_synthetic.main(["--device", "cpu", "--batch", "32",
                               "--out", str(tmp_path)])
    assert out["median_dpar_err"] == 0.0 and out["median_r2"] > 0.999
    assert len(out["files"]) == 14
    assert all(os.path.isfile(f) for f in out["files"])
    assert "median R^2" in capsys.readouterr().out


def test_exactness_check():
    """Planted atoms of a 64-atom dictionary on the 552-sequence protocol:
    fascicle ids exact with and without EAR, residuals below 1e-9
    ||y||^2."""
    out = exactness_check.main(["4", "--atoms", "64", "--device", "cpu"])
    for name in ("2fasc+CSF", "2fasc+CSF+EAR"):
        assert out[name]["ids_exact"] == 4
        assert out[name]["max_res"] < 1e-9


def test_whole_brain():
    """64 voxels of the five buckets (64 atoms, chunks of 16): both fits
    (one device, parallel=True) run, every 2-fascicle voxel's d_par
    exact, median R^2 1."""
    out = whole_brain.main(["64", "--atoms", "64", "--device", "cpu",
                            "--batch", "16"])
    assert sum(out["mix"].values()) == 64 and len(out["mix"]) == 5
    assert out["dpar_f0_exact"] == 1.0
    assert out["r2_median"] > 1 - 1e-6
    assert all(k in out for k in ("one device",
                                  "parallel=True, 1 device(s)"))


def test_profile_stages(capsys):
    """Two-voxel flagship and EAR chunks at 300 atoms (the two-pass
    scans): each reports its wall time; stages are CUDA-only."""
    out = profile_stages.main(["2", "--atoms", "300", "--reps", "1",
                               "--device", "cpu"])
    assert set(out) == {"flagship", "EAR"}
    assert all(v["wall_ms"] > 0 and v["stages_ms"] == {}
               for v in out.values())
    assert "timed on CUDA devices only" in capsys.readouterr().out


def test_ear_rsweep():
    """Two row budgets on a two-voxel EAR chunk at 300 atoms: a time and
    an overflow count each, and the larger budget overflows no more."""
    out = ear_rsweep.main(["2", "--atoms", "300", "--rows", "64", "128",
                           "--reps", "1", "--device", "cpu"])
    assert set(out) == {64, 128}
    assert all(v["ms"] > 0 and 0 <= v["overflow"] <= 2
               for v in out.values())
    assert out[128]["overflow"] <= out[64]["overflow"]


@pytest.mark.parametrize("name", ["demo_synthetic", "exactness_check",
                                  "whole_brain", "profile_stages",
                                  "ear_rsweep"])
def test_example_runs_as_module(name):
    """``python -m microstructure_fingerprinting_torch.examples.<name>
    --help`` runs, importing no JAX and nothing of the JAX package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['%s', '--help']\n"
            "try:\n"
            "    runpy.run_module('microstructure_fingerprinting_torch."
            "examples.%s', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'microstructure_fingerprinting_tpu'))))\n"
            % (name, name))
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "--device" in run.stdout
    assert run.stdout.strip().splitlines()[-1] == "[]"


def test_kernel_phases_names_every_mark(monkeypatch):
    """``kernel_phases`` (a card's measurement) names every phase mark of
    the kernels it reads (``MF_PHASE(k)`` in ``csrc/df4hoist.cu``,
    ``csrc/row4hoist.cu``, ``csrc/df2scan.cu``, ``csrc/rhsprep.cu``,
    ``csrc/row3hoist.cu``, ``csrc/finalize.cu``, and
    in ``csrc/df3hoist.cu`` and ``csrc/df2hoist.cu`` with the voxel and
    atom launches of ``csrc/hoist.cuh`` that they call, whose counter
    readers it calls: each reader's names cover its sources' marks), stops
    with a message where there is no card, and its ``--help`` imports no
    JAX."""
    csrc = os.path.join(REPO, "microstructure_fingerprinting_torch", "csrc")
    for srcs, reader in ((("df4hoist.cu",), "mf_df4hoist_phases"),
                         (("row4hoist.cu",), "mf_row4hoist_phases"),
                         (("df2scan.cu",), "mf_df2scan_phases"),
                         (("rhsprep.cu",), "mf_rhsprep_phases"),
                         (("df3hoist.cu", "hoist.cuh"), "mf_df3hoist_phases"),
                         (("df2hoist.cu", "hoist.cuh"), "mf_df2hoist_phases"),
                         (("row3hoist.cu",), "mf_row3hoist_phases"),
                         (("finalize.cu",), "mf_finalize_phases")):
        text = ""
        for src in srcs:
            with open(os.path.join(csrc, src)) as f:
                text += f.read()
        marks = {int(k) for k in re.findall(r"MF_PHASE\((\d)\)", text)}
        assert marks and max(marks) < len(kernel_phases.PHASES[reader])
        assert "MF_PHASE_API(%s)" % reader in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        kernel_phases.main([])
    code = ("import runpy, sys\n"
            "sys.argv = ['kernel_phases', '--help']\n"
            "try:\n"
            "    runpy.run_module('microstructure_fingerprinting_torch."
            "examples.kernel_phases', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'microstructure_fingerprinting_tpu'))))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "--rows" in run.stdout
    assert run.stdout.strip().splitlines()[-1] == "[]"


def test_df2_probe_cuts_apply_to_the_source(monkeypatch):
    """``df2_probe`` (a card's measurement) cuts kernel 6's shipped
    source: each cut finds the text it replaces (so an edit of
    ``csrc/df2scan.cu`` that moves it fails here, not on the card), every
    cut build still launches the kernel through ``mf_df2scan``, and the
    shipped build is the source itself; it stops with a message where
    there is no card, and its ``--help`` imports no JAX."""
    with open(os.path.join(REPO, "microstructure_fingerprinting_torch",
                           "csrc", "df2scan.cu")) as f:
        text = f.read()
    src = df2_probe.sources()
    assert list(src) == list(df2_probe.CUTS)
    for name, files in src.items():
        assert list(files) == ["df2scan.cu"]
        assert (files["df2scan.cu"] == text) == (name == "shipped"), name
        assert 'extern "C" int mf_df2scan(' in files["df2scan.cu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        df2_probe.main([])
    code = ("import runpy, sys\n"
            "sys.argv = ['df2_probe', '--help']\n"
            "try:\n"
            "    runpy.run_module('microstructure_fingerprinting_torch."
            "examples.df2_probe', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'microstructure_fingerprinting_tpu'))))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "--reps" in run.stdout
    assert run.stdout.strip().splitlines()[-1] == "[]"


def test_hoist_probe_cuts_apply_to_the_source(monkeypatch):
    """``hoist_probe`` (a card's measurement) builds kernels 9 and 10 from
    their shipped sources changed each way of its ``CUTS``: each cut finds
    the text it replaces (so an edit of ``csrc/hoist.cuh``,
    ``csrc/df2hoist.cu`` or ``csrc/df3hoist.cu`` that moves it fails here,
    not on the card), every build but the shipped one differs from the
    sources and keeps both C entry points; it stops with a message where
    there is no card, and its ``--help`` imports no JAX."""
    src = hoist_probe.sources()
    assert list(src) == list(hoist_probe.CUTS)
    for name, files in src.items():
        same = all(files[f] == src["shipped"][f] for f in files)
        assert same == (name == "shipped"), name
        assert 'extern "C" int mf_df2hoist(' in files["df2hoist.cu"]
        assert 'extern "C" int mf_df3hoist(' in files["df3hoist.cu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        hoist_probe.main([])
    code = ("import runpy, sys\n"
            "sys.argv = ['hoist_probe', '--help']\n"
            "try:\n"
            "    runpy.run_module('microstructure_fingerprinting_torch."
            "examples.hoist_probe', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'microstructure_fingerprinting_tpu'))))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "--reps" in run.stdout
    assert run.stdout.strip().splitlines()[-1] == "[]"


def test_finalize_probe_cuts_apply_to_the_source(monkeypatch):
    """``finalize_probe`` (a card's measurement) builds kernels 7 and 12
    from their shipped sources changed each way of its ``CUTS``: each cut
    finds the text it replaces (so an edit of ``csrc/finalize.cu`` or
    ``csrc/row3hoist.cu`` that moves it fails here, not on the card),
    every build but the shipped one differs from the source and keeps its
    C entry point; it stops with a message where there is no card, and its
    ``--help`` imports no JAX."""
    src = finalize_probe.sources()
    assert set(src) == {(f, name) for f, cuts in finalize_probe.CUTS.items()
                        for name in cuts}
    for (f, name), text in src.items():
        with open(os.path.join(REPO, "microstructure_fingerprinting_torch",
                               "csrc", f)) as fh:
            assert (text == fh.read()) == (name == "shipped"), name
        cname = finalize_probe.kernels._SIGNATURES[
            finalize_probe._ENTRY[f]][0]
        assert 'extern "C" int %s(' % cname in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        finalize_probe.main([])
    code = ("import runpy, sys\n"
            "sys.argv = ['finalize_probe', '--help']\n"
            "try:\n"
            "    runpy.run_module('microstructure_fingerprinting_torch."
            "examples.finalize_probe', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'microstructure_fingerprinting_tpu'))))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "--split" in run.stdout
    assert run.stdout.strip().splitlines()[-1] == "[]"


def test_trial_cuts_change_their_file_or_raise(monkeypatch, tmp_path):
    """The probes' trial builds (``examples/trials``): a swap and a span
    change only their own file, the shipped build is the sources as read,
    and a cut whose text the file no longer holds raises, naming the probe
    and the build."""
    (tmp_path / "a.cu").write_text("x = 1;\n// begin\ny = 2;\n// end\n")
    (tmp_path / "b.cuh").write_text("z = 3;\n")
    monkeypatch.setattr(trials.kernels, "_CSRC", str(tmp_path))
    cuts = {"shipped": [],
            "swap": [trials.swap("a.cu", "x = 1;", "x = 4;")],
            "span": [trials.span("a.cu", "// begin\n", "// end", "y = 5;\n")]}
    src = trials.sources("probe", ("a.cu", "b.cuh"), cuts)
    assert src["shipped"] == {"a.cu": "x = 1;\n// begin\ny = 2;\n// end\n",
                              "b.cuh": "z = 3;\n"}
    assert src["swap"]["a.cu"] == "x = 4;\n// begin\ny = 2;\n// end\n"
    assert src["span"]["a.cu"] == "x = 1;\n// begin\ny = 5;\n// end\n"
    assert src["swap"]["b.cuh"] == src["span"]["b.cuh"] == "z = 3;\n"
    with pytest.raises(RuntimeError, match="probe: b.cuh .* 'gone'"):
        trials.sources("probe", ("a.cu", "b.cuh"),
                       {"gone": [trials.swap("b.cuh", "w = 0;", "")]})
