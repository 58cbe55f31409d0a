"""The port's command line vs the JAX package's, on the CPU: the same
options with the same defaults and choices (plus ``--device``), the
``fit`` sub-command on the golden fixture written out as user files
(dictionary ``.mat``, NIfTI volumes, a scheme text file or bvals /
bvecs), the device contract (the card by default, no fallback), and the
import rules: the package imports no JAX, and ``--help`` imports no
torch.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from microstructure_fingerprinting_tpu import cli as jcli

from microstructure_fingerprinting_torch import cli as tcli
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.utils import io as tio
from microstructure_fingerprinting_torch.utils import nifti as tnifti
from microstructure_fingerprinting_torch.utils.scheme import b_values

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "golden_fit.npz")


def _options(parser):
    """{sub-command: {option string: what argparse does with it}}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {s: (a.dest, a.default, a.choices, a.required, a.nargs,
                       getattr(a.type, "__name__", a.type),
                       type(a).__name__)
                   for a in p._actions for s in a.option_strings}
            for name, p in sub.choices.items()}


def test_parser_matches_jax():
    """Every option of both sub-commands of the JAX command line, with
    its default, choices, arity and type; fit also has --device, 'cuda'
    by default; mask arguments convert alike."""
    want = _options(jcli._build_parser())
    got = _options(tcli._build_parser())
    dev = got["fit"].pop("--device")
    assert dev[:4] == ("device", "cuda", None, False)
    assert got == want
    for v in (None, "1", "0", "mask.nii.gz"):
        assert tcli._mask_arg(v) == jcli._mask_arg(v)


def _golden_files(tmp_path, scheme):
    """The golden fixture as a user's files: (the fixture, the fit
    sub-command's arguments up to --out, the affine)."""
    g = np.load(GOLDEN, allow_pickle=False)
    dic = {"dictionary": g["dictionary"], "sch_mat": g["sch_mat"],
           "orientation": g["orientation"],
           "num_atom": g["dictionary"].shape[1],
           "num_ear": g["DIFF_ear"].size, "fasc_propnames": ["dpar", "dperp"],
           "dpar": g["dpar"], "dperp": g["dperp"], "T2_csf": 2.0,
           "DIFF_csf": 3.0e-9, "T2_ear": 0.8, "DIFF_ear": g["DIFF_ear"]}
    path = lambda name: str(tmp_path / name)
    tio.savemat(path("dic.mat"), dic)
    aff = np.diag([2.0, 2.0, 2.5, 1.0])
    args = ["fit", "--dictionary", path("dic.mat")]
    for name, opt in (("data", "--data"), ("mask", "--mask"),
                      ("numfasc", "--numfasc"), ("peaks", "--peaks"),
                      ("csf_mask", "--csf-mask"), ("ear_mask", "--ear-mask")):
        tnifti.save(tnifti.Nifti1Image(g[name], aff), path(name + ".nii.gz"))
        args += [opt, path(name + ".nii.gz")]
    sch = g["sch_mat"]
    if scheme == "pgse_scheme":
        with open(path("scheme.txt"), "w") as f:
            f.write("VERSION: 1\n")
            np.savetxt(f, sch, fmt="%.17g")
        args += ["--pgse-scheme", path("scheme.txt")]
    else:
        np.savetxt(path("bvals"), b_values(sch)[None] / 1e6, fmt="%.17g")
        np.savetxt(path("bvecs"), sch[:, :3].T, fmt="%.17g")
        args += ["--bvals", path("bvals"), "--bvecs", path("bvecs")]
    return g, args, aff


@pytest.mark.parametrize("scheme", ["pgse_scheme", "bvals_bvecs"])
def test_cli_fit_golden(tmp_path, scheme):
    """fit --device cpu on the golden fixture's files (8-voxel chunks):
    every map written within 1e-5 x max(1, max|map|) of the fixture
    (the check of test_torch_general.py::test_golden_fit_maps), with the
    data's affine; --save-tables writes the model's tables."""
    g, args, aff = _golden_files(tmp_path, scheme)
    out = str(tmp_path / "out" / "mf.nii.gz")
    tables = str(tmp_path / "tables.npz")
    assert tcli.main(args + ["--out", out, "--device", "cpu",
                             "--batch-size", "8", "--verbose", "0",
                             "--save-tables", tables]) == 0
    for p in (str(x) for x in g["param_names"]):
        img = tnifti.load(str(tmp_path / "out" / ("mf_%s.nii.gz" % p)))
        want = g["map_" + p]
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(img.get_fdata(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=p)
        assert np.array_equal(img.affine, aff)
    saved = tinterp.MultiShellInterp.load(tables)
    built = tinterp.init_PGSE_multishell_interp(
        g["dictionary"], g["sch_mat"], g["orientation"])
    for field in ("Gms_un", "xs", "ys", "cnt"):
        assert np.array_equal(getattr(saved, field), getattr(built, field))


@pytest.mark.parametrize("case", ["no_cuda", "parallel"])
def test_cli_fit_device_contract(tmp_path, monkeypatch, case):
    """Without --device the fit runs on the card: it raises when CUDA is
    absent (no CPU fallback); --parallel with several devices in sight
    asks MFModel.fit for the device-parallel fit (a stub of the fit
    raises there, as this machine has no card)."""
    _g, args, _aff = _golden_files(tmp_path, "pgse_scheme")
    args += ["--out", str(tmp_path / "mf.nii.gz"), "--verbose", "0"]
    if case == "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(args)
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        asked = []

        def stub(self, *a, **k):
            asked.append(k)
            raise RuntimeError("several devices: stub")

        from microstructure_fingerprinting_torch.models import mf as tmf
        monkeypatch.setattr(tmf.MFModel, "fit", stub)
        with pytest.raises(RuntimeError, match="several devices"):
            tcli.main(args + ["--parallel"])
        assert len(asked) == 1 and asked[0]["parallel"] is True
    assert not (tmp_path / "mf_M0.nii.gz").exists()


_IMPORTS = ("import microstructure_fingerprinting_torch, "
            "microstructure_fingerprinting_torch.mf_utils, "
            "microstructure_fingerprinting_torch.cli")
_HELP = ("import runpy, sys\n"
         "sys.argv = ['microstructure_fingerprinting_torch', 'fit', '--help']\n"
         "try:\n"
         "    runpy.run_module('microstructure_fingerprinting_torch',\n"
         "                     run_name='__main__')\n"
         "except SystemExit as e:\n"
         "    assert e.code == 0, e.code\n")


@pytest.mark.parametrize("code,absent", [
    (_IMPORTS, ("jax", "microstructure_fingerprinting_tpu")),
    (_HELP, ("jax", "microstructure_fingerprinting_tpu", "torch",
             "matplotlib"))], ids=["package", "help"])
def test_imports(code, absent):
    """In a fresh interpreter: the package, mf_utils and the command line
    import no JAX and nothing of the JAX package; `python -m
    microstructure_fingerprinting_torch fit --help` imports no torch and
    no matplotlib either."""
    code += "\nimport sys\nprint(sorted(m for m in %r if m in sys.modules))" \
        % (absent,)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().splitlines()[-1] == "[]", run.stdout
