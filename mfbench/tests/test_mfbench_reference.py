"""The plain reference: its rotation is the port's float64 rotation, its
exhaustive NNLS is scipy's NNLS over every combination, and the port's
CPU path agrees with it on a small volume of every bucket the cells run,
so that a disagreement on the card is the port's, not the yardstick's."""

import io
import itertools

import numpy as np
import pytest
import torch

from conftest import CPU_BATCH, all_workloads, load, small_cell
from mfbench import dictionary, reference, run


def test_rotation_is_the_ports():
    from microstructure_fingerprinting_torch.ops import interp as mfi
    cfg = load("configs", "dense552_2fasc_csf_ear10")
    sch, dic = dictionary.build(cfg)
    rng = np.random.RandomState(3)
    dirs = rng.randn(6, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[0] = [0.0, 0.0, 1.0]                       # along the dictionary
    ms = mfi.init_PGSE_multishell_interp(dic["dictionary"], sch,
                                         dic["orientation"])
    plan = mfi.plan_target_scheme(ms, sch)
    xs, ys, cnt = ms.device_tables("cpu", torch.float64)
    t = lambda a: torch.as_tensor(a)
    port = mfi.eval_rotation_batch(xs, ys, cnt, t(plan.gdir),
                                   t(plan.shell_lo), t(plan.shell_hi),
                                   t(plan.wG), t(dirs)[:, None])[:, 0]
    ref = reference.Rotation(dic["dictionary"], sch, dic["orientation"],
                             "cpu")(dirs)
    scale = float(ref.abs().max())
    assert float((port - ref).abs().max()) <= 1e-12 * scale
    # along the dictionary's own direction the rotation is the dictionary
    np.testing.assert_allclose(ref[0].numpy(), dic["dictionary"],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("sizes", [[5], [4, 1], [4, 3], [4, 3, 1],
                                   [3, 4, 1, 3]])
def test_exhaustive_is_scipy_nnls(sizes):
    from scipy.optimize import nnls
    rng = np.random.RandomState(len(sizes))
    S, B = 24, 3
    blocks = [np.abs(rng.randn(B, S, n)) + 0.1 for n in sizes]
    # correlated columns, as a fingerprint dictionary's are
    blocks[0] = blocks[0] + 3.0 * blocks[0][:, :, :1]
    truth = rng.rand(B, len(sizes)) + 0.2
    y = sum(truth[:, k, None] * blocks[k][:, :, 0]
            for k in range(len(sizes))) + 0.05 * rng.randn(B, S)
    got = reference.best_objective(torch.as_tensor(y),
                                   [torch.as_tensor(b) for b in blocks],
                                   max_elems=16)
    for v in range(B):
        best = min(nnls(np.stack([blocks[k][v, :, i] for k, i in
                                  enumerate(combo)], axis=1), y[v])[1] ** 2
                   for combo in itertools.product(*map(range, sizes)))
        assert float(got[v]) == pytest.approx(best, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("workload", all_workloads())
def test_port_cpu_path_agrees(workload):
    """The port's CPU path (its plain versions of every kernel, or the
    general path where the cell's mix asks for it) on a small volume of
    each bucket of the cell, every voxel judged: the claimed
    atoms and weights are the reference's optimum to rounding, and the
    reported MSE and R^2 are what they give, to the float32 rotation's
    rounding."""
    cell = small_cell(workload, voxels=30)
    cell.limits = {"obj_gap": 1e-12, "mse_gap": 1e-7,
                          "r2_gap": 1e-7, "invalid": 0}
    log = io.StringIO()
    res, rows = run.run_cell(cell, 41, 0.0, 0, device="cpu",
                             fit_kw={"batch_size": CPU_BATCH}, log=log)
    assert res["correct"], (rows, log.getvalue())
    judged = [line.split()[2] for line in log.getvalue().splitlines()
              if line.startswith("mfbench: bucket ")]
    assert sorted(judged) == sorted(k for k, n in
                                    run.generator.bucket_counts(
                                        cell.traffic).items() if n)
