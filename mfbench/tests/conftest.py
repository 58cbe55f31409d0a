"""Fixtures of the benchmark's tests: small cells for the CPU (the
configurations' widths cut, the port's CPU path at a small chunk), and
the card, decided when a test asks for it."""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
if ROOT not in sys.path:       # ``pytest mfbench/tests`` from the root
    sys.path.insert(0, ROOT)
#: the CPU cells' chunk: the port's plain versions evaluate every padded
#: voxel of a chunk
CPU_BATCH = 16


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def held_out():
    return load("", "held_out")


def all_workloads():
    """The benchmark's cells and the held-out ones."""
    return ([w["name"] for w in bench()["workloads"]]
            + [w["name"] for w in held_out()["workloads"]])


def load(kind, name):
    with open(os.path.join(PKG, kind, name + ".json")) as f:
        return json.load(f)


def small_cell(workload, voxels=40, atoms=300, judge_all=True):
    """``workload``'s cell cut for the CPU: a 3-shell x 16-direction + 4
    b0 scheme, ``atoms`` atoms (more than the two-pass scans' 2 R = 256
    rows, so the row passes run), ``voxels`` voxels a volume, every
    voxel judged."""
    from mfbench.run import Cell
    cell = Cell.load(workload)
    cfg, traffic = copy.deepcopy(cell.cfg), copy.deepcopy(cell.traffic)
    cfg["scheme"].update(n_shells=3, dirs_per_shell=16, n_b0=4)
    cfg["num_atom"] = atoms
    traffic["voxels"] = voxels
    if judge_all:
        traffic["judge"] = {k: voxels for k in traffic["judge"]}
    return Cell(workload, cfg, traffic, dict(cell.limits), cell.end_to_end,
                cell.per_layer)


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
