"""The traffic generator: the same seed gives the same volumes, other
seeds and the cell's second volume differ, and every mix holds the
bucket counts it states."""

import json
import os

import numpy as np
import pytest

from conftest import PKG, load
from mfbench import generator

TRAFFIC = sorted(f[:-5] for f in os.listdir(os.path.join(PKG, "traffic"))
                 if f.endswith(".json"))


def small(traffic_name, voxels=300):
    t = load("traffic", traffic_name)
    t["voxels"] = voxels
    return t


def test_brain_mix_counts():
    assert generator.bucket_counts(load("traffic", "brain_mix")) == {
        "2,1,0": 62000, "2,1,1": 10000, "1,1,0": 16000, "2,0,0": 7000,
        "0,1,0": 5000}
    assert generator.bucket_counts(load("traffic", "wm_crossing")) == {
        "2,1,0": 32768}
    assert generator.bucket_counts(load("traffic", "ear_wm")) == {
        "2,1,1": 16384}
    assert generator.bucket_counts(load("traffic", "wm_crossing_xla")) == {
        "2,1,0": 16384}


@pytest.mark.parametrize("name", TRAFFIC)
def test_every_mix_names_its_source(name):
    """A mix says where its shares and levels come from, and its ``fit``
    keywords, if any, are ``MFModel.fit``'s."""
    import inspect
    from microstructure_fingerprinting_torch import MFModel
    t = load("traffic", name)
    assert 1 <= len(t["source"]) <= 400
    params = inspect.signature(MFModel.fit).parameters
    assert set(t.get("fit", {})) <= set(params)


@pytest.mark.parametrize("name", TRAFFIC)
def test_counts_add_up(name):
    t = load("traffic", name)
    counts = generator.bucket_counts(t)
    assert sum(counts.values()) == t["voxels"]
    assert set(t["judge"]) <= set(counts)


def _cfg_for(name):
    needs_ear = any(b["ear"] for b in load("traffic", name)["mix"])
    return load("configs", "dense552_2fasc_csf_ear10" if needs_ear
                else "dense552_2fasc_csf")


@pytest.mark.parametrize("name", TRAFFIC)
def test_repeats_per_seed(name):
    cfg, t = _cfg_for(name), small(name)
    seed = 2 ** 31 + 977
    a = generator.volumes(cfg, t, seed, "cpu")
    b = generator.volumes(cfg, t, seed, "cpu")
    c = generator.volumes(cfg, t, seed + 1, "cpu")
    assert len(a) == generator.VOLUMES == 2
    for va, vb in zip(a, b):
        for k in va:
            if va[k] is not None:
                np.testing.assert_array_equal(va[k], vb[k])
    assert not np.array_equal(a[0]["data"], c[0]["data"])
    assert not np.array_equal(a[0]["data"], a[1]["data"])
    counts = generator.bucket_counts(t)
    for v in a:
        got = {}
        for row in v["bucket"]:
            key = generator.bucket_key(*row)
            got[key] = got.get(key, 0) + 1
        assert got == counts
        assert np.all(np.isfinite(v["data"])) and np.all(v["data"] > 0)
        K = v["numfasc"].reshape(-1)
        np.testing.assert_array_equal(K, v["bucket"][:, 0])
        pk = v["peaks"].reshape(-1, 2, 3)
        norms = np.linalg.norm(pk, axis=2)
        np.testing.assert_allclose(norms, (np.arange(2) < K[:, None]) * 1.0,
                                   atol=1e-12)


def test_noise_level():
    """Rician noise at the stated SNR: the b0 rows of a voxel spread by
    about its b0 signal over snr_b0."""
    cfg, t = _cfg_for("wm_crossing"), small("wm_crossing", 2000)
    v = generator.volumes(cfg, t, 11, "cpu")[0]
    n_b0 = cfg["scheme"]["n_b0"]
    b0 = v["data"].reshape(-1, v["data"].shape[-1])[:, :n_b0]
    snr = np.median(b0.mean(axis=1) / b0.std(axis=1, ddof=1))
    assert abs(snr / t["snr_b0"] - 1) < 0.1
