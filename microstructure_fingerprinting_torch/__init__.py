"""Microstructure Fingerprinting in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of ``microstructure_fingerprinting_tpu`` (the JAX reference,
which this package never imports). It covers the 2-fascicle + CSF fit
path end to end, with or without the EAR compartment:

    import microstructure_fingerprinting_torch as mft
    model = mft.MFModel(dictionary)               # device="cuda"
    fit = model.fit(data, mask, numfasc, peaks=..., pgse_scheme=...,
                    csf_mask=1, ear_mask=1)
    fit.write_nifti('out.nii.gz')

Five CUDA kernels carry the scans (ops/prep.py, ops/f32scan.py,
ops/rescan.py); ``LAUNCHES`` counts their launches. Each has a plain
PyTorch twin that runs for CPU tensors.
"""

from . import config, ops, testing, utils  # noqa: F401
from .models.mf import MFModel, MFModelFit  # noqa: F401
from .ops.kernels import LAUNCHES, reset_counts  # noqa: F401

__version__ = "0.1.0"
