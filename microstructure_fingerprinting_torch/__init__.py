"""Microstructure Fingerprinting in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of ``microstructure_fingerprinting_tpu`` (the JAX reference,
which this package never imports), with its user surface:

    import microstructure_fingerprinting_torch as mft
    peaks, numfasc = mft.cleanup_2fascicles(frac1, frac2, 'peaks',
                                            mu1, mu2, mask)
    model = mft.MFModel(dictionary)               # device="cuda"
    fit = model.fit(data, mask, numfasc, peaks=peaks, pgse_scheme=...,
                    csf_mask=1, ear_mask=1)
    fit.write_nifti('out.nii.gz')
    mft.mf_utils  # the reference's flat namespace of utilities
    mft.mcf       # analytic matrix-formalism (MCF) simulators

and the same workflow from the shell: ``python -m
microstructure_fingerprinting_torch fit|cleanup ...`` (``cli.py``).

Five CUDA kernels carry the scans (ops/prep.py, ops/f32scan.py,
ops/rescan.py); ``LAUNCHES`` counts their launches. Each has a plain
PyTorch twin that runs for CPU tensors.

The names below are imported on first use, so that the command line's
``--help`` imports no torch.
"""

import importlib

from .tripwire import TripWire, TripWireError, is_tripwire  # noqa: F401

__version__ = "0.1.0"

_SUBMODULES = ("cli", "config", "mf_utils", "models", "ops", "parallel",
               "testing", "utils", "viz")
#: public module name -> the module
_MODULES = {"mcf": "models.mcf"}
#: public name -> the module that defines it
_NAMES = {"MFModel": "models.mf", "MFModelFit": "models.mf",
          "cleanup_2fascicles": "models.mf", "LAUNCHES": "ops.kernels",
          "reset_counts": "ops.kernels"}


def __getattr__(name):
    if name in _SUBMODULES or name in _MODULES:
        return importlib.import_module("." + _MODULES.get(name, name),
                                       __name__)
    if name in _NAMES:
        module = importlib.import_module("." + _NAMES[name], __name__)
        return getattr(module, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
