"""Framework configuration and the device / precision policy.

``SolverConfig`` and ``FitConfig`` hold the fields of the JAX package's
dataclasses (``microstructure_fingerprinting_tpu/config.py``) that the
ported buckets read, with the same defaults; the other knobs
come with the code that reads them. The re-scan's 8 segments per column
block are ``ops/rescan._SEGMENTS``, and the general path's tile and
tolerances are module constants of ``ops/nnls.py``, as they are in the
JAX package. The fit's voxel chunk is ``MFModel.fit(batch_size=)``,
which defaults to 512 on the fast path (as on the JAX package's
one-device path) and to ``FitConfig.batch`` on the general path.

The policy below is set once, when the package is imported:

  * production arithmetic is float32 (``DTYPE``);
  * TF32 is off for every matmul and convolution — the rotation is a
    lerp-weight matmul that the JAX package runs at Precision.HIGHEST,
    and TF32 would keep only ~3 decimal digits of it;
  * ``MFModel`` takes ``device="cuda"`` by default and raises when CUDA
    is absent; the CPU runs only when a caller asks for it.
"""

import dataclasses

import torch

DTYPE = torch.float32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device):
    """torch.device for ``device``; raises when CUDA is asked for and
    absent (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %r requested but CUDA is not available; "
                           "pass device='cpu' to run on the CPU" % (device,))
    return dev


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Exhaustive-NNLS solver knobs.

    The EAR bucket always takes its two-pass scan (at ``twopass_rows_ear``)
    when the dictionary has more than ``2 * twopass_rows`` atoms, on every
    device: that is the JAX package's TPU production choice. Its
    ``twopass_ear_mode`` knob, which chooses between that and a one-pass
    scan per backend, is not carried."""
    # two-pass scan row budgets: the f32 interval row pass bounds hold the
    # winner's row inside the top-R in-band rows; R covers the measured
    # band tails with <1% overflow for the 2-fascicle+CSF grid and a few %
    # for the EAR grid, whose ear-dominant voxels tie more rows
    twopass_rows: int = 128
    twopass_rows_ear: int = 256


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """MFModel.fit defaults."""
    max_fasc: int = 2              # max fascicles per voxel
    max_prog_lines: int = 100      # progress-print budget
    dft_disp_itvl: int = 5         # default progress interval
    gtol: float = 1e-3             # bval->G snapping tolerance [T/m]
    batch: int = 128               # general-path voxel chunk


DEFAULTS = {
    "solver": SolverConfig(),
    "fit": FitConfig(),
}
