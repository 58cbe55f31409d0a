"""DW-MRI synthesis from stored Monte-Carlo spin phases.

Counterpart of ``microstructure_fingerprinting_tpu/ops/mc.py``:
  - ``monte_carlo_average``  reference mf_utils.py:2758-2810
  - ``get_PGSE_from_phases`` reference mf_utils.py:2813-3015

Per sequence i, S_i = mean_l cos(Dscaling * sum_n gscaling[i, n]
* phi[l, map(i), n]): a gather of the mapped reference phase block, a
contraction with the gradient scaling over the axes and a sum of
cosines over the spins, in torch on the device (the card unless the
caller asks for the CPU), in the wider dtype of the phases and the
gradient scaling (float64 for float64 inputs), with the spins in
chunks of 16,384 as in the JAX package. The JAX package sums each chunk
on its device and the chunks in float64 on the host; here the chunk sums
are added on the device, which orders the float64 sum differently (the
two agree to rtol 1e-12 in the tests).
"""

import os

import numpy as np
import torch

from .. import config
from ..utils.scheme import import_PGSE_scheme

_PHASE_NAMES = ["x", "y", "z"]
_MAXDIM = 3


def monte_carlo_average(sim_phases, delta_mapping, gscaling, Dscaling,
                        num_spins, chunk=16384, device="cuda"):
    """Monte-Carlo signal as the average of the spins' dephasing cosines.

    Args match the reference kernel: ``sim_phases`` (n_ref*num_spins, dim)
    stacked per reference sequence, ``delta_mapping`` (n_seq,) reference row
    per new sequence, ``gscaling`` (n_seq, dim) gradient ratios, ``Dscaling``
    = sqrt(D/D_ref). Returns (n_seq,) as a NumPy array.
    """
    dev = config.resolve_device(device)
    sim_phases = np.asarray(sim_phases)
    n_entries, dim = sim_phases.shape
    n_ref = n_entries // num_spins
    phases = sim_phases.reshape(n_ref, num_spins, dim)
    dmap = torch.as_tensor(np.asarray(delta_mapping), dtype=torch.int64,
                           device=dev)
    gsc = torch.as_tensor(np.asarray(gscaling), device=dev)
    total = torch.zeros(dmap.shape[0], dtype=torch.float64, device=dev)
    for st in range(0, num_spins, chunk):
        en = min(st + chunk, num_spins)
        ph = torch.as_tensor(phases[:, st:en, :], device=dev)[dmap]
        dt = torch.promote_types(ph.dtype, gsc.dtype)
        acc = torch.einsum("scd,sd->sc", ph.to(dt), gsc.to(dt))
        total += torch.sum(torch.cos(float(Dscaling) * acc), dim=1)
    return total.cpu().numpy() / num_spins


def get_PGSE_from_phases(phasefile, sch_mat_sim, sch_mat, dim=None,
                         D_sim=None, D=None, device="cuda"):
    """Compute a PGSE signal for a new protocol from stored spin phases.

    ``phasefile`` points at one of the sibling ``*_phase_{x,y,z}.<ext>``
    binary files; the extension encodes endianness ('b'/'l' prefix) and
    precision ('single'/'float'/'double'). Each new sequence is mapped to the
    reference (Delta, delta) row it was simulated with; gradients are scaled
    by the intensity ratio and diffusivity rescaling enters as
    sqrt(D/D_sim) (phase ~ displacement ~ sqrt(D)). The files are read on
    the host; the average runs on ``device`` (:func:`monte_carlo_average`).
    """
    D_ratio_sqrt = 1.0
    if D is not None:
        if D_sim is None:
            raise NameError("Simulation diffusivity should be specified if"
                            " new signal diffusivity is set.")
        D_ratio_sqrt = float(np.sqrt(D / D_sim))
    if dim is None:
        dim = _MAXDIM
    elif dim > _MAXDIM:
        raise ValueError("dim should be less than or equal to %d." % _MAXDIM)

    sch_mat_sim = import_PGSE_scheme(sch_mat_sim)
    sch_mat = import_PGSE_scheme(sch_mat)

    if np.any(sch_mat[:, dim:_MAXDIM] != 0):
        print("WARNING get_PGSE_from_phases: detected non-zero entries in"
              " gradient components after dimension %d.\nThose components"
              " will be ignored but make sure the right acquisition protocol"
              " was provided.\n" % dim)
    num_seq = sch_mat.shape[0]
    num_ref = sch_mat_sim.shape[0]

    sim_g = sch_mat_sim[:, :3] * sch_mat_sim[:, 3][:, np.newaxis]
    new_g = sch_mat[:, :3] * sch_mat[:, 3][:, np.newaxis]

    # (Delta, delta) row mapping new -> simulated
    delta_mapping = np.zeros(num_seq, dtype=np.int64) - 1
    for i in range(num_ref):
        match = np.all(sch_mat[:, 4:6] == sch_mat_sim[i, 4:6], axis=1)
        delta_mapping[match] = i
    num_unidentified = int(np.sum(delta_mapping < 0))
    if num_unidentified > 0:
        bad_seq = np.where(delta_mapping < 0)[0]
        seq_list = '\n'.join('\t%4d -- %5g -- %5g' %
                             (bad_seq[i],
                              sch_mat[bad_seq[i], 4] * 1e3,
                              sch_mat[bad_seq[i], 5] * 1e3)
                             for i in range(bad_seq.shape[0]))
        raise ValueError('Acquisition protocol contains %d (Delta,delta)'
                         ' pair(s) (out of %d) not used to simulate the'
                         ' directional phases in the Monte Carlo '
                         'simulation. List of unmatched sequences:\nSequ.'
                         ' no. -- Delta [ms] -- delta [ms]\n%s'
                         % (num_unidentified, num_seq, seq_list))

    gscaling = new_g[:, :dim] / sim_g[delta_mapping, :dim]

    if not os.path.isfile(phasefile):
        raise RuntimeError("File %s does not exist." % phasefile)
    phasesize = os.path.getsize(phasefile)

    (path, tail) = os.path.split(phasefile)
    (basename, ext) = os.path.splitext(tail)
    if not ext:
        raise ValueError("Phase file extension not found.\nAborting as"
                         " there is no way to tell which level of precision"
                         " was used to store the phase values (e.g., float,"
                         " double, ...).")
    if ext[1].lower() == 'b':
        endian = '>'
    elif ext[1].lower() == 'l':
        endian = '<'
    else:
        raise ValueError("Phase file extension (after the dot) should "
                         "start with a b for big endian or with a l for "
                         "little endian. Detected: \"%s\"." % ext[1])
    if ext[2:] in ('single', 'float'):
        dtype, prec = 'f4', 4
    elif ext[2:] == 'double':
        dtype, prec = 'f8', 8
    else:
        raise ValueError("Data type of phase file specified in file"
                         " extension (\"%s\") not supported." % ext[2:])

    if phasesize % (num_ref * prec) != 0:
        raise RuntimeError("Phase file %s is either corrupted or "
                           "inconsistently named. Storage precision of items"
                           " (%d bytes) times number of reference simulation"
                           " sequences (%d) does not divide total size "
                           "(%d bytes)." %
                           (phasefile, prec, num_ref, phasesize))
    num_entries = phasesize // prec
    num_spins = num_entries // num_ref

    sim_phases = np.zeros((num_entries, dim))
    for i in range(dim):
        ph_name = _PHASE_NAMES[i]
        basename_i = basename[:-len(ph_name)] + ph_name
        ph_file_i = os.path.join(path, basename_i + ext)
        if not os.path.isfile(ph_file_i):
            raise RuntimeError("Phase file %s not found." % ph_file_i)
        sim_phases[:, i] = np.fromfile(ph_file_i, dtype=endian + dtype,
                                       count=num_entries, sep="")

    return monte_carlo_average(sim_phases, delta_mapping, gscaling,
                               D_ratio_sqrt, num_spins, device=device)
