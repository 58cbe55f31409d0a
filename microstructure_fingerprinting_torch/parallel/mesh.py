"""Device meshes and the sharded parts of the fingerprinting fit.

PyTorch counterpart of ``microstructure_fingerprinting_tpu/parallel/
mesh.py``, with its names. A ``Mesh`` is a (data, atoms) grid of
``torch.device``s; torch has no global sharded array, so ``shard_batch``,
``replicate`` and ``shard_atoms`` return the per-device pieces, laid out
like the grid. Two parallel axes:

  * ``data``: the voxel batch. Voxels are independent, so the fit deals
    whole chunks to the data slots in turn (``models/fit.run_bucket_fast``
    and ``run_bucket``) with the dictionary tables replicated on each;
    every voxel's result is bit for bit the serial fit's, since each
    chunk is the serial fit's chunk.
  * ``atoms``: the second sub-dictionary's atom axis of the [N1, N2, 1]
    candidate scan (``sharded_df3_candidates``): each slot scans its
    N1 x (N2 / n_atoms) sub-grid with ``ops/dfscan.df3_candidates`` and
    the global top-M is re-ranked from the slots' champions by (value,
    flat rank), keeping the reference's first-minimum tie order.

A grid may name a device more than once (several slots on one card, or
on the CPU): the slots then run in turn, which checks the mesh code but
gains no speed. Across processes, ``init_distributed`` joins them with
``torch.distributed`` (NCCL between cards, gloo on the CPU), each process
fits its own slice of the voxels on its local mesh, and ``gather_to_host``
hands every process the whole result.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops import dfscan


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, atoms) grid of devices: ``devices[j][a]`` is the slot of
    data row j and atoms column a."""
    devices: tuple

    @property
    def shape(self):
        return {"data": len(self.devices), "atoms": len(self.devices[0])}

    @property
    def data_devices(self):
        """The device of each data row's first atoms slot, where a data
        row's chunks are rotated, finalized and gathered."""
        return [row[0] for row in self.devices]


def build_mesh(n_data=None, n_atoms=1, devices=None):
    """A (data, atoms) mesh over ``devices`` (every visible CUDA device
    by default), filled row by row. ``devices`` may repeat a device.
    Raises ValueError when the grid does not hold exactly the devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device in sight: pass devices= "
                               "(e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    if n_data is None:
        n_data = n_dev // n_atoms
    if n_data < 1 or n_atoms < 1 or n_data * n_atoms != n_dev:
        raise ValueError("mesh shape %dx%d does not match %d devices"
                         % (n_data, n_atoms, n_dev))
    return Mesh(tuple(tuple(devices[j * n_atoms:(j + 1) * n_atoms])
                      for j in range(n_data)))


def _split(x, parts, axis):
    n = x.shape[axis]
    if n % parts:
        raise ValueError("axis %d of length %d does not split into %d "
                         "equal parts" % (axis, n, parts))
    return torch.split(x, n // parts, dim=axis)


def shard_batch(mesh, x):
    """Axis 0 of ``x`` split over the 'data' axis, each part on every
    atoms slot of its row: pieces[j][a]."""
    parts = _split(torch.as_tensor(x), mesh.shape["data"], 0)
    return [[p.to(d) for d in row] for p, row in zip(parts, mesh.devices)]


def replicate(mesh, x):
    """``x`` on every slot (read-only dictionary tables): pieces[j][a]."""
    x = torch.as_tensor(x)
    return [[x.to(d) for d in row] for row in mesh.devices]


def shard_atoms(mesh, x):
    """Axis 0 of ``x`` split over 'data' and its last (atom) axis over
    'atoms': pieces[j][a]."""
    rows = _split(torch.as_tensor(x), mesh.shape["data"], 0)
    return [[p.to(d) for p, d in zip(_split(r, len(row), r.dim() - 1), row)]
            for r, row in zip(rows, mesh.devices)]


def atoms_df3_candidates(devices, A1, A2, a3, y, M=1, tile=256):
    """The [N1, N2, 1] candidate scan with the atom axis of ``A2`` split
    over ``devices`` (one data row of a mesh): each device runs
    ``dfscan.df3_candidates`` on its N1 x (N2 / len(devices)) sub-grid,
    and the global top-M is re-ranked on ``A1``'s device from every
    slot's champions by (value, flat rank i1 * N2 + i2): an index sort,
    then a stable value sort, so equal residuals keep the earliest
    candidate. Returns (cand (B, M, 2) int32, res (B, M), y_sq (B,)) as
    the one-device scan does."""
    home = A1.device
    N2 = A2.shape[2]
    n_at = len(devices)
    if N2 % n_at:
        raise ValueError("N2 = %d atoms do not split over %d devices"
                         % (N2, n_at))
    n2_loc = N2 // n_at
    vals_l, flats_l, ysq = [], [], None
    for a, d in enumerate(devices):
        cand, vals, ysq_a = dfscan.df3_candidates(
            A1.to(d), A2[:, :, a * n2_loc:(a + 1) * n2_loc].to(d), a3.to(d),
            y.to(d), M=M, tile=tile)
        flats_l.append((cand[:, :, 0].long() * N2 + a * n2_loc
                        + cand[:, :, 1]).to(home))
        vals_l.append(vals.to(home))
        if ysq is None:
            ysq = ysq_a.to(home)
    vals_f = torch.cat(vals_l, dim=1)
    flats_f = torch.cat(flats_l, dim=1)
    order = torch.sort(flats_f, dim=1, stable=True)[1]
    v_o = torch.gather(vals_f, 1, order)
    f_o = torch.gather(flats_f, 1, order)
    rank = torch.sort(v_o, dim=1, stable=True)[1][:, :M]
    v_m = torch.gather(v_o, 1, rank)
    f_m = torch.gather(f_o, 1, rank)
    cand_m = torch.stack([f_m // N2, f_m % N2], dim=2).to(torch.int32)
    return cand_m, v_m, ysq


def sharded_df3_candidates(mesh, A1, A2, a3, y, M=1, tile=256):
    """Atom-axis split double-float candidate scan, [N1, N2, 1].

    ``ops/dfscan.df3_candidates`` with the voxels of A1 (B, S, N1), A2
    (B, S, N2), a3 (B, S, 1) and y (B, S) split over the mesh's 'data'
    axis and the atom axis of A2 over its 'atoms' axis
    (``atoms_df3_candidates`` on each data row). B must split evenly over
    'data' and N2 over 'atoms'. Residuals are comparable across slots:
    the scan normalizes per column and per voxel. Returns (cand (B, M, 2)
    int32, res (B, M), y_sq (B,)) on A1's device, exactly the one-device
    scan's top-M."""
    home = A1.device
    nd = mesh.shape["data"]
    pieces = [_split(t, nd, 0) for t in (A1, A2, a3, y)]
    outs = [atoms_df3_candidates(row, *(p[j].to(row[0]) for p in pieces),
                                 M=M, tile=tile)
            for j, row in enumerate(mesh.devices)]
    return tuple(torch.cat([o[k].to(home) for o in outs]) for k in range(3))


# ---------------------------------------------------------------------------
# Several processes
# ---------------------------------------------------------------------------

def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, backend=None):
    """Join this process to a multi-process fit (``torch.distributed``).

    Every process runs the same fit script on its own slice of the
    voxels; ``gather_to_host`` then assembles the maps. Arguments are the
    JAX package's: ``coordinator_address`` ("host:port", or any
    ``init_method`` URL; ``None`` reads ``MASTER_ADDR``/``MASTER_PORT``
    as ``torchrun`` sets them, with the world size and rank), the number
    of processes and this one's rank. ``local_device_ids`` are the cards
    of this process (its first becomes the current device); without them
    a process that ``torchrun`` started takes card ``LOCAL_RANK``, any
    other every card in sight. ``backend``
    defaults to NCCL where CUDA is available and gloo otherwise; NCCL
    takes one card per process, so processes that share a card use gloo.
    Returns this process's devices, for ``build_mesh(devices=)``."""
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    if not cuda:
        devices = [torch.device("cpu")]
    elif local_device_ids is None and "LOCAL_RANK" in os.environ:
        devices = [torch.device("cuda", int(os.environ["LOCAL_RANK"]))]
    elif local_device_ids is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cuda", int(i)) for i in local_device_ids]
    if cuda:
        torch.cuda.set_device(devices[0])
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id))
    return devices


def gather_to_host(x, tiled=True):
    """Every process's ``x`` (equal shapes: each its slice of the voxels)
    as NumPy on every process, in rank order: concatenated along axis 0
    (``tiled=True``), or stacked on a new leading axis. Without a process
    group it is ``x`` itself (a new leading axis of 1 when not tiled)."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if not (dist.is_available() and dist.is_initialized()):
        out = t.cpu().numpy()
        return out if tiled else out[None]
    dtype = t.dtype
    if dtype == torch.bool:
        t = t.to(torch.uint8)
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.to(dtype).cpu().numpy()


def host_local_to_global(mesh, x):
    """This process's slice of the voxel batch on its local mesh: the
    pieces of ``shard_batch``. torch needs no global array here: each
    process fits its own pieces and ``gather_to_host`` joins the
    results."""
    return shard_batch(mesh, x)
