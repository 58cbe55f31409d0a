"""Operations, bytes and the least time of the port's row passes (kernels
2 and 4), over the published peaks of one H100.

A frozen copy of ``chip_smoke.py``'s ``PEAK``, ``CHAIN_OPS``, ``bound``
and ``scan_ops`` (operations counted by hand from ``csrc/rowmin3.cu``
and ``csrc/rowmin4.cu``: the Gram tile's int8 level products and bf16
corrections a sample and grid point, the float32 chain a grid point),
and the work a fit's inputs need: one row pass over each voxel's real
atoms, ``num_atom`` x ``num_atom`` (no padded tile, no overflow batch).
"""

#: published peaks of one H100 SXM (NVIDIA's data sheet, dense; the
#: float32 rate is outside the tensor cores), at its 700 W power limit
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bf16": 989e12, "f32": 67e12}

#: float32 operations per grid point of each row pass's chain, nx = n3 +
#: n4 extra columns, ns = n3 * n4 sweeps
CHAIN_OPS = {
    "rowmin3": lambda nx, ns: 70,
    "rowmin4": lambda nx, ns: 30 + 37 * nx + 47 * ns,
}


def bound(bytes_moved, ops):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations, each type over its peak.
    Returns (ms, "bytes" or "operations")."""
    t_b = bytes_moved / PEAK["bytes"]
    t_o = sum(n / PEAK[kind] for kind, n in ops.items())
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def scan_ops(name, B, S, n1p, n2p, nx=0, ns=0):
    """Operations of a row pass over a B x n1p x n2p grid of S samples."""
    pts = float(B) * n1p * n2p
    return {"int8": 2 * 9 * S * pts, "bf16": 2 * 2 * S * pts,
            "f32": CHAIN_OPS[name](nx, ns) * pts}


def row_pass_bytes(B, S, n1, n2, n_rhs):
    """Bytes a row pass needs: its two rotated blocks and its rhs columns
    read once as float32 (the rows' bounds written are a few per row)."""
    return 4.0 * B * S * (n1 + n2 + n_rhs) + 3 * 4.0 * B * n1


def row_pass_ms(name, voxels, S, num_atom, num_ear=0):
    """The least time (ms) of one row pass over ``voxels`` voxels' real
    grid: kernel 2 (``rowmin3``: 2 fascicles + CSF) or kernel 4
    (``rowmin4``: + ``num_ear`` EAR atoms)."""
    if name == "rowmin3":
        nx, ns, rhs = 0, 0, 2
    else:
        nx, ns, rhs = 1 + num_ear, num_ear, 2 + num_ear
    return bound(row_pass_bytes(voxels, S, num_atom, num_atom, rhs),
                 scan_ops(name, voxels, S, num_atom, num_atom, nx, ns))[0]
