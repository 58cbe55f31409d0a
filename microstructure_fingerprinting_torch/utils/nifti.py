"""Minimal, dependency-free NIfTI-1 reader/writer (pure NumPy).

The reference package relies on nibabel for volume I/O
(the upstream microstructure_fingerprinting/mf.py:30-33, 1177-1229).
nibabel is not part of this framework's baked-in environment, so we ship a
small self-contained NIfTI-1 implementation covering what the fingerprinting
pipeline needs:

  * ``load(path)``      -> :class:`NiftiImage` (.nii and .nii.gz)
  * ``save(img, path)`` / ``Nifti1Image(data, affine)`` for writing maps
  * ``img.get_fdata()`` applies scl_slope/scl_inter and returns float64,
    matching nibabel's get_fdata contract
  * affine resolution order: sform (sform_code > 0), then qform
    (qform_code > 0), then pixdim-diagonal fallback

Only single-file NIfTI-1 (magic ``n+1``) is supported, which is what every
fixture and every practical DW-MRI pipeline in this domain produces.
"""

import gzip
import os
import struct

import numpy as np

_HDR_SIZE = 348

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

# (name, struct format, count) for the fields we care about, in file order.
_HDR_FIELDS = [
    ("sizeof_hdr", "i", 1),        # 0
    ("data_type", "10s", 1),       # 4
    ("db_name", "18s", 1),         # 14
    ("extents", "i", 1),           # 32
    ("session_error", "h", 1),     # 36
    ("regular", "c", 1),           # 38
    ("dim_info", "c", 1),          # 39
    ("dim", "8h", 8),              # 40
    ("intent_p1", "f", 1),         # 56
    ("intent_p2", "f", 1),         # 60
    ("intent_p3", "f", 1),         # 64
    ("intent_code", "h", 1),       # 68
    ("datatype", "h", 1),          # 70
    ("bitpix", "h", 1),            # 72
    ("slice_start", "h", 1),       # 74
    ("pixdim", "8f", 8),           # 76
    ("vox_offset", "f", 1),        # 108
    ("scl_slope", "f", 1),         # 112
    ("scl_inter", "f", 1),         # 116
    ("slice_end", "h", 1),         # 120
    ("slice_code", "c", 1),        # 122
    ("xyzt_units", "c", 1),        # 123
    ("cal_max", "f", 1),           # 124
    ("cal_min", "f", 1),           # 128
    ("slice_duration", "f", 1),    # 132
    ("toffset", "f", 1),           # 136
    ("glmax", "i", 1),             # 140
    ("glmin", "i", 1),             # 144
    ("descrip", "80s", 1),         # 148
    ("aux_file", "24s", 1),        # 228
    ("qform_code", "h", 1),        # 252
    ("sform_code", "h", 1),        # 254
    ("quatern_b", "f", 1),         # 256
    ("quatern_c", "f", 1),         # 260
    ("quatern_d", "f", 1),         # 264
    ("qoffset_x", "f", 1),         # 268
    ("qoffset_y", "f", 1),         # 272
    ("qoffset_z", "f", 1),         # 276
    ("srow_x", "4f", 4),           # 280
    ("srow_y", "4f", 4),           # 296
    ("srow_z", "4f", 4),           # 312
    ("intent_name", "16s", 1),     # 328
    ("magic", "4s", 1),            # 344
]


def _read_bytes(path):
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _parse_header(raw):
    hdr_bytes = raw[:_HDR_SIZE]
    size_le = struct.unpack("<i", hdr_bytes[:4])[0]
    endian = "<" if size_le == _HDR_SIZE else ">"
    if endian == ">" and struct.unpack(">i", hdr_bytes[:4])[0] != _HDR_SIZE:
        raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr).")
    hdr = {}
    offset = 0
    for name, fmt, _count in _HDR_FIELDS:
        sz = struct.calcsize(endian + fmt)
        vals = struct.unpack(endian + fmt, hdr_bytes[offset:offset + sz])
        hdr[name] = vals[0] if len(vals) == 1 else np.array(vals)
        offset += sz
    hdr["_endian"] = endian
    return hdr


def _quaternion_to_affine(hdr):
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a_sq = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a_sq, 0.0))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    pixdim = np.asarray(hdr["pixdim"], dtype=np.float64)
    qfac = pixdim[0]
    if qfac == 0:
        qfac = 1.0
    zooms = pixdim[1:4].copy()
    zooms[2] *= qfac
    aff = np.eye(4)
    aff[:3, :3] = R * zooms[np.newaxis, :]
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _affine_from_header(hdr):
    if hdr["sform_code"] > 0:
        aff = np.eye(4)
        aff[0, :] = hdr["srow_x"]
        aff[1, :] = hdr["srow_y"]
        aff[2, :] = hdr["srow_z"]
        return aff
    if hdr["qform_code"] > 0:
        return _quaternion_to_affine(hdr)
    aff = np.eye(4)
    pixdim = np.asarray(hdr["pixdim"], dtype=np.float64)
    aff[0, 0], aff[1, 1], aff[2, 2] = pixdim[1], pixdim[2], pixdim[3]
    return aff


class NiftiImage(object):
    """In-memory NIfTI volume: raw data + affine + parsed header."""

    def __init__(self, dataobj, affine, header=None):
        self.dataobj = np.asarray(dataobj)
        if affine is None:
            affine = np.eye(4)
        self.affine = np.asarray(affine, dtype=np.float64)
        self.header = dict(header) if header else {}

    @property
    def shape(self):
        return self.dataobj.shape

    def get_fdata(self):
        """Scaled floating-point data (nibabel get_fdata semantics)."""
        data = self.dataobj.astype(np.float64)
        slope = float(self.header.get("scl_slope", 0.0) or 0.0)
        inter = float(self.header.get("scl_inter", 0.0) or 0.0)
        if np.isnan(slope) or slope == 0.0:
            # nibabel semantics: slope 0/NaN means "no scaling stored" and
            # the intercept is ignored entirely.
            return data
        if np.isnan(inter):
            inter = 0.0
        if slope != 1.0 or inter != 0.0:
            data = data * slope + inter
        return data


# nibabel-compatible alias used at volume-writing sites.
def Nifti1Image(data, affine, header=None):
    return NiftiImage(data, affine, header)


def load(path):
    """Load a .nii or .nii.gz file into a :class:`NiftiImage`."""
    raw = _read_bytes(path)
    hdr = _parse_header(raw)
    magic = hdr["magic"].rstrip(b"\x00")
    if magic not in (b"n+1", b"ni1"):
        raise ValueError("Unsupported NIfTI magic %r in %s" % (magic, path))
    if magic == b"ni1":
        raise ValueError("Two-file (.hdr/.img) NIfTI not supported: %s" % path)
    ndim = int(hdr["dim"][0])
    if not 1 <= ndim <= 7:
        raise ValueError("Invalid dim[0]=%d in %s" % (ndim, path))
    shape = tuple(int(x) for x in hdr["dim"][1:1 + ndim])
    code = int(hdr["datatype"])
    if code not in _DTYPES:
        raise ValueError("Unsupported NIfTI datatype code %d" % code)
    dtype = np.dtype(_DTYPES[code]).newbyteorder(hdr["_endian"])
    offset = int(hdr["vox_offset"])
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    # NIfTI stores data in Fortran (column-major) order.
    data = data.reshape(shape, order="F")
    return NiftiImage(data, _affine_from_header(hdr), hdr)


def save(img, path):
    """Write a :class:`NiftiImage` as single-file NIfTI-1 (.nii / .nii.gz)."""
    data = np.asarray(img.dataobj)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float64)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    ndim = data.ndim
    if ndim > 7:
        raise ValueError("NIfTI supports at most 7 dimensions.")
    dim = np.ones(8, dtype=np.int16)
    dim[0] = ndim
    dim[1:1 + ndim] = data.shape
    affine = np.asarray(img.affine, dtype=np.float64)
    zooms = np.sqrt(np.sum(affine[:3, :3] ** 2, axis=0))
    pixdim = np.ones(8, dtype=np.float32)
    pixdim[1:4] = zooms
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<c", hdr, 38, b"r")
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 2)       # sform_code: aligned
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    struct.pack_into("<4s", hdr, 344, b"n+1\x00")
    payload = bytes(hdr) + b"\x00\x00\x00\x00"  # no header extensions
    body = np.asfortranarray(data).tobytes(order="F")
    blob = payload + body
    out_dir = os.path.dirname(str(path))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
    return path


def load_volume(source):
    """Polymorphic volume loader: path -> (data, affine); array -> (array, None)."""
    if isinstance(source, (str, os.PathLike)):
        img = load(source)
        return img.get_fdata(), img.affine
    return np.asarray(source), None
