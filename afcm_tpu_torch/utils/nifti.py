"""Minimal self-contained NIfTI-1 I/O (.nii / .nii.gz).

The environment ships neither nibabel nor SimpleITK; this module implements
the small subset of NIfTI-1 the pipeline needs: single-file n+1 images,
scalar 3-D volumes, common dtypes, sform affine.  Arrays are exchanged in
z, y, x order (SimpleITK's GetArrayFromImage convention, which the reference
predictor uses — reference: models/predictor.py:226-227).

The port's own copy of ``afcm_tpu/utils/nifti.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32}
_CODES = {np.dtype(v).name: k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        if "w" in mode:
            # Level 1: zlib's default level 9 costs seconds per float volume
            # of the predictor's end-to-end time for a few percent smaller
            # files. Level 1 keeps .nii.gz compatibility.
            return gzip.open(path, mode, compresslevel=1)
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a NIfTI-1 file; returns (volume[z, y, x], affine[4, 4])."""
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack_from("<8h", hdr, 40)
    datatype = struct.unpack_from("<h", hdr, 70)[0]
    vox_offset = int(struct.unpack_from("<f", hdr, 108)[0])
    scl_slope = struct.unpack_from("<f", hdr, 112)[0]
    scl_inter = struct.unpack_from("<f", hdr, 116)[0]
    srow = np.array(struct.unpack_from("<12f", hdr, 280),
                    dtype=np.float64).reshape(3, 4)
    magic = hdr[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    ndim = dim[0]
    shape_xyz = tuple(int(d) for d in dim[1:1 + max(ndim, 3)])
    shape_xyz = tuple(s if s > 0 else 1 for s in shape_xyz[:3])
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f"{path}: unsupported datatype {datatype}")

    count = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=max(vox_offset, 352))
    vol = data.reshape(shape_xyz[::-1])  # C-order over reversed dims = [z,y,x]
    # nibabel convention: NaN/0 slope means "no scaling", NaN inter means 0 —
    # some writers leave these fields as NaN.
    slope = scl_slope if np.isfinite(scl_slope) and scl_slope != 0.0 else 1.0
    inter = scl_inter if np.isfinite(scl_inter) else 0.0
    if (slope, inter) != (1.0, 0.0):
        vol = vol * slope + inter

    affine = np.eye(4)
    if np.any(srow):
        affine[:3, :] = srow
    else:
        pixdim = struct.unpack_from("<8f", hdr, 76)
        qform_code = struct.unpack_from("<h", hdr, 252)[0]
        if qform_code > 0:
            affine = _qform_affine(hdr, pixdim)
        else:
            # no sform/qform: still honor the voxel spacing from pixdim
            for i in range(3):
                affine[i, i] = pixdim[1 + i] if pixdim[1 + i] > 0 else 1.0
    vol = np.ascontiguousarray(vol)
    if not vol.flags.writeable:  # frombuffer view pins the raw file bytes
        vol = vol.copy()
    return vol, affine


def _qform_affine(hdr: bytes, pixdim) -> np.ndarray:
    """Affine from the quaternion qform fields (NIfTI-1 method 2)."""
    b, c, d = struct.unpack_from("<3f", hdr, 256)
    qx, qy, qz = struct.unpack_from("<3f", hdr, 268)
    a2 = 1.0 - (b * b + c * c + d * d)
    a = float(np.sqrt(a2)) if a2 > 0 else 0.0
    rot = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = -1.0 if pixdim[0] == -1.0 else 1.0
    spacing = np.array([pixdim[1] or 1.0, pixdim[2] or 1.0,
                        (pixdim[3] or 1.0) * qfac])
    affine = np.eye(4)
    affine[:3, :3] = rot * spacing
    affine[:3, 3] = (qx, qy, qz)
    return affine


def write_nifti(path: str, volume: np.ndarray,
                affine: Optional[np.ndarray] = None):
    """Write volume[z, y, x] as a single-file NIfTI-1 image."""
    volume = np.asarray(volume)
    if volume.ndim > 3:
        volume = np.squeeze(volume)
    assert volume.ndim in (2, 3)
    if volume.ndim == 2:
        volume = volume[None]
    name = np.dtype(volume.dtype).name
    if name not in _CODES:
        volume = volume.astype(np.float32)
        name = "float32"
    code = _CODES[name]
    bitpix = volume.dtype.itemsize * 8
    nz, ny, nx = volume.shape
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    # pixdim: qfac + voxel sizes from the affine diagonal
    voxsizes = np.sqrt(np.sum(affine[:3, :3] ** 2, axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, float(voxsizes[0]),
                     float(voxsizes[1]), float(voxsizes[2]), 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)           # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)             # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)             # scl_inter
    struct.pack_into("<h", hdr, 252, 1)               # qform_code
    struct.pack_into("<h", hdr, 254, 1)               # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel().tolist())
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # no extensions
        f.write(volume.tobytes(order="C"))
