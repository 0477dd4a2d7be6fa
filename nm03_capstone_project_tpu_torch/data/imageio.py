"""Generic image + MetaImage IO.

The port's own copy of the JAX package's ``data/imageio.py`` (a test pins
the two writers' bytes equal): ``ImageFileImporter``
(FAST_directives.hpp:31) -> :func:`read_image`, ``ImageExporter``
(FAST_directives.hpp:27) -> :func:`write_image`, ``MetaImageExporter``
(FAST_directives.hpp:29) -> :func:`write_metaimage` / :func:`read_metaimage`.

MetaImage (.mhd + .raw/.zraw) is the ITK/FAST interchange format for
volumes: a small text header next to a raw little-endian pixel blob,
optionally zlib-compressed. Only the element types FAST images use are
supported. The volume driver (``cli/volume.py --export-mhd``) writes each
patient's 3D mask with it.
"""

from __future__ import annotations

import os
import zlib
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_MET_TO_DTYPE = {
    "MET_UCHAR": np.uint8,
    "MET_CHAR": np.int8,
    "MET_USHORT": np.uint16,
    "MET_SHORT": np.int16,
    "MET_UINT": np.uint32,
    "MET_INT": np.int32,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {np.dtype(v): k for k, v in _MET_TO_DTYPE.items()}


def write_image(image: np.ndarray, path: str | os.PathLike) -> None:
    """Write a uint8 grayscale (H, W) or RGB (H, W, 3) array; format by suffix.

    The generic exporter (PNG, BMP, TIFF, JPEG — whatever PIL maps the
    suffix to), as opposed to :func:`render.export.save_jpeg` which is the
    batch drivers' JPEG-only contract path.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"expected uint8 image, got {arr.dtype}")
    if arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[-1] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3), got {arr.shape}")
    from PIL import Image

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def read_image(path: str | os.PathLike) -> np.ndarray:
    """Read any PIL-supported image as float32 grayscale (H, W).

    The generic importer; color inputs are luminance-converted, so a slice
    exported with :func:`write_image` round-trips (JPEG: to within
    compression noise).
    """
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("F"), dtype=np.float32)


def write_metaimage(
    image: np.ndarray,
    path: str | os.PathLike,
    spacing: Optional[Sequence[float]] = None,
    compressed: bool = False,
) -> None:
    """Write a 2D/3D array as MetaImage: ``<path>.mhd`` header + data blob.

    ``path`` names the header (.mhd appended when not already the suffix;
    dotted basenames like ``subject.01`` are preserved, not collapsed); the
    pixel data lands next to it as ``.raw`` (or ``.zraw`` zlib-compressed).
    Array axes are (z, y, x) / (y, x); DimSize is written fastest-first
    (x y z) per the MetaIO convention.
    """
    arr = np.ascontiguousarray(image)
    if arr.ndim not in (2, 3):
        raise ValueError(f"MetaImage supports 2D/3D, got shape {arr.shape}")
    met = _DTYPE_TO_MET.get(arr.dtype)
    if met is None:
        raise ValueError(f"unsupported dtype for MetaImage: {arr.dtype}")
    ndims = arr.ndim
    if spacing is None:
        spacing = (1.0,) * ndims
    if len(spacing) != ndims:
        raise ValueError(f"spacing must have {ndims} entries, got {len(spacing)}")

    p = Path(path)
    mhd = p if p.suffix == ".mhd" else p.with_name(p.name + ".mhd")
    data_name = mhd.name[: -len(".mhd")] + (".zraw" if compressed else ".raw")
    payload = arr.tobytes()  # C order; fastest-varying axis is the last (x)
    if compressed:
        payload = zlib.compress(payload)

    dim_size = " ".join(str(s) for s in arr.shape[::-1])
    spacing_str = " ".join(f"{s:g}" for s in spacing[::-1])
    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        f"DimSize = {dim_size}",
        f"ElementSpacing = {spacing_str}",
        f"ElementType = {met}",
        "ElementByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
        f"ElementDataFile = {data_name}",
    ]
    mhd.parent.mkdir(parents=True, exist_ok=True)
    # tmp+rename (NM351) with BOTH tmps staged before either rename, blob
    # first: each file is individually complete-or-absent, and the only
    # torn state is old-header/new-blob across two adjacent renames. On a
    # re-export that changes dims/dtype that state fails the reader's
    # blob-size-vs-header validation (ValueError, not garbage); the
    # fixed ``<stem>.raw`` naming is the MetaIO convention external tools
    # and the tests rely on, so a content-keyed blob name is not an option
    data_tmp = mhd.parent / (data_name + ".tmp")
    mhd_tmp = mhd.with_name(mhd.name + ".tmp")
    data_tmp.write_bytes(payload)
    mhd_tmp.write_text("\n".join(lines) + "\n")
    os.replace(data_tmp, mhd.parent / data_name)
    os.replace(mhd_tmp, mhd)


def read_metaimage(path: str | os.PathLike) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Read a .mhd MetaImage; returns (array in (z, y, x)/(y, x) order, spacing).

    Spacing is returned in the same axis order as the array. Raises
    ValueError on malformed headers, unsupported element types, or a data
    blob whose size disagrees with the header.
    """
    mhd = Path(path)
    fields: Dict[str, str] = {}
    # errors="replace": corrupt header bytes garble fields, which then fail
    # the checks below as ValueError — never a UnicodeDecodeError escape
    for line in mhd.read_text(errors="replace").splitlines():
        if "=" in line:
            key, _, val = line.partition("=")
            fields[key.strip()] = val.strip()
    try:
        ndims = int(fields["NDims"])
        shape_xyz = tuple(int(s) for s in fields["DimSize"].split())
        met = fields["ElementType"]
        data_file = fields["ElementDataFile"]
    except KeyError as e:
        raise ValueError(f"{mhd}: missing MetaImage header field {e}") from e
    if len(shape_xyz) != ndims:
        raise ValueError(f"{mhd}: DimSize has {len(shape_xyz)} entries, NDims={ndims}")
    dtype = _MET_TO_DTYPE.get(met)
    if dtype is None:
        raise ValueError(f"{mhd}: unsupported ElementType {met}")
    if fields.get("ElementByteOrderMSB", "False").lower() == "true":
        raise ValueError(f"{mhd}: big-endian MetaImage not supported")
    if data_file == "LOCAL":
        raise ValueError(f"{mhd}: inline (LOCAL) data not supported")
    if data_file == "LIST" or "%" in data_file:
        raise ValueError(
            f"{mhd}: multi-file MetaImage (LIST / pattern data files) not supported"
        )

    try:
        payload = (mhd.parent / data_file).read_bytes()
    except OSError as e:
        # missing/unreadable data file (or a corrupt name resolving to a
        # directory) is a malformed pair per this reader's contract
        raise ValueError(f"{mhd}: cannot read data file {data_file!r}: {e}") from e
    if fields.get("CompressedData", "False").lower() == "true":
        try:
            payload = zlib.decompress(payload)
        except zlib.error as e:
            raise ValueError(f"{mhd}: corrupt compressed data: {e}") from e
    shape = shape_xyz[::-1]  # header is x y z; numpy wants z y x
    expected = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if len(payload) != expected:
        raise ValueError(
            f"{mhd}: data file holds {len(payload)} bytes, header implies {expected}"
        )
    arr = np.frombuffer(payload, dtype=dtype).reshape(shape)
    spacing_field = fields.get("ElementSpacing")
    spacing = (
        tuple(float(s) for s in spacing_field.split())[::-1]
        if spacing_field
        else (1.0,) * ndims
    )
    return arr.copy(), spacing
