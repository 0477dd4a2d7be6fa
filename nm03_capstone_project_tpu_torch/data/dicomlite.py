"""Minimal DICOM reader/writer (no external DICOM dependency).

The port's copy of the JAX package's ``data/dicomlite.py``: the
replacement for the import side of FAST's ``DICOMFileImporter``
(reference src/test/test_pipeline.cpp:33-42 — note ``setLoadSeries(false)``:
one 2D slice per file, never a 3D volume). The reference delegates parsing to
FAST/DCMTK; this framework ships its own single-file implementation of the
subset the pipeline needs:

Support envelope (parity note vs the reference: FAST sits on DCMTK; the
T1+C Brain-Tumor-Progression cohort the reference processes is uncompressed
explicit-VR little endian, and the compressed syntaxes below cover the
archive formats DCMTK additionally reads):

* Part-10 files (128-byte preamble + ``DICM``) and bare data sets.
* Explicit and implicit VR little endian transfer syntaxes
  (1.2.840.10008.1.2.1 / 1.2.840.10008.1.2), uncompressed pixel data,
  the retired explicit VR big endian (1.2.840.10008.1.2.2), and the
  zlib-deflated dataset form (1.2.840.10008.1.2.1.99).
* Compressed/encapsulated transfer syntaxes (data/codecs.py):
  **RLE Lossless** (1.2.840.10008.1.2.5) and **JPEG Lossless** processes
  14 / 14-SV1 (1.2.840.10008.1.2.4.57 / .70) decode bit-exactly; baseline
  8-bit JPEG (1.2.840.10008.1.2.4.50) decodes via PIL (lossy by nature).
* Monochrome 8/16-bit pixel data, signed or unsigned, with
  RescaleSlope/Intercept applied — yielding float32 intensities.
* Sequence (SQ) elements are skipped structurally (defined and undefined
  length), so real-world headers parse even though their content is unused.

NOT supported — every rejection raises :class:`DicomParseError` with a
message naming the remedy (tests/test_data.py covers each branch):

* JPEG 2000 (1.2.840.10008.1.2.4.9x) when the optional GDCM fallback shim
  (data/gdcm_fallback.py) is unavailable — transcode to explicit VR little
  endian first (``gdcmconv --raw`` or DCMTK ``dcmdjpeg``/``dcmconv +te``);
* encapsulated PixelData under an *uncompressed* transfer-syntax UID
  (malformed), color images (SamplesPerPixel != 1), BitsAllocated outside
  {8, 16}.

The writer emits valid explicit-VR-LE Part-10 files and exists so tests and
the ``--synthetic`` CLI mode can materialize cohorts that round-trip through
the same reader the real data would use. A native C++ parser
(csrc/host/nm03native.cpp) mirrors this logic for the threaded prefetch loader.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"  # retired, still in archives
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"  # zlib-deflated dataset
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"  # 8-bit lossy (process 1)
JPEG_LOSSLESS = "1.2.840.10008.1.2.4.57"  # process 14, any predictor
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"  # process 14 SV1 (DCMTK default)
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"  # ITU-T T.87 lossless
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"  # T.87 near-lossless

# encapsulated syntaxes this reader decodes (always explicit VR LE headers)
_DECODABLE_ENCAPSULATED = {
    RLE_LOSSLESS,
    JPEG_BASELINE,
    JPEG_LOSSLESS,
    JPEG_LOSSLESS_SV1,
    JPEG_LS_LOSSLESS,
    JPEG_LS_NEAR,
}

# JPEG 2000 family: decoded via the optional GDCM fallback shim when the
# system provides it, rejected with a transcode remedy otherwise (single
# source of truth for the UID set lives beside the shim)
from nm03_capstone_project_tpu_torch.data import gdcm_fallback  # noqa: E402

_J2K_SYNTAXES = gdcm_fallback.J2K_SYNTAXES

# VRs whose explicit encoding uses a 2-byte reserved field + 4-byte length
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}

_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)


class DicomParseError(ValueError):
    """Raised when a file is not parseable as DICOM."""


def _photometric(meta) -> str:
    """PhotometricInterpretation (0028,0004); rejects PALETTE COLOR (its
    stored values are LUT indexes, not intensities)."""
    pi = (
        (meta.get((0x0028, 0x0004)) or b"")
        .decode("ascii", "replace")
        .strip("\x00 ")
    )
    if pi == "PALETTE COLOR":
        raise DicomParseError(
            "PALETTE COLOR images are out of envelope; convert to "
            "grayscale before import (gdcmconv or dcmconv)"
        )
    return pi


def _inversion_base(signed: bool, bits_stored: int) -> int:
    """MONOCHROME1 -> MONOCHROME2 stored-value inversion constant: lo + hi
    of the stored range (PS3.3 C.7.6.3.1.2 via DCMTK's DicomImage):
    unsigned [0, 2^b-1] -> 2^b - 1; signed [-2^(b-1), 2^(b-1)-1] -> -1."""
    return -1 if signed else (1 << bits_stored) - 1


def _check_frame_bounds(rows, cols, itemsize: int) -> None:
    """Plausibility bound shared by every decode path (native caps: 32768
    per axis, 2^28 output bytes) — applied BEFORE any decoder allocates."""
    if rows is None or cols is None:
        raise DicomParseError("missing Rows/Columns")
    if not (0 < rows <= 32768 and 0 < cols <= 32768) or (
        rows * cols * itemsize > 1 << 28
    ):
        raise DicomParseError(
            f"implausible compressed-frame dimensions ({rows}, {cols}) at "
            f"{itemsize * 8}-bit"
        )


@dataclasses.dataclass
class DicomSlice:
    """One decoded 2D slice."""

    pixels: np.ndarray  # float32 (rows, cols), rescale applied
    rows: int
    cols: int
    raw_dtype: np.dtype
    rescale_slope: float
    rescale_intercept: float
    meta: Dict[Tuple[int, int], bytes]

    def meta_str(self, tag: Tuple[int, int]) -> Optional[str]:
        v = self.meta.get(tag)
        return v.decode("ascii", "replace").strip("\x00 ") if v is not None else None

    @property
    def num_frames(self) -> int:
        """NumberOfFrames (0028,0008); 1 for ordinary single-frame slices.

        The same strict IS parse read_dicom's frame-range check uses, so
        ``range(s.num_frames)`` is always a valid frame iteration."""
        return max(1, _meta_int_str(self.meta, (0x0028, 0x0008), 1) or 1)

    @property
    def window(self) -> Optional[Tuple[float, float]]:
        """(WindowCenter, WindowWidth) when the archive carries them."""
        c = self.meta_str((0x0028, 0x1050))
        w = self.meta_str((0x0028, 0x1051))
        try:
            # multi-valued DS (PS3.5: backslash-separated) -> first pair
            return (
                (float(c.split("\\")[0]), float(w.split("\\")[0]))
                if c and w
                else None
            )
        except ValueError:
            return None


class _Reader:
    def __init__(self, buf: bytes, explicit: bool, big: bool = False):
        self.buf = buf
        self.pos = 0
        self.explicit = explicit
        self._h = ">H" if big else "<H"
        self._i = ">I" if big else "<I"

    def u16(self) -> int:
        v = struct.unpack_from(self._h, self.buf, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        v = struct.unpack_from(self._i, self.buf, self.pos)[0]
        self.pos += 4
        return v

    def atend(self) -> bool:
        return self.pos + 8 > len(self.buf)

    def element(self):
        """Decode one data element header; returns (group, elem, vr, length)."""
        group = self.u16()
        elem = self.u16()
        if (group, elem) in (_ITEM, _ITEM_DELIM, _SEQ_DELIM):
            return group, elem, b"", self.u32()
        if self.explicit and group != 0xFFFE:
            vr = self.buf[self.pos : self.pos + 2]
            self.pos += 2
            if vr in _LONG_VRS:
                self.pos += 2  # reserved
                length = self.u32()
            else:
                length = self.u16()
        else:
            vr = b""
            length = self.u32()
        return group, elem, vr, length

    def skip_sequence(self):
        """Skip an undefined-length sequence body (until sequence delimiter)."""
        while not self.atend():
            group, elem, _, length = self.element()
            if (group, elem) == _SEQ_DELIM:
                return
            if (group, elem) == _ITEM:
                if length == 0xFFFFFFFF:
                    self._skip_item_undefined()
                else:
                    self.pos += length
            else:  # malformed; bail out of the sequence
                self.pos += 0 if length == 0xFFFFFFFF else length
                return

    def _skip_item_undefined(self):
        """Skip an undefined-length item (may contain nested sequences)."""
        while not self.atend():
            group, elem, _vr, length = self.element()
            if (group, elem) == _ITEM_DELIM:
                return
            if length == 0xFFFFFFFF:
                self.skip_sequence()  # nested undefined-length sequence
            else:
                self.pos += length


class _Fragments(list):
    """Encapsulated PixelData fragments + frame-boundary metadata.

    A plain list of fragment byte strings (so every existing isinstance and
    indexing contract holds), annotated with the Basic Offset Table entries
    and each fragment's item-tag offset — both measured, per PS3.5 §A.4,
    from the first byte of the first item FOLLOWING the BOT item — so
    :func:`_frame_payload` can use the BOT as the authoritative frame
    delimiter instead of guessing from SOI markers.
    """

    def __init__(self, frags, bot, offsets):
        super().__init__(frags)
        self.bot = list(bot)  # [] when the BOT item is empty
        self.offsets = list(offsets)  # per-fragment item-tag offsets


def _read_fragments(r: "_Reader") -> "_Fragments":
    """Encapsulated PixelData: Basic Offset Table item, then one item per
    fragment, closed by a sequence delimiter (PS3.5 §A.4). Returns the
    fragment byte strings with the BOT preserved (frame-boundary source)."""
    fragments: list = []
    bot: list = []
    offsets: list = []
    first = True
    base = 0
    while not r.atend():
        tag_pos = r.pos
        group, elem, _vr, length = r.element()
        if (group, elem) == _SEQ_DELIM:
            return _Fragments(fragments, bot, offsets)
        if (group, elem) != _ITEM or length == 0xFFFFFFFF:
            raise DicomParseError(
                f"malformed encapsulated PixelData item ({group:04x},{elem:04x})"
            )
        if length > len(r.buf) - r.pos:
            raise DicomParseError("encapsulated fragment overruns file")
        if first:  # the first item is the Basic Offset Table
            # a non-multiple-of-4 BOT is malformed but must not reject the
            # file: pre-BOT-support the table was discarded unconditionally,
            # and single-frame files never need it — treat it as empty so
            # multi-frame grouping falls back to SOI scanning
            if length % 4 == 0 and length:
                bot = list(struct.unpack_from(f"<{length // 4}I", r.buf, r.pos))
            base = r.pos + length  # offsets count from the byte after the BOT
        else:
            offsets.append(tag_pos - base)
            fragments.append(r.buf[r.pos : r.pos + length])
        first = False
        r.pos += length
    raise DicomParseError("encapsulated PixelData missing sequence delimiter")


def _parse_dataset(
    buf: bytes, explicit: bool, want_pixels: bool, encapsulated: bool = False,
    big: bool = False,
) -> Tuple[Dict[Tuple[int, int], bytes], Optional[bytes]]:
    """Returns (meta, pixel_data); pixel_data is ``bytes`` for native
    PixelData, a ``list`` of fragment byte strings when encapsulated."""
    r = _Reader(buf, explicit, big)
    meta: Dict[Tuple[int, int], bytes] = {}
    pixel_data = None
    while not r.atend():
        group, elem, vr, length = r.element()
        if (group, elem) == (0x7FE0, 0x0010):
            if length == 0xFFFFFFFF:
                if not encapsulated:
                    raise DicomParseError(
                        "encapsulated PixelData under an uncompressed "
                        "transfer-syntax UID (malformed file); transcode to "
                        "explicit VR little endian (gdcmconv --raw, or "
                        "dcmdjpeg/dcmconv +te)"
                    )
                frags = _read_fragments(r)
                pixel_data = frags if want_pixels else None
                continue
            pixel_data = r.buf[r.pos : r.pos + length] if want_pixels else None
            r.pos += length
            continue
        if length == 0xFFFFFFFF:
            r.skip_sequence()
            continue
        if vr == b"SQ":
            r.pos += length
            continue
        if group == 0xFFFE:
            r.pos += length
            continue
        if length > len(r.buf) - r.pos:
            raise DicomParseError(
                f"element ({group:04x},{elem:04x}) length {length} overruns file"
            )
        meta[(group, elem)] = r.buf[r.pos : r.pos + length]
        r.pos += length
    return meta, pixel_data


def _meta_int(meta, tag, default=None, big: bool = False) -> Optional[int]:
    v = meta.get(tag)
    if v is None:
        return default
    if len(v) == 2:
        return struct.unpack(">H" if big else "<H", v)[0]
    if len(v) == 4:
        return struct.unpack(">I" if big else "<I", v)[0]
    try:
        return int(v.decode("ascii").strip("\x00 "))
    except (UnicodeDecodeError, ValueError):
        return default


def _meta_int_str(meta, tag, default: Optional[int] = None) -> Optional[int]:
    """Integer-String (IS) tag value. NOT _meta_int: a 2-byte IS like b"3 "
    would satisfy its len==2 branch and misparse as a binary uint16.
    Strictly [+-]?digits after pad stripping — int()'s extra tolerance
    (embedded newlines, unicode digits) would diverge from the native
    reader's stol on corrupt values, and the differential fuzz holds the
    two readers to byte-identical acceptance."""
    v = meta.get(tag)
    if v is None:
        return default
    try:
        s = v.decode("ascii").strip("\x00 ")
    except UnicodeDecodeError:
        return default
    body = s[1:] if s[:1] in ("+", "-") else s
    if not body.isdigit():  # exactly one optional sign, then digits
        return default
    return int(s)


def _meta_float(meta, tag, default: float) -> float:
    v = meta.get(tag)
    if v is None:
        return default
    try:
        return float(v.decode("ascii").strip("\x00 "))
    except (UnicodeDecodeError, ValueError):
        return default


def _frame_payload(fragments: list, frame: int, nframes: int) -> bytes:
    """One frame's concatenated JPEG-family codestream.

    Single-frame: all fragments join (a frame may span fragments).
    Multi-frame: when the file carries a non-empty Basic Offset Table, the
    BOT is the AUTHORITATIVE frame-boundary source (PS3.5 §A.4: one offset
    per frame, pointing at the item tag of the frame's first fragment) —
    SOI-marker scanning is only the fallback for an empty BOT, because a
    fragment boundary can coincidentally land on bytes that look like an
    SOI (e.g. inside a COM/APPn segment), mis-splitting the stream.
    """
    if nframes <= 1:
        return b"".join(fragments)
    bot = getattr(fragments, "bot", None)
    offsets = getattr(fragments, "offsets", None)
    if bot:
        if len(bot) != nframes:
            raise DicomParseError(
                f"Basic Offset Table has {len(bot)} entries for "
                f"NumberOfFrames={nframes}"
            )
        starts: list = []
        for off in bot:
            try:
                starts.append(offsets.index(off))
            except ValueError:
                raise DicomParseError(
                    f"Basic Offset Table offset {off} does not fall on a "
                    "fragment boundary"
                ) from None
        if starts[0] != 0 or any(
            b <= a for a, b in zip(starts, starts[1:])
        ):
            raise DicomParseError(
                "Basic Offset Table offsets are not strictly increasing "
                "from the first fragment"
            )
        bounds = starts + [len(fragments)]
        return b"".join(fragments[bounds[frame] : bounds[frame + 1]])
    groups: list = []
    for frag in fragments:
        if frag[:2] == b"\xff\xd8" or not groups:
            groups.append([frag])
        else:
            groups[-1].append(frag)
    if len(groups) != nframes:
        raise DicomParseError(
            f"found {len(groups)} JPEG codestreams for "
            f"NumberOfFrames={nframes}"
        )
    return b"".join(groups[frame])


def _decode_compressed(
    transfer_syntax: str, fragments: list, rows: int, cols: int,
    dtype: np.dtype, frame: int = 0, nframes: int = 1,
) -> np.ndarray:
    """Decode one frame of encapsulated PixelData -> (rows, cols) ``dtype``.

    Single-frame files follow the reference importer's one-slice contract
    (setLoadSeries(false)); multi-frame files (real-archive shape) select
    ``frame`` of ``nframes``. RLE uses exactly one fragment per frame
    (PS3.5 §A.4.2); a JPEG/JPEG-LS frame may span fragments, so frames are
    delimited by their SOI markers and each frame's fragments concatenate.
    """
    from nm03_capstone_project_tpu_torch.data import codecs

    if not fragments:
        raise DicomParseError("encapsulated PixelData has no fragments")
    # a hostile file declaring 65535x65535 must fail here, not after
    # rle_decode_frame's replicate pass expands fragments into a multi-GB
    # host buffer
    _check_frame_bounds(rows, cols, dtype.itemsize)
    try:
        if transfer_syntax == RLE_LOSSLESS:
            if len(fragments) != nframes:
                raise DicomParseError(
                    f"{len(fragments)} RLE fragments for NumberOfFrames="
                    f"{nframes}: PS3.5 A.4.2 requires exactly one per frame"
                )
            arr = codecs.rle_decode_frame(
                fragments[frame], rows, cols, dtype.itemsize
            )
        elif transfer_syntax in (JPEG_LOSSLESS, JPEG_LOSSLESS_SV1,
                                 JPEG_LS_LOSSLESS, JPEG_LS_NEAR):
            jls = transfer_syntax in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR)
            decode = codecs.jpegls_decode if jls else codecs.jpeg_lossless_decode
            payload = _frame_payload(fragments, frame, nframes)
            arr = decode(payload, expect_shape=(rows, cols))
            if dtype.itemsize == 1:
                if arr.max(initial=0) > 0xFF:
                    raise DicomParseError(
                        ("JPEG-LS" if jls else "lossless JPEG")
                        + " precision exceeds BitsAllocated=8"
                    )
                arr = arr.astype(np.uint8)
        else:  # JPEG_BASELINE — lossy 8-bit, decoded by PIL
            import io

            from PIL import Image

            if dtype.itemsize != 1:
                raise DicomParseError(
                    "baseline JPEG (1.2.840.10008.1.2.4.50) is 8-bit only, "
                    f"but BitsAllocated={dtype.itemsize * 8}"
                )
            payload = _frame_payload(fragments, frame, nframes)
            try:
                img = Image.open(io.BytesIO(payload))
                arr = np.asarray(img.convert("L"), np.uint8)
            except (OSError, ValueError, Image.DecompressionBombError) as e:
                # PIL raises UnidentifiedImageError (an OSError) on corrupt
                # streams and DecompressionBombError (a bare Exception
                # subclass) on hostile declared dimensions; the importer
                # contract is DicomParseError only
                raise DicomParseError(f"baseline JPEG decode failed: {e}") from e
    except codecs.CodecError as e:
        raise DicomParseError(f"compressed PixelData decode failed: {e}") from e
    if arr.shape != (rows, cols):
        raise DicomParseError(
            f"compressed frame is {arr.shape}, header says ({rows}, {cols})"
        )
    # signed data: the decoded planes carry the raw two's-complement bits
    return arr.view(dtype) if dtype.itemsize == arr.dtype.itemsize else arr.astype(dtype)


def read_dicom(path: str | os.PathLike, frame: int = 0) -> DicomSlice:
    """Read one 2D DICOM slice, returning float32 rescaled intensities.

    Mirrors the reference importer's contract: exactly one 2D image per file
    (DICOMFileImporter with setLoadSeries(false), test_pipeline.cpp:38-41).
    Real archives also carry multi-frame files (NumberOfFrames > 1):
    ``frame`` selects which 2D frame decodes — the default 0 keeps the
    one-slice contract while letting multi-frame archives import instead of
    rejecting. The slice's ``num_frames`` property reports the count; use
    :func:`read_dicom_frames` to materialize a whole stack without
    re-parsing the file per frame.
    """
    with open(path, "rb") as f:
        raw = f.read()
    return read_dicom_bytes(raw, frame, path=path)


def read_dicom_bytes(raw: bytes, frame: int = 0, path="<bytes>") -> DicomSlice:
    """:func:`read_dicom` from an in-memory byte string.

    The fault-injection layer (resilience.faultinject) decodes
    deterministically corrupted file images through this entry point so the
    REAL parser's rejection path is what the chaos tests exercise; also
    useful anywhere the caller already holds the file bytes. ``path`` is a
    provenance hint — it must be the real on-disk path for the J2K shim
    route (the GDCM fallback re-reads the file itself).
    """
    ctx = _open_dataset(raw, path)
    if isinstance(ctx, DicomSlice):  # J2K shim path (single-frame)
        if frame != 0:
            raise DicomParseError(
                f"frame {frame} out of range (NumberOfFrames=1)"
            )
        return ctx
    return _materialize_frame(ctx, frame)


def read_dicom_frames(path: str | os.PathLike, strict: bool = True) -> list:
    """Every frame of a (possibly multi-frame) file, parsed ONCE.

    Single-frame files return a one-element list; archives that store a
    whole series as a single multi-frame file expand into their z-stack
    (the volume driver consumes this). ``strict=False`` substitutes the
    DicomParseError for frames whose decode fails instead of raising —
    per-frame containment for drivers that skip-and-continue, with the
    failure reason preserved.
    """
    with open(path, "rb") as f:
        raw = f.read()
    ctx = _open_dataset(raw, path)
    if isinstance(ctx, DicomSlice):
        return [ctx]
    out = []
    for k in range(ctx["nframes"]):
        try:
            out.append(_materialize_frame(ctx, k))
        except DicomParseError as e:
            if strict:
                raise
            # the EXCEPTION stands in for the frame so skip-and-continue
            # callers can still report WHY a frame was dropped
            out.append(e)
    return out


def _open_dataset(raw: bytes, path) -> "dict | DicomSlice":
    """Parse preamble/meta/dataset once; the frame-independent half of
    :func:`read_dicom`. Returns the decode context, or a finished
    DicomSlice for the GDCM-shimmed J2K path (which decodes whole)."""
    # Part-10 preamble, or a bare dataset
    body = raw
    transfer_syntax = EXPLICIT_VR_LE
    if len(raw) >= 132 and raw[128:132] == b"DICM":
        # file meta group is always explicit VR LE
        r = _Reader(raw, explicit=True)
        r.pos = 132
        meta_end = len(raw)
        first = True
        while r.pos < meta_end and not r.atend():
            mark = r.pos
            try:
                group, elem, vr, length = r.element()
            except struct.error as e:
                # a file truncated inside a meta element header must reject
                # cleanly, like the dataset-side parse below
                raise DicomParseError(f"truncated file meta group: {e}") from e
            if group != 0x0002:
                r.pos = mark
                break
            value = r.buf[r.pos : r.pos + length]
            r.pos += length
            if first and (group, elem) == (0x0002, 0x0000) and len(value) == 4:
                meta_end = r.pos + struct.unpack("<I", value)[0]
            if (group, elem) == (0x0002, 0x0010):
                # errors="replace": corrupt bytes yield a UID that matches no
                # known syntax and is rejected cleanly, instead of a
                # UnicodeDecodeError escaping the DicomParseError contract
                transfer_syntax = value.decode("ascii", "replace").strip("\x00 ")
            first = False
        body = raw[r.pos :]
    elif raw[:4] == b"DICM":
        body = raw[4:]
    if transfer_syntax == DEFLATED_EXPLICIT_VR_LE:
        # PS3.5 A.5: everything after the file meta group is one raw
        # (headerless) zlib-deflate stream of an explicit VR LE dataset.
        # Bounded inflate: a crafted bomb must hit the same ~2^28 envelope
        # cap as every other path, as a clean DicomParseError, not an OOM.
        import zlib

        limit = (1 << 28) + (1 << 20)  # pixel envelope + header slack
        d = zlib.decompressobj(wbits=-15)
        try:
            body = d.decompress(body, limit)
        except zlib.error as e:
            raise DicomParseError(f"deflated dataset inflate failed: {e}") from e
        if d.unconsumed_tail:
            raise DicomParseError(
                "deflated dataset exceeds the importer size bound"
            )
        transfer_syntax = EXPLICIT_VR_LE
    encapsulated = transfer_syntax in _DECODABLE_ENCAPSULATED
    big = transfer_syntax == EXPLICIT_VR_BE
    if transfer_syntax in _J2K_SYNTAXES:
        # JPEG 2000: the one family without an in-tree codec. Routed through
        # the optional GDCM shim (data/gdcm_fallback.py) when the system has
        # it — the same sit-on-a-system-library judgment the reference makes
        # with DCMTK — else rejected with the transcode remedy below.
        from nm03_capstone_project_tpu_torch.data import gdcm_fallback

        if gdcm_fallback.available():
            try:
                meta, _ = _parse_dataset(
                    body, explicit=True, want_pixels=False, encapsulated=True
                )
            except struct.error as e:
                raise DicomParseError(
                    f"truncated DICOM element structure: {e}"
                ) from e
            rows = _meta_int(meta, (0x0028, 0x0010))
            cols = _meta_int(meta, (0x0028, 0x0011))
            _check_frame_bounds(rows, cols, 2)
            pi = _photometric(meta)
            if (_meta_int_str(meta, (0x0028, 0x0008), 1) or 1) > 1:
                # the shim decodes whole files; serving frame 0 of a
                # multi-frame J2K would silently drop planes (and
                # num_frames would lie about the iteration range)
                raise DicomParseError(
                    "multi-frame JPEG 2000 is out of envelope; transcode "
                    "with gdcmconv --raw first"
                )
            try:
                pixels, raw_dtype = gdcm_fallback.read_j2k(path, rows, cols)
            except ValueError as e:
                raise DicomParseError(str(e)) from e
            slope = _meta_float(meta, (0x0028, 0x1053), 1.0)
            intercept = _meta_float(meta, (0x0028, 0x1052), 0.0)
            if pi == "MONOCHROME1":
                # the shim already applied rescale, so invert in rescaled
                # space: (base - raw)*s + i == base*s + 2i - (raw*s + i)
                j2k_bits = _meta_int(meta, (0x0028, 0x0100), 16)
                bits_stored = _meta_int(meta, (0x0028, 0x0101), j2k_bits)
                if not (1 <= bits_stored <= j2k_bits <= 16):
                    raise DicomParseError(
                        f"BitsStored {bits_stored} outside "
                        f"[1, BitsAllocated={j2k_bits}]"
                    )
                j2k_signed = _meta_int(meta, (0x0028, 0x0103), 0) == 1
                base = _inversion_base(j2k_signed, bits_stored)
                pixels = np.float32(base * slope + 2 * intercept) - pixels
            return DicomSlice(
                pixels=pixels,
                rows=rows,
                cols=cols,
                raw_dtype=raw_dtype,
                rescale_slope=slope,
                rescale_intercept=intercept,
                meta=meta,
            )
    if (
        transfer_syntax not in (EXPLICIT_VR_LE, IMPLICIT_VR_LE, EXPLICIT_VR_BE)
        and not encapsulated
    ):
        kind = (
            "compressed"
            if transfer_syntax.startswith("1.2.840.10008.1.2.4")
            else "unrecognized"
        )
        raise DicomParseError(
            f"unsupported ({kind}) transfer syntax {transfer_syntax}: "
            "supported are uncompressed little/big endian "
            f"({EXPLICIT_VR_LE} / {IMPLICIT_VR_LE} / {EXPLICIT_VR_BE}), "
            f"RLE ({RLE_LOSSLESS}), "
            f"JPEG lossless ({JPEG_LOSSLESS} / {JPEG_LOSSLESS_SV1}), "
            f"JPEG-LS ({JPEG_LS_LOSSLESS} / {JPEG_LS_NEAR}) and "
            f"baseline JPEG ({JPEG_BASELINE}); transcode first "
            "(gdcmconv --raw, or DCMTK dcmdjpeg/dcmconv +te)"
        )

    explicit = transfer_syntax != IMPLICIT_VR_LE
    try:
        meta, pixel_data = _parse_dataset(
            body, explicit, want_pixels=True, encapsulated=encapsulated,
            big=big,
        )
    except struct.error as e:
        raise DicomParseError(f"truncated DICOM element structure: {e}") from e

    rows = _meta_int(meta, (0x0028, 0x0010), big=big)
    cols = _meta_int(meta, (0x0028, 0x0011), big=big)
    if rows is None or cols is None or pixel_data is None:
        raise DicomParseError("missing Rows/Columns/PixelData")
    if encapsulated and not isinstance(pixel_data, list):
        raise DicomParseError(
            f"transfer syntax {transfer_syntax} declares compressed pixels "
            "but PixelData is native/uncompressed (malformed file)"
        )
    bits = _meta_int(meta, (0x0028, 0x0100), 16, big=big)
    signed = _meta_int(meta, (0x0028, 0x0103), 0, big=big) == 1
    samples = _meta_int(meta, (0x0028, 0x0002), 1, big=big)
    if samples != 1:
        raise DicomParseError(
            f"only monochrome supported, SamplesPerPixel={samples}; convert "
            "color/multi-sample images to grayscale before import"
        )
    pi = _photometric(meta)
    if bits == 16:
        order = ">" if big else "<"
        dtype = np.dtype(order + ("i2" if signed else "u2"))
    elif bits == 8:
        dtype = np.dtype("i1") if signed else np.dtype("u1")
    else:
        raise DicomParseError(f"unsupported BitsAllocated={bits}")

    nframes = _meta_int_str(meta, (0x0028, 0x0008), 1)
    if nframes is None or nframes < 1:
        nframes = 1
    return {
        "transfer_syntax": transfer_syntax,
        "meta": meta,
        "pixel_data": pixel_data,
        "rows": rows,
        "cols": cols,
        "bits": bits,
        "signed": signed,
        "pi": pi,
        "dtype": dtype,
        "big": big,
        "nframes": nframes,
    }


def _materialize_frame(ctx: dict, frame: int) -> DicomSlice:
    """Decode + post-process ONE frame from an :func:`_open_dataset` context."""
    transfer_syntax = ctx["transfer_syntax"]
    meta = ctx["meta"]
    pixel_data = ctx["pixel_data"]
    rows, cols = ctx["rows"], ctx["cols"]
    bits, signed, pi = ctx["bits"], ctx["signed"], ctx["pi"]
    dtype, big, nframes = ctx["dtype"], ctx["big"], ctx["nframes"]
    if not 0 <= frame < nframes:
        raise DicomParseError(
            f"frame {frame} out of range (NumberOfFrames={nframes})"
        )
    if isinstance(pixel_data, list):  # encapsulated fragments
        pixels = _decode_compressed(
            transfer_syntax, pixel_data, rows, cols, dtype,
            frame=frame, nframes=nframes,
        )
    else:
        fsize = rows * cols * dtype.itemsize
        expected = fsize * nframes
        if len(pixel_data) < expected:
            raise DicomParseError(
                f"PixelData has {len(pixel_data)} bytes, expected {expected}"
                + (f" ({nframes} frames)" if nframes > 1 else "")
            )
        pixels = np.frombuffer(
            pixel_data[frame * fsize : (frame + 1) * fsize], dtype=dtype
        ).reshape(rows, cols)

    slope = _meta_float(meta, (0x0028, 0x1053), 1.0)
    intercept = _meta_float(meta, (0x0028, 0x1052), 0.0)
    bits_stored = _meta_int(meta, (0x0028, 0x0101), bits, big=big)
    if not (1 <= bits_stored <= bits):
        raise DicomParseError(
            f"BitsStored {bits_stored} outside [1, BitsAllocated={bits}]"
        )
    high_bit = _meta_int(meta, (0x0028, 0x0102), bits_stored - 1, big=big)
    if high_bit != bits_stored - 1:
        # standard layout only (PS3.5 8.1.1: HighBit = BitsStored-1);
        # exotic packings would silently misread, so reject with a remedy
        raise DicomParseError(
            f"HighBit {high_bit} != BitsStored-1 ({bits_stored - 1}); "
            "repack with gdcmconv/dcmconv before import"
        )
    if bits_stored < bits:
        # bits above BitsStored are overlay planes / garbage in historical
        # files: mask them off (unsigned) or sign-extend from the stored
        # sign bit (signed), as DCMTK's DicomImage does
        v = pixels.astype(np.int64) & ((1 << bits_stored) - 1)
        if signed:
            sign = 1 << (bits_stored - 1)
            v = (v ^ sign) - sign
        pixels = v
    if pi == "MONOCHROME1":
        # inverted grayscale (PS3.3 C.7.6.3.1.2: lowest stored value =
        # white): normalize to MONOCHROME2 semantics on the STORED values,
        # before rescale, so intensity thresholds mean the same thing on
        # every file (DCMTK's DicomImage applies the same inversion)
        pixels = _inversion_base(signed, bits_stored) - pixels.astype(np.int64)
    out = pixels.astype(np.float32) * np.float32(slope) + np.float32(intercept)
    return DicomSlice(
        pixels=out,
        rows=rows,
        cols=cols,
        raw_dtype=dtype,
        rescale_slope=slope,
        rescale_intercept=intercept,
        meta=meta,
    )


# ---------------------------------------------------------------------------
# Writer (explicit VR little endian)
# ---------------------------------------------------------------------------


def _element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2 == 1:
        value += b" " if vr in (b"UI", b"DS", b"IS", b"CS", b"LO", b"PN", b"SH") else b"\x00"
    head = struct.pack("<HH", group, elem) + vr
    if vr in _LONG_VRS:
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def _encapsulate(frame: bytes) -> bytes:
    """Encapsulated PixelData value: empty Basic Offset Table item, one
    fragment item (even-padded), sequence delimiter (PS3.5 §A.4)."""
    if len(frame) % 2:
        frame += b"\x00"
    return (
        struct.pack("<HHI", *_ITEM, 0)
        + struct.pack("<HHI", *_ITEM, len(frame))
        + frame
        + struct.pack("<HHI", *_SEQ_DELIM, 0)
    )


def write_dicom(
    path: str | os.PathLike,
    pixels: np.ndarray,
    *,
    patient_id: str = "ANON",
    series_uid: str = "1.2.826.0.1.3680043.9999.1",
    instance_number: int = 1,
    rescale_slope: float = 1.0,
    rescale_intercept: float = 0.0,
    transfer_syntax: str = EXPLICIT_VR_LE,
    jpegls_near: int = 2,
) -> None:
    """Write a monochrome uint16 slice as a Part-10 file.

    ``transfer_syntax`` may be EXPLICIT_VR_LE (native pixels), RLE_LOSSLESS,
    JPEG_LOSSLESS_SV1 or JPEG_LS_LOSSLESS (encapsulated, bit-exact round
    trip through data/codecs.py — the importer-parity test data for the
    compressed envelope), or JPEG_LS_NEAR (near-lossless: stored values
    reconstruct within ±``jpegls_near`` of the input, identically in every
    conformant decoder)."""
    if pixels.ndim != 2:
        raise ValueError(f"expected 2D pixels, got {pixels.shape}")
    if transfer_syntax not in (EXPLICIT_VR_LE, RLE_LOSSLESS,
                               JPEG_LOSSLESS_SV1, JPEG_LS_LOSSLESS,
                               JPEG_LS_NEAR):
        raise ValueError(f"writer does not support transfer syntax {transfer_syntax}")
    if transfer_syntax == JPEG_LS_NEAR and jpegls_near < 1:
        raise ValueError("JPEG_LS_NEAR requires jpegls_near >= 1 (use "
                         "JPEG_LS_LOSSLESS for exact storage)")
    data = np.ascontiguousarray(pixels.astype("<u2"))
    rows, cols = data.shape

    sop_uid = f"{series_uid}.{instance_number}"
    meta_elems = _element(0x0002, 0x0010, b"UI", transfer_syntax.encode())
    meta_group = (
        _element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_elems)))
        + meta_elems
    )

    if transfer_syntax == RLE_LOSSLESS:
        from nm03_capstone_project_tpu_torch.data import codecs

        pix_elem = (
            struct.pack("<HH", 0x7FE0, 0x0010)
            + b"OB\x00\x00"
            + struct.pack("<I", 0xFFFFFFFF)
            + _encapsulate(codecs.rle_encode_frame(data))
        )
    elif transfer_syntax == JPEG_LOSSLESS_SV1:
        from nm03_capstone_project_tpu_torch.data import codecs

        pix_elem = (
            struct.pack("<HH", 0x7FE0, 0x0010)
            + b"OB\x00\x00"
            + struct.pack("<I", 0xFFFFFFFF)
            + _encapsulate(codecs.jpeg_lossless_encode(data))
        )
    elif transfer_syntax in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR):
        from nm03_capstone_project_tpu_torch.data import codecs

        near = jpegls_near if transfer_syntax == JPEG_LS_NEAR else 0
        pix_elem = (
            struct.pack("<HH", 0x7FE0, 0x0010)
            + b"OB\x00\x00"
            + struct.pack("<I", 0xFFFFFFFF)
            # precision pinned to BitsStored=16 (PS3.5 A.4.3: codestream
            # precision must match the dataset's Bits Stored)
            + _encapsulate(codecs.jpegls_encode(data, precision=16, near=near))
        )
    else:
        pix_elem = _element(0x7FE0, 0x0010, b"OW", data.tobytes())
    ds = b"".join(
        [
            _element(0x0008, 0x0016, b"UI", b"1.2.840.10008.5.1.4.1.1.4"),  # MR
            _element(0x0008, 0x0018, b"UI", sop_uid.encode()),
            _element(0x0010, 0x0020, b"LO", patient_id.encode()),
            _element(0x0020, 0x000E, b"UI", series_uid.encode()),
            _element(0x0020, 0x0013, b"IS", str(instance_number).encode()),
            _element(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
            _element(0x0028, 0x0004, b"CS", b"MONOCHROME2"),
            _element(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
            _element(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
            _element(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            _element(0x0028, 0x0101, b"US", struct.pack("<H", 16)),
            _element(0x0028, 0x0102, b"US", struct.pack("<H", 15)),
            _element(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
            _element(0x0028, 0x1052, b"DS", f"{rescale_intercept:g}".encode()),
            _element(0x0028, 0x1053, b"DS", f"{rescale_slope:g}".encode()),
            # near-lossless storage is LOSSY: PS3.3 C.7.6.1.1.5 mandates
            # declaring it, or a later transcode to a lossless syntax would
            # launder the ±near error into data claimed exact
            (
                _element(0x0028, 0x2110, b"CS", b"01")
                + _element(0x0028, 0x2114, b"CS", b"ISO_14495_1 ")
                if transfer_syntax == JPEG_LS_NEAR
                else b""
            ),
            pix_elem,
        ]
    )

    # atomic (NM351): synthetic cohorts are cached on disk and reused by
    # later runs (resolve_base_path skips regeneration for a non-empty
    # tree) — a torn .dcm from a killed generator would poison every rerun
    from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_bytes

    atomic_write_bytes(path, b"\x00" * 128 + b"DICM" + meta_group + ds)
