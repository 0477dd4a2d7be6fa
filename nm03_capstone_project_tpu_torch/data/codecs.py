"""Compressed-pixel codecs for the DICOM importer (host-side, pure Python).

The port's copy of the JAX package's ``data/codecs.py``. FAST sits on DCMTK
(reference src/include/FAST/FAST_directives.hpp:30 via ``DICOMFileImporter``)
and reads compressed transfer syntaxes; dicomlite previously rejected them
all with transcode instructions. This module implements the two lossless
families that dominate medical archives — both bit-exact, so the decoded
float32 slice is identical to the uncompressed path:

* **RLE Lossless** (1.2.840.10008.1.2.5): the DICOM PackBits variant,
  PS3.5 §8.2.2 + Annex G — a 64-byte segment-offset header, one
  byte-plane segment per sample byte (MSB plane first), each PackBits
  run-length coded. Encoder + decoder (the encoder backs the writer's
  round-trip tests and ``write_dicom(..., transfer_syntax=RLE_LOSSLESS)``).

* **JPEG Lossless, Non-Hierarchical** (1.2.840.10008.1.2.4.57 and the
  first-order-prediction .70 that DCMTK emits by default): ITU-T T.81
  process 14, SOF3 — Huffman-coded prediction residuals, any selection
  value 1-7, point transform, 2-16 bit precision, single component.
  Decoder is general; the encoder emits selection value 1 (SV1), the .70
  profile.

Baseline 8-bit JPEG (1.2.840.10008.1.2.4.50, lossy) is handled in
dicomlite via PIL — re-implementing a lossy DCT decoder buys no exactness
and PIL ships in the image.

These run on the host IO path (decode feeds the host->HBM prefetch queue),
not on the device: entropy decoding is branchy byte-chasing, the shape
of work an accelerator cannot express well. NumPy vectorization keeps the
byte-plane recomposition and prediction sweeps array-shaped.
"""

from __future__ import annotations

import struct

import numpy as np


class CodecError(ValueError):
    """Raised when a compressed pixel stream is malformed."""


# ---------------------------------------------------------------------------
# RLE Lossless (PS3.5 Annex G)
# ---------------------------------------------------------------------------


def packbits_decode(seg: bytes, expected: int) -> bytes:
    """Decode one PackBits-coded RLE segment to exactly ``expected`` bytes."""
    out = bytearray()
    i, n = 0, len(seg)
    while i < n and len(out) < expected:
        ctrl = seg[i]
        i += 1
        if ctrl < 128:  # literal run: copy next ctrl+1 bytes
            j = i + ctrl + 1
            if j > n:
                raise CodecError("RLE literal run overruns segment")
            out += seg[i:j]
            i = j
        elif ctrl > 128:  # replicate run: next byte repeated 257-ctrl times
            if i >= n:
                raise CodecError("RLE replicate run missing its byte")
            out += seg[i : i + 1] * (257 - ctrl)
            i += 1
        # ctrl == 128: no-op (spec: reserved, skip)
    if len(out) < expected:
        raise CodecError(f"RLE segment decoded {len(out)} bytes, expected {expected}")
    return bytes(out[:expected])


def packbits_encode(seg: bytes) -> bytes:
    """PackBits-encode one byte plane (replicate runs >= 3, literals else)."""
    out = bytearray()
    i, n = 0, len(seg)
    while i < n:
        run = 1
        while i + run < n and run < 128 and seg[i + run] == seg[i]:
            run += 1
        if run >= 3:
            out += bytes((257 - run, seg[i]))
            i += run
            continue
        # literal: extend until a >=3 replicate run starts (or 128 bytes)
        j = i + run
        while j < n and j - i < 128:
            r = 1
            while j + r < n and r < 3 and seg[j + r] == seg[j]:
                r += 1
            if r >= 3:
                break
            j += r
        j = min(j, i + 128)
        out += bytes((j - i - 1,)) + seg[i:j]
        i = j
    if len(out) % 2:
        out.append(0)  # segments are padded to even length (Annex G.3.1)
    return bytes(out)


def rle_decode_frame(frame: bytes, rows: int, cols: int, itemsize: int) -> np.ndarray:
    """Decode one RLE frame -> uint8/uint16 (rows, cols) array.

    Segments are byte planes of the composite pixel code, most-significant
    plane first (Annex G.2), so a 16-bit image recomposes as
    ``(plane0 << 8) | plane1``.
    """
    if len(frame) < 64:
        raise CodecError("RLE frame shorter than its 64-byte header")
    header = struct.unpack_from("<16I", frame, 0)
    nseg = header[0]
    if nseg != itemsize:
        raise CodecError(
            f"RLE frame has {nseg} segments, expected {itemsize} "
            "(one byte plane per sample byte, monochrome)"
        )
    offsets = list(header[1 : 1 + nseg])
    if any(o < 64 or o > len(frame) for o in offsets) or sorted(offsets) != offsets:
        raise CodecError(f"RLE segment offsets invalid: {offsets}")
    npix = rows * cols
    planes = []
    for i, off in enumerate(offsets):
        end = offsets[i + 1] if i + 1 < nseg else len(frame)
        planes.append(
            np.frombuffer(packbits_decode(frame[off:end], npix), np.uint8)
        )
    if itemsize == 1:
        return planes[0].reshape(rows, cols).copy()
    return (
        (planes[0].astype(np.uint16) << 8) | planes[1].astype(np.uint16)
    ).reshape(rows, cols)


def rle_encode_frame(pixels: np.ndarray) -> bytes:
    """Encode a uint8/uint16 (rows, cols) array as one RLE frame."""
    if pixels.dtype == np.uint16:
        flat = pixels.ravel()
        planes = [(flat >> 8).astype(np.uint8).tobytes(), (flat & 0xFF).astype(np.uint8).tobytes()]
    elif pixels.dtype == np.uint8:
        planes = [pixels.ravel().tobytes()]
    else:
        raise CodecError(f"RLE encoder expects uint8/uint16, got {pixels.dtype}")
    segs = [packbits_encode(p) for p in planes]
    offsets, pos = [], 64
    for s in segs:
        offsets.append(pos)
        pos += len(s)
    header = struct.pack(
        "<16I", len(segs), *offsets, *([0] * (15 - len(segs)))
    )
    return header + b"".join(segs)


# ---------------------------------------------------------------------------
# JPEG Lossless (ITU-T T.81 process 14, SOF3)
# ---------------------------------------------------------------------------

_SOI, _EOI, _SOF3, _DHT, _SOS = 0xD8, 0xD9, 0xC3, 0xC4, 0xDA


class _BitReader:
    """MSB-first bit reader over entropy-coded data with FF00 byte stuffing."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.bits = 0
        self.nbits = 0

    def read_bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.buf):
                raise CodecError("JPEG entropy data truncated")
            b = self.buf[self.pos]
            self.pos += 1
            if b == 0xFF:
                if self.pos >= len(self.buf):
                    raise CodecError("JPEG entropy data truncated at FF")
                nxt = self.buf[self.pos]
                if nxt == 0x00:
                    self.pos += 1  # stuffed byte
                else:
                    # a real marker mid-scan (e.g. premature EOI)
                    raise CodecError(f"unexpected JPEG marker FF{nxt:02x} in scan")
            self.bits = b
            self.nbits = 8
        self.nbits -= 1
        return (self.bits >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


def _build_huffman(bits_counts, values):
    """Canonical Huffman -> {(length, code): value} (T.81 Annex C)."""
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits_counts[length - 1]):
            table[(length, code)] = values[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _huff_decode(reader: _BitReader, table) -> int:
    code, length = 0, 0
    while length < 16:
        code = (code << 1) | reader.read_bit()
        length += 1
        v = table.get((length, code))
        if v is not None:
            return v
    raise CodecError("invalid JPEG Huffman code")


def _extend(bits: int, ssss: int) -> int:
    """T.81 F.2.2.1: map SSSS magnitude bits to a signed difference."""
    if ssss == 0:
        return 0
    if ssss == 16:
        return 32768  # no magnitude bits follow (lossless-mode special case)
    if bits < (1 << (ssss - 1)):
        return bits - (1 << ssss) + 1
    return bits


def jpeg_lossless_decode(data: bytes, expect_shape=None) -> np.ndarray:
    """Decode a single-component lossless JPEG (SOF3) stream.

    Supports any predictor selection value 1-7, point transform, 2-16 bit
    precision; restart intervals are not supported (DCMTK does not emit them
    for single-frame medical images). Returns uint16 (rows, cols).

    ``expect_shape``: when the caller knows the frame dimensions (the DICOM
    header's Rows/Columns), a disagreeing SOF3 is rejected BEFORE the
    output allocates — a corrupt header must not drive a multi-GB
    ``np.zeros`` or a gigapixel decode loop.
    """
    if len(data) < 4 or data[0] != 0xFF or data[1] != _SOI:
        raise CodecError("not a JPEG stream (missing SOI)")
    pos = 2
    precision = rows = cols = None
    huff_tables: dict = {}
    sel = 1
    pt = 0
    table_id = 0
    got_sos = False
    while pos + 2 <= len(data):
        if data[pos] != 0xFF:
            raise CodecError(f"expected JPEG marker at {pos}")
        # optional fill bytes (T.81 B.1.1.2): extra 0xFF may pad any marker
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 2 > len(data):
            raise CodecError("truncated JPEG marker segment")
        marker = data[pos + 1]
        pos += 2
        if marker == _EOI:
            break
        if pos + 2 > len(data):
            raise CodecError("truncated JPEG marker segment")
        seglen = struct.unpack_from(">H", data, pos)[0]
        seg_end = pos + seglen
        if seg_end > len(data):
            raise CodecError("truncated JPEG marker segment")
        body = data[pos + 2 : seg_end]
        if marker == _SOF3:
            if len(body) < 6:
                raise CodecError("short SOF3 segment")
            precision, rows, cols, ncomp = struct.unpack_from(">BHHB", body, 0)
            if ncomp != 1:
                raise CodecError(f"lossless JPEG: expected 1 component, got {ncomp}")
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB):
            raise CodecError(
                f"JPEG SOF{marker - 0xC0} is not lossless process 14 (SOF3)"
            )
        elif marker == _DHT:
            b = 0
            while b < len(body):
                tc_th = body[b]
                counts = list(body[b + 1 : b + 17])
                nvals = sum(counts)
                if (
                    len(counts) < 16
                    or b + 17 + nvals > len(body)
                    or (tc_th >> 4) > 1
                    or (tc_th & 0x0F) > 3
                ):
                    # counts promising more values than the segment holds,
                    # or an out-of-range table class/id (T.81: Tc 0-1,
                    # Th 0-3; the C++ decoder rejects these — acceptance
                    # must agree across implementations)
                    raise CodecError("malformed DHT segment")
                vals = list(body[b + 17 : b + 17 + nvals])
                # key on (class, id): an AC-class table sharing a DC table's
                # destination id is legal T.81 and must not clobber it
                huff_tables[(tc_th >> 4, tc_th & 0x0F)] = _build_huffman(
                    counts, vals
                )
                b += 17 + nvals
        elif marker == _SOS:
            if len(body) < 6:  # ns(1) + 1 comp spec(2) + Ss/Se/AhAl(3)
                raise CodecError("short SOS segment")
            ns = body[0]
            if ns != 1:
                raise CodecError(f"expected 1 scan component, got {ns}")
            table_id = body[2] >> 4  # Td (DC table selects the lossless table)
            sel = body[1 + 2 * ns]  # Ss = predictor selection value
            pt = body[3 + 2 * ns] & 0x0F  # Al = point transform
            got_sos = True
            pos = seg_end
            break  # entropy-coded data follows
        pos = seg_end
    if precision is None or rows is None:
        raise CodecError("JPEG stream missing SOF3 header")
    if not got_sos:
        # without this a SOF3+DHT stream with no scan would decode trailing
        # bytes as entropy data under the default sel/table — an acceptance
        # divergence from the native decoder, which requires a scan header
        # (csrc/nm03native.cpp got_sos check)
        raise CodecError("JPEG stream missing SOS marker")
    if (0, table_id) not in huff_tables:  # lossless scans use DC-class tables
        raise CodecError(f"JPEG scan references undefined Huffman table {table_id}")
    if sel < 1 or sel > 7:
        raise CodecError(f"unsupported lossless predictor selection {sel}")
    if not (2 <= precision <= 16) or pt >= precision:
        # T.81 range; pt >= precision would make the default predictor's
        # shift count negative (a bare ValueError, not CodecError)
        raise CodecError(
            f"invalid JPEG precision/point-transform {precision}/{pt}"
        )
    if expect_shape is not None and (rows, cols) != tuple(expect_shape):
        raise CodecError(
            f"JPEG frame is ({rows}, {cols}), expected {tuple(expect_shape)}"
        )
    if rows <= 0 or cols <= 0 or rows > 32768 or cols > 32768:
        raise CodecError(f"implausible JPEG dimensions ({rows}, {cols})")

    table = huff_tables[(0, table_id)]
    reader = _BitReader(data, pos)
    out = np.zeros((rows, cols), np.int32)
    default = 1 << (precision - pt - 1)
    for y in range(rows):
        row = out[y]
        prev = out[y - 1] if y else None
        for x in range(cols):
            ssss = _huff_decode(reader, table)
            if ssss > 16:
                # DHT values are arbitrary bytes; >16 desyncs the bit
                # stream into silent garbage (C++ decoder has this guard)
                raise CodecError(f"invalid JPEG difference category {ssss}")
            diff = _extend(reader.read_bits(ssss) if 0 < ssss < 16 else 0, ssss)
            if y == 0:
                pred = default if x == 0 else row[x - 1]
            elif x == 0:
                pred = prev[0]
            elif sel == 1:
                pred = row[x - 1]
            elif sel == 2:
                pred = prev[x]
            elif sel == 3:
                pred = prev[x - 1]
            else:
                ra, rb, rc = int(row[x - 1]), int(prev[x]), int(prev[x - 1])
                if sel == 4:
                    pred = ra + rb - rc
                elif sel == 5:
                    pred = ra + ((rb - rc) >> 1)
                elif sel == 6:
                    pred = rb + ((ra - rc) >> 1)
                else:  # sel == 7
                    pred = (ra + rb) >> 1
            row[x] = (int(pred) + diff) & 0xFFFF
    return (out.astype(np.uint16) << pt)


# The encoder's one Huffman table: categories 0..16 all get 5-bit codes
# (17 <= 2^5, and the all-ones 5-bit code 0b11111 stays unused as T.81
# requires). Optimal coding is not the point — bit-exact round-trip is.
_ENC_BITS = [0, 0, 0, 0, 17] + [0] * 11
_ENC_VALUES = list(range(17))


def jpeg_lossless_encode(pixels: np.ndarray, precision: int = 16) -> bytes:
    """Encode uint16 (rows, cols) as lossless JPEG, process 14 SV1 (.70).

    Backs ``write_dicom(..., transfer_syntax=JPEG_LOSSLESS_SV1)`` and the
    importer round-trip tests; decodes bit-exactly with any T.81 process-14
    decoder (verified against our own general decoder).
    """
    if pixels.ndim != 2 or pixels.dtype != np.uint16:
        raise CodecError(f"encoder expects 2D uint16, got {pixels.dtype} {pixels.shape}")
    rows, cols = pixels.shape
    px = pixels.astype(np.int32)
    # SV1 prediction: left neighbour; first row predicts from above;
    # origin predicts the midpoint 2^(P-1)
    pred = np.empty_like(px)
    pred[:, 1:] = px[:, :-1]
    pred[1:, 0] = px[:-1, 0]
    pred[0, 0] = 1 << (precision - 1)
    diffs = (px - pred) & 0xFFFF  # modulo-2^16 difference arithmetic (T.81 H.1)

    out = bytearray(b"\xff\xd8")  # SOI
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes((1, 0x11, 0))
    out += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    dht = bytes((0x00,)) + bytes(_ENC_BITS) + bytes(_ENC_VALUES)
    out += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    sos = bytes((1, 1, 0x00, 1, 0, 0x00))  # 1 comp, Td=Ta=0, Ss=1(SV1), Se=0, Pt=0
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos

    acc, nacc = 0, 0
    body = bytearray()

    def put(value: int, nbits: int):
        nonlocal acc, nacc
        acc = (acc << nbits) | (value & ((1 << nbits) - 1))
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            body.append(byte)
            if byte == 0xFF:
                body.append(0x00)  # byte stuffing

    for d in diffs.ravel():
        d = int(d)
        if d >= 32768:
            d -= 65536  # back to signed [-32768, 32767]
        if d == -32768:
            put(16, 5)  # SSSS=16: diff 32768 == -32768 mod 2^16, no extra bits
            continue
        mag = abs(d)
        ssss = mag.bit_length()
        put(ssss, 5)
        if ssss:
            put(d if d > 0 else d - 1, ssss)  # negative: low bits of d-1
    if nacc:
        put(0x7F, 8 - nacc)  # final-byte padding is 1-bits (T.81 F.1.2.3)
    out += body + b"\xff\xd9"  # EOI
    return bytes(out)


# ---------------------------------------------------------------------------
# JPEG-LS (ITU-T T.87 / ISO 14495-1) — LOCO-I decoder
# ---------------------------------------------------------------------------
# Covers the DICOM transfer syntaxes
# 1.2.840.10008.1.2.4.80 (JPEG-LS Lossless) and .81 (near-lossless), which
# the reference reads through DCMTK (FAST_directives.hpp:30 contract).
# From-scratch implementation of the decoder: marker parse (SOF55/LSE/SOS),
# MED prediction with 365-context bias-corrected Golomb residuals, and
# run mode with run-interruption contexts. Conformance is pinned against
# CharLS-encoded streams (tests/golden/jpegls/, an independent codec), not
# against an encoder in this repo. Single component, interleave none — the
# single-frame grayscale envelope the importer serves.

_SOF55, _LSE = 0xF7, 0xF8
# run-length code order table J (T.87 A.2.1)
_JLS_J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
          4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15]


class _JlsBitReader:
    """MSB-first bit reader with T.87 marker-byte stuffing.

    After an 0xFF byte, the following byte carries only 7 data bits (its MSB
    is a stuffed 0); an 0xFF followed by a byte >= 0x80 is a marker and
    terminates the entropy segment — reading past it is a truncation error,
    never a hang.
    """

    __slots__ = ("data", "pos", "cache", "nbits", "prev_ff")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.cache = 0
        self.nbits = 0
        self.prev_ff = False

    def _fill(self) -> None:
        if self.pos >= len(self.data):
            raise CodecError("truncated JPEG-LS entropy stream")
        b = self.data[self.pos]
        if self.prev_ff:
            if b >= 0x80:  # marker: no more entropy data exists
                raise CodecError("truncated JPEG-LS entropy stream (marker)")
            # a stuffed byte is < 0x80 by construction, so it can never
            # itself re-arm the stuffing state
            self.pos += 1
            self.cache = (self.cache << 7) | b
            self.nbits += 7
            self.prev_ff = False
        else:
            self.pos += 1
            self.cache = (self.cache << 8) | b
            self.nbits += 8
            self.prev_ff = b == 0xFF

    def read_bit(self) -> int:
        if self.nbits == 0:
            self._fill()
        self.nbits -= 1
        bit = (self.cache >> self.nbits) & 1
        # mask the consumed bit out so run-mode streams (which only ever
        # call read_bit) can't grow the cache int without bound — an
        # unmasked cache makes each read O(stream size)
        self.cache &= (1 << self.nbits) - 1
        return bit

    def read_bits(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        self.nbits -= n
        val = (self.cache >> self.nbits) & ((1 << n) - 1)
        self.cache &= (1 << self.nbits) - 1
        return val

    def read_zero_run(self, cap: int) -> int:
        """Count 0 bits until the terminating 1 (consumed); error past cap."""
        z = 0
        while True:
            if self.read_bit():
                return z
            z += 1
            if z > cap:
                # corrupt streams must not degenerate into scanning the
                # whole buffer bit by bit
                raise CodecError("JPEG-LS Golomb prefix exceeds code limit")


def _jls_default_thresholds(maxval: int, near: int):
    """Default T1/T2/T3/RESET (T.87 C.2.4.1.1.1)."""

    def clamp(i, j):
        return j if (i > maxval or i < j) else i

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3, 64


def _jls_parse_header(data: bytes):
    """Parse SOI..SOS; returns frame/coding parameters + entropy offset."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != _SOI:
        raise CodecError("not a JPEG-LS stream (missing SOI)")
    pos = 2
    precision = rows = cols = None
    maxval = t1 = t2 = t3 = reset = None
    near = 0
    while pos + 2 <= len(data):
        if data[pos] != 0xFF:
            raise CodecError(f"expected JPEG-LS marker at {pos}")
        # optional fill bytes (T.81 B.1.1.2, inherited by T.87): any number
        # of extra 0xFF may pad before the marker code
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 2 > len(data):
            raise CodecError("truncated JPEG-LS marker segment")
        marker = data[pos + 1]
        pos += 2
        if marker == _EOI:
            break
        if pos + 2 > len(data):
            raise CodecError("truncated JPEG-LS marker segment")
        seglen = struct.unpack_from(">H", data, pos)[0]
        seg_end = pos + seglen
        if seglen < 2 or seg_end > len(data):
            raise CodecError("truncated JPEG-LS marker segment")
        body = data[pos + 2 : seg_end]
        if marker == _SOF55:
            if len(body) < 6:
                raise CodecError("short SOF55 segment")
            precision, rows, cols, ncomp = struct.unpack_from(">BHHB", body, 0)
            if ncomp != 1:
                raise CodecError(
                    f"JPEG-LS: expected 1 component, got {ncomp} "
                    "(interleaved color is out of the importer envelope)"
                )
        elif marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9,
                        0xCA, 0xCB):
            raise CodecError(f"SOF{marker - 0xC0} is not JPEG-LS (SOF55)")
        elif marker == _LSE:
            if len(body) < 1:
                raise CodecError("empty LSE segment")
            if body[0] == 1:
                if len(body) < 11:
                    raise CodecError("short LSE preset-parameters segment")
                maxval, t1, t2, t3, reset = struct.unpack_from(">HHHHH", body, 1)
            else:
                raise CodecError(
                    f"LSE id {body[0]} (mapping tables / oversize) unsupported"
                )
        elif marker == 0xDD:
            raise CodecError("JPEG-LS restart intervals unsupported")
        elif marker == _SOS:
            if len(body) < 6:
                raise CodecError("short JPEG-LS SOS segment")
            ns = body[0]
            if ns != 1:
                raise CodecError(f"expected 1 scan component, got {ns}")
            if body[2] != 0:
                raise CodecError("JPEG-LS mapping tables unsupported")
            near = body[1 + 2 * ns]
            ilv = body[2 + 2 * ns]
            al = body[3 + 2 * ns] & 0x0F
            if ilv != 0:
                raise CodecError(f"JPEG-LS interleave mode {ilv} unsupported")
            if al != 0:
                raise CodecError("JPEG-LS point transform unsupported")
            if precision is None:
                raise CodecError("JPEG-LS SOS before SOF55")
            return {
                "precision": precision,
                "rows": rows,
                "cols": cols,
                "near": near,
                "maxval": maxval,
                "t1": t1,
                "t2": t2,
                "t3": t3,
                "reset": reset,
                "entropy_at": seg_end,
            }
        pos = seg_end
    raise CodecError("JPEG-LS stream missing " +
                     ("SOS marker" if precision is not None else "SOF55 header"))


def jpegls_decode(data: bytes, expect_shape=None) -> np.ndarray:
    """Decode a single-component JPEG-LS (T.87) stream -> uint16 (rows, cols).

    Lossless and near-lossless (the DICOM .80/.81 syntaxes), default or
    LSE-preset coding parameters, 2-16 bit precision. ``expect_shape``
    rejects a disagreeing frame header before the output allocates, like
    jpeg_lossless_decode.
    """
    h = _jls_parse_header(data)
    precision, rows, cols = h["precision"], h["rows"], h["cols"]
    near = h["near"]
    if not (2 <= precision <= 16):
        raise CodecError(f"invalid JPEG-LS precision {precision}")
    if expect_shape is not None and (rows, cols) != tuple(expect_shape):
        raise CodecError(
            f"JPEG-LS frame is ({rows}, {cols}), expected {tuple(expect_shape)}"
        )
    if rows <= 0 or cols <= 0 or rows > 32768 or cols > 32768:
        raise CodecError(f"implausible JPEG-LS dimensions ({rows}, {cols})")

    maxval = h["maxval"] if h["maxval"] else (1 << precision) - 1
    if not (0 < maxval < (1 << precision)):
        raise CodecError(f"invalid JPEG-LS MAXVAL {maxval}")
    if near < 0 or near > min(255, maxval // 2):
        raise CodecError(f"invalid JPEG-LS NEAR {near}")
    dt1, dt2, dt3, dreset = _jls_default_thresholds(maxval, near)
    t1 = h["t1"] or dt1
    t2 = h["t2"] or dt2
    t3 = h["t3"] or dt3
    reset = h["reset"] or dreset
    if not (near + 1 <= t1 <= t2 <= t3 <= maxval):
        raise CodecError(f"invalid JPEG-LS thresholds {t1}/{t2}/{t3}")
    if not (3 <= reset <= max(255, maxval)):
        # T.87 C.2.4.1.1 range; an unbounded RESET would also let the
        # context accumulators grow past int32 in the native mirror
        raise CodecError(f"invalid JPEG-LS RESET {reset}")

    # derived coding parameters (T.87 A.2.1 / C.2.4.1)
    range_ = (maxval + 2 * near) // (2 * near + 1) + 1
    qbpp = max(1, (range_ - 1).bit_length())
    bpp = max(2, (maxval).bit_length())
    limit = 2 * (bpp + max(8, bpp))
    quant_step = 2 * near + 1
    range_step = range_ * quant_step

    # context state: 365 regular contexts + 2 run-interruption contexts
    a_init = max(2, (range_ + 32) >> 6)
    A = [a_init] * 365
    B = [0] * 365
    C = [0] * 365
    N = [1] * 365
    rA = [a_init, a_init]
    rN = [1, 1]
    rNn = [0, 0]
    run_index = 0

    def quantize(d):
        if d <= -t3:
            return -4
        if d <= -t2:
            return -3
        if d <= -t1:
            return -2
        if d < -near:
            return -1
        if d <= near:
            return 0
        if d < t1:
            return 1
        if d < t2:
            return 2
        if d < t3:
            return 3
        return 4

    reader = _JlsBitReader(data, h["entropy_at"])

    def decode_value(k, lim):
        z = reader.read_zero_run(lim)
        if z >= lim - qbpp - 1:
            return reader.read_bits(qbpp) + 1
        if k == 0:
            return z
        return (z << k) | reader.read_bits(k)

    def fix_reconstructed(v):
        # wrap into [-NEAR, MAXVAL+NEAR] then clamp (T.87 A.4.5 decoder side)
        if v < -near:
            v += range_step
        elif v > maxval + near:
            v -= range_step
        return 0 if v < 0 else (maxval if v > maxval else v)

    def decode_run_interruption_error(ctx):
        temp = rA[ctx] + ((rN[ctx] >> 1) if ctx else 0)
        n = rN[ctx]
        k = 0
        while (n << k) < temp:
            k += 1
            if k > 32:
                raise CodecError("JPEG-LS run-interruption k overflow")
        em = decode_value(k, limit - _JLS_J[run_index] - 1)
        # unmap (inverse of T.87 A.7.2.1 mapping; ctx == RItype): the error
        # is negative exactly when the map bit agrees with the sign
        # predictor (k != 0 or run of negatives dominating)
        tv = em + ctx
        map_bit = tv & 1
        eabs = (tv + map_bit) >> 1
        predict_neg = k != 0 or 2 * rNn[ctx] >= n
        err = -eabs if predict_neg == bool(map_bit) else eabs
        if err < 0:
            rNn[ctx] += 1
        rA[ctx] += (em + 1 - ctx) >> 1
        if rN[ctx] == reset:
            rA[ctx] >>= 1
            rN[ctx] >>= 1
            rNn[ctx] >>= 1
        rN[ctx] += 1
        return err

    out = np.zeros((rows, cols), np.int32)
    # rows padded with a virtual left/right edge (1-indexed real samples)
    prev = [0] * (cols + 2)
    cur = [0] * (cols + 2)
    for y in range(rows):
        # edge initialization: left virtual sample = sample above; the
        # previous row's right edge duplicates its last sample
        prev[cols + 1] = prev[cols]
        cur[0] = prev[1]
        x = 1
        while x <= cols:
            ra = cur[x - 1]
            rb = prev[x]
            rc = prev[x - 1]
            rd = prev[x + 1]
            q1 = quantize(rd - rb)
            q2 = quantize(rb - rc)
            q3 = quantize(rc - ra)
            if q1 == 0 and q2 == 0 and q3 == 0:
                # ---- run mode (T.87 A.7) ----
                remaining = cols - x + 1
                count = 0
                broke_on_zero = True
                while True:
                    if count == remaining:
                        broke_on_zero = False
                        break
                    if not reader.read_bit():
                        break
                    seg = 1 << _JLS_J[run_index]
                    take = min(seg, remaining - count)
                    count += take
                    if take == seg and run_index < 31:
                        run_index += 1
                    if count == remaining:
                        broke_on_zero = False
                        break
                if broke_on_zero:
                    j = _JLS_J[run_index]
                    if j:
                        count += reader.read_bits(j)
                    if count >= remaining:
                        raise CodecError("JPEG-LS run overruns the line")
                for i in range(count):
                    cur[x + i] = ra
                x += count
                if not broke_on_zero:
                    continue  # run reached end of line; no interruption sample
                # run-interruption sample (T.87 A.7.2)
                rb = prev[x]
                ritype = 1 if abs(ra - rb) <= near else 0
                err = decode_run_interruption_error(ritype)
                if ritype:
                    rx = fix_reconstructed(ra + err * quant_step)
                else:
                    sign = -1 if rb < ra else 1
                    rx = fix_reconstructed(rb + sign * err * quant_step)
                cur[x] = rx
                x += 1
                if run_index > 0:
                    run_index -= 1
                continue
            # ---- regular mode (T.87 A.4-A.6) ----
            qs = 81 * q1 + 9 * q2 + q3
            if qs < 0:
                sign = -1
                qi = -qs
            else:
                sign = 1
                qi = qs
            # MED predictor + bias correction
            if rc >= max(ra, rb):
                px = min(ra, rb)
            elif rc <= min(ra, rb):
                px = max(ra, rb)
            else:
                px = ra + rb - rc
            px += C[qi] if sign > 0 else -C[qi]
            px = 0 if px < 0 else (maxval if px > maxval else px)
            a = A[qi]
            n = N[qi]
            k = 0
            while (n << k) < a:
                k += 1
                if k > 32:
                    raise CodecError("JPEG-LS Golomb k overflow")
            m = decode_value(k, limit)
            err = (m >> 1) if (m & 1) == 0 else -((m + 1) >> 1)
            if k == 0 and near == 0 and 2 * B[qi] <= -n:
                err = -err - 1  # bias-inverted mapping (T.87 A.5.2)
            # context update with the quantized error (A.6)
            B[qi] += err * quant_step
            A[qi] += err if err >= 0 else -err
            if n == reset:
                A[qi] >>= 1
                B[qi] = B[qi] >> 1
                N[qi] = n >> 1
            N[qi] += 1
            n = N[qi]
            if B[qi] + n <= 0:
                B[qi] += n
                if B[qi] <= -n:
                    B[qi] = -n + 1
                if C[qi] > -128:
                    C[qi] -= 1
            elif B[qi] > 0:
                B[qi] -= n
                if B[qi] > 0:
                    B[qi] = 0
                if C[qi] < 127:
                    C[qi] += 1
            cur[x] = fix_reconstructed(px + sign * err * quant_step)
            x += 1
        out[y] = cur[1 : cols + 1]
        prev, cur = cur, prev
    # the scan must terminate with EOI (acceptance agreement with CharLS and
    # the native decoder); unread bits of the current byte are padding, and
    # fill 0xFF bytes may pad before the marker (T.81 B.1.1.2)
    p = reader.pos
    if reader.prev_ff and p < len(data) and data[p] < 0x80:
        # the byte stuffed after a final 0xFF data byte may carry only
        # padding bits the scan never consumed (our encoder and CharLS
        # both emit it); step over it before expecting the marker
        p += 1
    if not reader.prev_ff and (p >= len(data) or data[p] != 0xFF):
        raise CodecError("JPEG-LS stream missing EOI after scan")
    while p < len(data) and data[p] == 0xFF:
        p += 1
    if p >= len(data) or data[p] != _EOI:
        raise CodecError("JPEG-LS stream missing EOI after scan")
    return out.astype(np.uint16)


class _JlsBitWriter:
    """MSB-first bit writer with T.87 marker-byte stuffing (the encoder
    mirror of :class:`_JlsBitReader`): after an emitted 0xFF byte the next
    byte carries only 7 data bits, its MSB a stuffed 0."""

    __slots__ = ("out", "cur", "room", "width")

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.room = 8
        self.width = 8

    def put_bit(self, b: int) -> None:
        self.cur = (self.cur << 1) | b
        self.room -= 1
        if self.room == 0:
            self.out.append(self.cur)
            self.width = 7 if self.cur == 0xFF else 8
            self.cur = 0
            self.room = self.width

    def put_bits(self, val: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put_bit((val >> i) & 1)

    def put_zeros(self, n: int) -> None:
        for _ in range(n):
            self.put_bit(0)

    def flush(self) -> bytes:
        if self.room < self.width:  # partial byte: pad with 0 bits
            self.out.append(self.cur << self.room)
        if self.out and self.out[-1] == 0xFF:
            # a trailing 0xFF data byte must be followed by its stuffed
            # byte even when it carries only padding — CharLS's decoder
            # refuses the marker in that position (its bit reader fills
            # ahead), and T.87's stuffing makes the 0x00 unambiguous
            self.out.append(0x00)
        return bytes(self.out)


def jpegls_encode(
    image: np.ndarray, precision: int | None = None, near: int = 0
) -> bytes:
    """Encode a 2D uint8/uint16 array as JPEG-LS (ITU-T T.87).

    The encoder mirror of :func:`jpegls_decode` — single component, default
    thresholds, no interleave/point-transform, the exact envelope both
    in-tree readers (and CharLS) accept; used by
    ``write_dicom(..., transfer_syntax=JPEG_LS_LOSSLESS / JPEG_LS_NEAR)``.
    ``near=0`` (lossless) round trips bit-exactly through
    :func:`jpegls_decode`, the native reader and CharLS; ``near>0``
    (near-lossless, the DICOM .81 syntax) reconstructs within ±near of the
    source, and all three decoders produce the IDENTICAL reconstruction
    (pinned in tests/test_jpegls.py) — the encoder tracks the reconstructed
    plane, not the source, exactly as T.87 requires.

    ``precision``: sample precision P (2-16); default derives the minimum
    from the data. DICOM callers must pass their BitsStored (PS3.5 A.4.3
    requires the codestream precision to match it — see write_dicom).
    """
    img = np.asarray(image)
    if img.ndim != 2:
        raise ValueError(f"expected 2D image, got {img.shape}")
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"expected uint8/uint16, got {img.dtype}")
    rows, cols = img.shape
    if rows == 0 or cols == 0 or rows > 32768 or cols > 32768:
        raise ValueError(f"bad JPEG-LS dimensions ({rows}, {cols})")
    vmax = int(img.max())
    if precision is None:
        precision = max(2, vmax.bit_length())
    elif not (2 <= precision <= 16) or vmax >= (1 << precision):
        raise ValueError(
            f"precision {precision} invalid or too small for max {vmax}"
        )
    maxval = (1 << precision) - 1
    if not 0 <= near <= min(255, maxval // 2):
        raise ValueError(f"NEAR {near} outside [0, min(255, maxval//2)]")

    t1, t2, t3, reset = _jls_default_thresholds(maxval, near)
    quant_step = 2 * near + 1
    range_ = (maxval + 2 * near) // quant_step + 1
    range_step = range_ * quant_step
    qbpp = max(1, (range_ - 1).bit_length())
    bpp = max(2, maxval.bit_length())
    limit = 2 * (bpp + max(8, bpp))
    half_range = (range_ + 1) >> 1

    def fix_reconstructed(v):
        # wrap into [-NEAR, MAXVAL+NEAR] then clamp — the decoder's A.4.5
        if v < -near:
            v += range_step
        elif v > maxval + near:
            v -= range_step
        return 0 if v < 0 else (maxval if v > maxval else v)

    def quantize_err(e):
        # A.4.4: quantize the prediction error to the near-lossless grid
        if e > 0:
            return (near + e) // quant_step
        return -((near - e) // quant_step)

    # header: SOI, SOF55, SOS (defaults need no LSE)
    head = bytearray()
    head += b"\xff" + bytes([_SOI])
    head += b"\xff" + bytes([_SOF55])
    head += struct.pack(">HBHHB", 2 + 1 + 2 + 2 + 1 + 3, precision, rows,
                        cols, 1)
    head += bytes([1, 0x11, 0])  # component 1, 1x1 sampling, no Tq
    head += b"\xff" + bytes([_SOS])
    head += struct.pack(">HB", 2 + 1 + 2 + 3, 1)
    head += bytes([1, 0])  # component 1, no mapping table
    head += bytes([near, 0, 0])  # NEAR, ILV=0, Al/Ah=0

    # context state — identical initialization to the decoder
    a_init = max(2, (range_ + 32) >> 6)
    A = [a_init] * 365
    B = [0] * 365
    C = [0] * 365
    N = [1] * 365
    rA = [a_init, a_init]
    rN = [1, 1]
    rNn = [0, 0]
    run_index = 0

    def quantize(d):
        if d <= -t3:
            return -4
        if d <= -t2:
            return -3
        if d <= -t1:
            return -2
        if d < -near:
            return -1
        if d <= near:
            return 0
        if d < t1:
            return 1
        if d < t2:
            return 2
        if d < t3:
            return 3
        return 4

    w = _JlsBitWriter()

    def encode_value(m, k, lim):
        # inverse of the decoder's decode_value: Golomb prefix + remainder,
        # escape to qbpp raw bits past the length limit
        hi = m >> k
        if hi < lim - qbpp - 1:
            w.put_zeros(hi)
            w.put_bit(1)
            if k:
                w.put_bits(m & ((1 << k) - 1), k)
        else:
            w.put_zeros(lim - qbpp - 1)
            w.put_bit(1)
            w.put_bits(m - 1, qbpp)

    def encode_run_interruption(ritype, ix, ra, rb):
        # T.87 A.7.2; returns the RECONSTRUCTED sample value
        if ritype:
            err = ix - ra
            sign = 1
        else:
            sign = -1 if rb < ra else 1
            err = (ix - rb) * sign
        err = quantize_err(err)
        if err < 0:
            err += range_
        if err >= half_range:
            err -= range_
        temp = rA[ritype] + ((rN[ritype] >> 1) if ritype else 0)
        n = rN[ritype]
        k = 0
        while (n << k) < temp:
            k += 1
        # A.7.2.1 error mapping
        if k == 0 and err > 0 and 2 * rNn[ritype] < n:
            emap = 1
        elif err < 0 and 2 * rNn[ritype] >= n:
            emap = 1
        elif err < 0 and k != 0:
            emap = 1
        else:
            emap = 0
        em = 2 * abs(err) - ritype - emap
        encode_value(em, k, limit - _JLS_J[run_index] - 1)
        if err < 0:
            rNn[ritype] += 1
        rA[ritype] += (em + 1 - ritype) >> 1
        if rN[ritype] == reset:
            rA[ritype] >>= 1
            rN[ritype] >>= 1
            rNn[ritype] >>= 1
        rN[ritype] += 1
        if ritype:
            return fix_reconstructed(ra + err * quant_step)
        return fix_reconstructed(rb + sign * err * quant_step)

    src = img.astype(np.int32)
    prev = [0] * (cols + 2)
    cur = [0] * (cols + 2)
    for y in range(rows):
        prev[cols + 1] = prev[cols]
        cur[0] = prev[1]
        line = src[y].tolist()
        # `cur` holds the RECONSTRUCTED row, built incrementally — at
        # near=0 it equals the source; at near>0 context modeling and run
        # detection must see what the decoder will see
        x = 1
        while x <= cols:
            ra = cur[x - 1]
            rb = prev[x]
            rc = prev[x - 1]
            rd = prev[x + 1]
            q1 = quantize(rd - rb)
            q2 = quantize(rb - rc)
            q3 = quantize(rc - ra)
            if q1 == 0 and q2 == 0 and q3 == 0:
                # ---- run mode (T.87 A.7.1) ----
                remaining = cols - x + 1
                run_len = 0
                while (
                    run_len < remaining
                    and abs(line[x + run_len - 1] - ra) <= near
                ):
                    cur[x + run_len] = ra  # run samples reconstruct to Ra
                    run_len += 1
                hit_eol = run_len == remaining
                count = run_len  # the segment loop consumes this copy
                while count >= (1 << _JLS_J[run_index]):
                    w.put_bit(1)
                    count -= 1 << _JLS_J[run_index]
                    if run_index < 31:
                        run_index += 1
                if hit_eol:
                    if count > 0:
                        w.put_bit(1)
                    x += run_len
                    continue
                w.put_bit(0)
                j = _JLS_J[run_index]
                if j:
                    w.put_bits(count, j)
                x += run_len
                # run-interruption sample (the one that broke the run)
                ra = cur[x - 1]
                rb = prev[x]
                ritype = 1 if abs(ra - rb) <= near else 0
                cur[x] = encode_run_interruption(ritype, line[x - 1], ra, rb)
                x += 1
                if run_index > 0:
                    run_index -= 1
                continue
            # ---- regular mode (T.87 A.4-A.6) ----
            qs = 81 * q1 + 9 * q2 + q3
            if qs < 0:
                sign = -1
                qi = -qs
            else:
                sign = 1
                qi = qs
            if rc >= max(ra, rb):
                px = min(ra, rb)
            elif rc <= min(ra, rb):
                px = max(ra, rb)
            else:
                px = ra + rb - rc
            px += C[qi] if sign > 0 else -C[qi]
            px = 0 if px < 0 else (maxval if px > maxval else px)
            err = line[x - 1] - px
            if sign < 0:
                err = -err
            err = quantize_err(err)
            # modulo reduction (A.4.5): the decoder's fix_reconstructed
            # undoes the wrap
            if err < 0:
                err += range_
            if err >= half_range:
                err -= range_
            a = A[qi]
            n = N[qi]
            k = 0
            while (n << k) < a:
                k += 1
            # bias-inverted mapping is its own inverse (A.5.2/A.5.3);
            # lossless-only, exactly like the decoder's condition
            e = (
                (-err - 1)
                if (k == 0 and near == 0 and 2 * B[qi] <= -n)
                else err
            )
            m = 2 * e if e >= 0 else -2 * e - 1
            encode_value(m, k, limit)
            # context update with the REAL error — identical to the decoder
            B[qi] += err * quant_step
            A[qi] += err if err >= 0 else -err
            if n == reset:
                A[qi] >>= 1
                B[qi] = B[qi] >> 1
                N[qi] = n >> 1
            N[qi] += 1
            n = N[qi]
            if B[qi] + n <= 0:
                B[qi] += n
                if B[qi] <= -n:
                    B[qi] = -n + 1
                if C[qi] > -128:
                    C[qi] -= 1
            elif B[qi] > 0:
                B[qi] -= n
                if B[qi] > 0:
                    B[qi] = 0
                if C[qi] < 127:
                    C[qi] += 1
            cur[x] = fix_reconstructed(px + sign * err * quant_step)
            x += 1
        prev, cur = cur, prev
    body = w.flush()
    return bytes(head) + body + b"\xff" + bytes([_EOI])
