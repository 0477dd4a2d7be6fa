// Native runtime layer for the TPU framework.
//
// The reference (calebhabesh/NM03-Capstone-Project) is a C++17 system: its
// import path (FAST DICOMFileImporter, src/test/test_pipeline.cpp:33-42), its
// batch parallelism (OpenMP parallel-for, src/parallel/main_parallel.cpp:336)
// and its export path (Qt/FAST ImageFileExporter,
// src/sequential/main_sequential.cpp:61-73) are all native code. This file is
// the TPU-native counterpart of that host-side runtime — everything that is
// NOT device math: DICOM decode, threaded batch staging for the HBM prefetch
// queue, and JPEG encoding. Device compute stays in JAX/XLA/Pallas.
//
// Exposed as a C ABI (ctypes-friendly, no pybind11):
//   nm03_dicom_read         — decode one 2D slice to float32 (rescale applied)
//   nm03_load_batch         — thread-pool decode of N files into a padded
//                             canvas arena + dims + per-file ok flags
//   nm03_jpeg_encode_gray   — baseline JPEG (grayscale) encoder
//   nm03_last_error         — thread-local error string
//
// Contracts mirror the Python implementations in
// nm03_capstone_project_tpu/data/dicomlite.py (parser) and
// nm03_capstone_project_tpu/render/export.py (encoder); tests/test_native.py
// checks native == Python on round-trips.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#if defined(_WIN32)
#define NM03_EXPORT extern "C" __declspec(dllexport)
#else
#define NM03_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

// ---------------------------------------------------------------------------
// DICOM-lite parser (explicit/implicit VR little endian, uncompressed mono)
// ---------------------------------------------------------------------------

struct ByteReader {
  const uint8_t* buf;
  size_t len;
  size_t pos = 0;
  bool explicit_vr;
  bool ok = true;
  bool big = false;  // explicit VR big endian (1.2.840.10008.1.2.2)

  uint16_t u16() {
    if (pos + 2 > len) { ok = false; return 0; }
    uint16_t v = big ? (uint16_t)((buf[pos] << 8) | buf[pos + 1])
                     : (uint16_t)(buf[pos] | (buf[pos + 1] << 8));
    pos += 2;
    return v;
  }
  uint32_t u32() {
    if (pos + 4 > len) { ok = false; return 0; }
    uint32_t v = big ? (((uint32_t)buf[pos] << 24) | ((uint32_t)buf[pos + 1] << 16) |
                        ((uint32_t)buf[pos + 2] << 8) | (uint32_t)buf[pos + 3])
                     : ((uint32_t)buf[pos] | ((uint32_t)buf[pos + 1] << 8) |
                        ((uint32_t)buf[pos + 2] << 16) | ((uint32_t)buf[pos + 3] << 24));
    pos += 4;
    return v;
  }
  bool atend() const { return pos + 8 > len; }
};

constexpr uint32_t kUndefined = 0xFFFFFFFFu;

bool is_long_vr(const char vr[2]) {
  static const char* kLong[] = {"OB", "OW", "OF", "OD", "OL",
                                "SQ", "UC", "UR", "UT", "UN"};
  for (const char* s : kLong)
    if (vr[0] == s[0] && vr[1] == s[1]) return true;
  return false;
}

struct Element {
  uint16_t group, elem;
  char vr[2];
  uint32_t length;
};

// Decode one data element header (mirrors _Reader.element in dicomlite.py).
Element read_element(ByteReader& r) {
  Element e{};
  e.group = r.u16();
  e.elem = r.u16();
  bool delim = e.group == 0xFFFE &&
               (e.elem == 0xE000 || e.elem == 0xE00D || e.elem == 0xE0DD);
  if (delim) {
    e.length = r.u32();
    return e;
  }
  if (r.explicit_vr && e.group != 0xFFFE) {
    if (r.pos + 2 > r.len) { r.ok = false; return e; }
    e.vr[0] = (char)r.buf[r.pos];
    e.vr[1] = (char)r.buf[r.pos + 1];
    r.pos += 2;
    if (is_long_vr(e.vr)) {
      r.pos += 2;  // reserved
      e.length = r.u32();
    } else {
      e.length = r.u16();
    }
  } else {
    e.length = r.u32();
  }
  return e;
}

void skip_item_undefined(ByteReader& r);

// Skip an undefined-length sequence body (until sequence delimiter).
void skip_sequence(ByteReader& r) {
  while (!r.atend() && r.ok) {
    Element e = read_element(r);
    if (e.group == 0xFFFE && e.elem == 0xE0DD) return;  // seq delimiter
    if (e.group == 0xFFFE && e.elem == 0xE000) {        // item
      if (e.length == kUndefined)
        skip_item_undefined(r);
      else
        r.pos += e.length;
    } else {  // malformed; bail out of the sequence
      if (e.length != kUndefined) r.pos += e.length;
      return;
    }
  }
}

void skip_item_undefined(ByteReader& r) {
  while (!r.atend() && r.ok) {
    Element e = read_element(r);
    if (e.group == 0xFFFE && e.elem == 0xE00D) return;  // item delimiter
    if (e.length == kUndefined)
      skip_sequence(r);  // nested undefined-length sequence
    else
      r.pos += e.length;
  }
}

using Tag = uint32_t;
constexpr Tag tag(uint16_t g, uint16_t e) { return ((Tag)g << 16) | e; }

struct DataSet {
  std::map<Tag, std::vector<uint8_t>> meta;
  const uint8_t* pixel_data = nullptr;
  size_t pixel_len = 0;
  // encapsulated PixelData fragments (byte spans into the file buffer)
  std::vector<std::pair<const uint8_t*, size_t>> fragments;
};

// Encapsulated PixelData: Basic Offset Table item, then one item per
// fragment, closed by a sequence delimiter (PS3.5 A.4; mirrors
// _read_fragments in dicomlite.py).
bool read_fragments(ByteReader& r, DataSet* out) {
  bool first = true;
  while (!r.atend() && r.ok) {
    Element e = read_element(r);
    if (e.group == 0xFFFE && e.elem == 0xE0DD) return true;  // seq delimiter
    if (e.group != 0xFFFE || e.elem != 0xE000 || e.length == kUndefined) {
      set_error("malformed encapsulated PixelData item");
      return false;
    }
    if (e.length > r.len - r.pos) {
      set_error("encapsulated fragment overruns file");
      return false;
    }
    if (!first)  // the first item is the Basic Offset Table
      out->fragments.emplace_back(r.buf + r.pos, (size_t)e.length);
    first = false;
    r.pos += e.length;
  }
  set_error("encapsulated PixelData missing sequence delimiter");
  return false;
}

bool parse_dataset(const uint8_t* buf, size_t len, bool explicit_vr,
                   DataSet* out, bool encapsulated = false, bool big = false) {
  ByteReader r{buf, len, 0, explicit_vr, true, big};
  while (!r.atend()) {
    Element e = read_element(r);
    if (!r.ok) { set_error("truncated DICOM element structure"); return false; }
    if (e.group == 0x7FE0 && e.elem == 0x0010) {
      if (e.length == kUndefined) {
        if (!encapsulated) {
          set_error("encapsulated PixelData under an uncompressed transfer syntax");
          return false;
        }
        if (!read_fragments(r, out)) return false;
        continue;
      }
      // clamp a declared length that overruns the file (Python's slice
      // semantics in dicomlite.py:142); the rows*cols sufficiency check
      // below decides whether the slice is still decodable
      size_t avail = len - r.pos;
      out->pixel_data = buf + r.pos;
      out->pixel_len = e.length < avail ? e.length : avail;
      r.pos += out->pixel_len;
      continue;
    }
    if (e.length == kUndefined) { skip_sequence(r); continue; }
    if (e.vr[0] == 'S' && e.vr[1] == 'Q') { r.pos += e.length; continue; }
    if (e.group == 0xFFFE) { r.pos += e.length; continue; }
    if (e.length > len - r.pos) {
      char msg[96];
      std::snprintf(msg, sizeof msg, "element (%04x,%04x) length %u overruns file",
                    e.group, e.elem, e.length);
      set_error(msg);
      return false;
    }
    out->meta[tag(e.group, e.elem)].assign(buf + r.pos, buf + r.pos + e.length);
    r.pos += e.length;
  }
  return true;
}

std::string ascii_value(const std::vector<uint8_t>& v) {
  std::string s(v.begin(), v.end());
  while (!s.empty() && (s.back() == '\0' || s.back() == ' ')) s.pop_back();
  size_t i = 0;
  while (i < s.size() && (s[i] == '\0' || s[i] == ' ')) ++i;
  return s.substr(i);
}

bool meta_int(const DataSet& ds, Tag t, long* out, bool big = false) {
  auto it = ds.meta.find(t);
  if (it == ds.meta.end()) return false;
  const auto& v = it->second;
  if (v.size() == 2) {
    *out = big ? ((v[0] << 8) | v[1]) : (v[0] | (v[1] << 8));
    return true;
  }
  if (v.size() == 4) {
    *out = big ? (long)(((uint32_t)v[0] << 24) | ((uint32_t)v[1] << 16) |
                        ((uint32_t)v[2] << 8) | (uint32_t)v[3])
               : (long)((uint32_t)v[0] | ((uint32_t)v[1] << 8) |
                        ((uint32_t)v[2] << 16) | ((uint32_t)v[3] << 24));
    return true;
  }
  try {
    *out = std::stol(ascii_value(v));
    return true;
  } catch (...) { return false; }
}

double meta_float(const DataSet& ds, Tag t, double dflt) {
  auto it = ds.meta.find(t);
  if (it == ds.meta.end()) return dflt;
  try { return std::stod(ascii_value(it->second)); } catch (...) { return dflt; }
}

// ---------------------------------------------------------------------------
// RLE Lossless (PS3.5 Annex G) — mirrors data/codecs.py:rle_decode_frame.
// Decodes one frame into little-endian sample bytes (the layout the pixel
// conversion loops below already read), recomposed from the MSB-first
// byte-plane segments.
// ---------------------------------------------------------------------------

uint32_t le32_at(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

bool packbits_decode(const uint8_t* seg, size_t seg_len, uint8_t* out,
                     size_t expected) {
  size_t i = 0, got = 0;
  while (i < seg_len && got < expected) {
    uint8_t ctrl = seg[i++];
    if (ctrl < 128) {  // literal run: copy next ctrl+1 bytes
      size_t count = (size_t)ctrl + 1;
      if (i + count > seg_len) { set_error("RLE literal run overruns segment"); return false; }
      if (got + count > expected) count = expected - got;
      std::memcpy(out + got, seg + i, count);
      i += (size_t)ctrl + 1;
      got += count;
    } else if (ctrl > 128) {  // replicate: next byte repeated 257-ctrl times
      if (i >= seg_len) { set_error("RLE replicate run missing its byte"); return false; }
      size_t count = 257 - ctrl;
      if (got + count > expected) count = expected - got;
      std::memset(out + got, seg[i], count);
      ++i;
      got += count;
    }
    // ctrl == 128: no-op (reserved)
  }
  if (got < expected) { set_error("RLE segment decoded short"); return false; }
  return true;
}

bool rle_decode_frame(const uint8_t* frame, size_t flen, size_t rows,
                      size_t cols, int itemsize, std::vector<uint8_t>* out) {
  if (flen < 64) { set_error("RLE frame shorter than its 64-byte header"); return false; }
  uint32_t nseg = le32_at(frame);
  if ((int)nseg != itemsize) { set_error("RLE segment count mismatch"); return false; }
  uint32_t offsets[15];
  for (uint32_t s = 0; s < nseg; ++s) {
    offsets[s] = le32_at(frame + 4 + 4 * s);
    if (offsets[s] < 64 || offsets[s] > flen ||
        (s && offsets[s] < offsets[s - 1])) {
      set_error("RLE segment offsets invalid");
      return false;
    }
  }
  size_t npix = rows * cols;
  out->resize(npix * itemsize);
  std::vector<uint8_t> plane(npix);
  for (uint32_t s = 0; s < nseg; ++s) {
    size_t start = offsets[s];
    size_t end = (s + 1 < nseg) ? offsets[s + 1] : flen;
    if (!packbits_decode(frame + start, end - start, plane.data(), npix))
      return false;
    // segment order is MSB plane first; emit little-endian sample bytes
    size_t byte_index = (size_t)(itemsize - 1 - (int)s);
    for (size_t i = 0; i < npix; ++i)
      (*out)[i * itemsize + byte_index] = plane[i];
  }
  return true;
}

// ---------------------------------------------------------------------------
// JPEG Lossless (ITU-T T.81 process 14, SOF3) — mirrors
// data/codecs.py:jpeg_lossless_decode. Any predictor selection 1-7, point
// transform, 2-16 bit precision, single component, no restart intervals.
// The Python decoder is the reference implementation; this one keeps
// JPEG-lossless cohorts on the threaded native fast path (the pure-Python
// per-pixel Huffman loop costs ~0.5 s per 256x256 slice).
// ---------------------------------------------------------------------------

struct JBitReader {
  const uint8_t* buf;
  size_t len, pos;
  uint32_t acc = 0;
  int nacc = 0;
  bool ok = true;

  int read_bit() {
    if (nacc == 0) {
      if (pos >= len) { ok = false; return 0; }
      uint8_t b = buf[pos++];
      if (b == 0xFF) {
        if (pos >= len) { ok = false; return 0; }
        if (buf[pos] == 0x00) ++pos;  // stuffed byte
        else { ok = false; return 0; }  // real marker mid-scan
      }
      acc = b;
      nacc = 8;
    }
    --nacc;
    return (acc >> nacc) & 1;
  }
  uint32_t read_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | (uint32_t)read_bit();
    return v;
  }
};

// Canonical Huffman (T.81 Annex C): codes of each length are consecutive.
struct JHuffTable {
  uint32_t first_code[17];  // smallest code of each length
  int first_index[17];      // index into values of that code
  int count[17];            // codes of each length
  std::vector<uint8_t> values;
  bool present = false;
};

void build_huffman(const uint8_t* counts, const uint8_t* vals, int nvals,
                   JHuffTable* t) {
  t->values.assign(vals, vals + nvals);
  uint32_t code = 0;
  int index = 0;
  for (int length = 1; length <= 16; ++length) {
    t->first_code[length] = code;
    t->first_index[length] = index;
    t->count[length] = counts[length - 1];
    code = (code + counts[length - 1]) << 1;
    index += counts[length - 1];
  }
  t->present = true;
}

int huff_decode(JBitReader& r, const JHuffTable& t) {
  uint32_t code = 0;
  for (int length = 1; length <= 16; ++length) {
    code = (code << 1) | (uint32_t)r.read_bit();
    if (!r.ok) return -1;
    if (t.count[length] &&
        code < t.first_code[length] + (uint32_t)t.count[length]) {
      return t.values[t.first_index[length] + (code - t.first_code[length])];
    }
  }
  return -1;
}

// T.81 F.2.2.1: map SSSS magnitude bits to a signed difference.
int32_t jpeg_extend(uint32_t bits, int ssss) {
  if (ssss == 0) return 0;
  if (ssss == 16) return 32768;  // no magnitude bits (lossless special case)
  if (bits < (1u << (ssss - 1))) return (int32_t)bits - (1 << ssss) + 1;
  return (int32_t)bits;
}

// expect_rows/expect_cols: the DICOM header's dimensions — checked right
// after SOF3 parses, BEFORE sizing the output, so a hostile embedded JPEG
// claiming 32768x32768 cannot drive a ~2 GiB allocation + gigapixel decode
// that the caller's post-hoc dimension check would only catch afterwards.
bool jpeg_lossless_decode(const uint8_t* data, size_t len, long expect_rows,
                          long expect_cols, std::vector<uint16_t>* out,
                          long* rows_out, long* cols_out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) {
    set_error("not a JPEG stream (missing SOI)");
    return false;
  }
  size_t pos = 2;
  int precision = -1;
  long rows = 0, cols = 0;
  JHuffTable tables[2][4];  // [class][id]; lossless scans use class 0
  int sel = 1, pt = 0, table_id = 0;
  bool got_sos = false;
  while (pos + 2 <= len) {
    if (data[pos] != 0xFF) { set_error("expected JPEG marker"); return false; }
    // optional fill bytes (T.81 B.1.1.2): extra 0xFF may pad any marker
    while (pos + 1 < len && data[pos + 1] == 0xFF) ++pos;
    if (pos + 2 > len) { set_error("truncated JPEG marker segment"); return false; }
    uint8_t marker = data[pos + 1];
    pos += 2;
    if (marker == 0xD9) break;  // EOI
    if (pos + 2 > len) { set_error("truncated JPEG marker segment"); return false; }
    size_t seglen = ((size_t)data[pos] << 8) | data[pos + 1];
    size_t seg_end = pos + seglen;
    if (seglen < 2 || seg_end > len) {
      // seglen includes its own 2 bytes; < 2 would underflow body_len
      set_error("truncated JPEG marker segment");
      return false;
    }
    const uint8_t* body = data + pos + 2;
    size_t body_len = seglen - 2;
    if (marker == 0xC3) {  // SOF3
      if (body_len < 6) { set_error("short SOF3"); return false; }
      precision = body[0];
      rows = ((long)body[1] << 8) | body[2];
      cols = ((long)body[3] << 8) | body[4];
      if (body[5] != 1) { set_error("lossless JPEG: expected 1 component"); return false; }
    } else if ((marker >= 0xC0 && marker <= 0xCB) && marker != 0xC3 &&
               marker != 0xC4 && marker != 0xC8) {
      set_error("JPEG SOF is not lossless process 14 (SOF3)");
      return false;
    } else if (marker == 0xC4) {  // DHT
      size_t b = 0;
      while (b + 17 <= body_len) {
        uint8_t tc_th = body[b];
        int tc = tc_th >> 4, th = tc_th & 0x0F;
        int nvals = 0;
        for (int i = 0; i < 16; ++i) nvals += body[b + 1 + i];
        if (b + 17 + nvals > body_len || tc > 1 || th > 3) {
          set_error("malformed DHT");
          return false;
        }
        build_huffman(body + b + 1, body + b + 17, nvals, &tables[tc][th]);
        b += 17 + (size_t)nvals;
      }
      if (b != body_len) {
        // trailing bytes too short for another table: the Python
        // reference rejects this stream; the decoders must agree
        set_error("malformed DHT");
        return false;
      }
    } else if (marker == 0xDA) {  // SOS
      if (body_len < 6 || body[0] != 1) { set_error("expected 1 scan component"); return false; }
      table_id = body[2] >> 4;  // Td
      sel = body[3];            // Ss = predictor selection value
      pt = body[5] & 0x0F;      // Al = point transform
      pos = seg_end;
      got_sos = true;
      break;  // entropy-coded data follows
    }
    pos = seg_end;
  }
  if (precision < 0 || !got_sos) { set_error("JPEG stream missing SOF3/SOS"); return false; }
  if (table_id > 3 || !tables[0][table_id].present) {
    set_error("JPEG scan references undefined Huffman table");
    return false;
  }
  if (sel < 1 || sel > 7) { set_error("unsupported lossless predictor"); return false; }
  if (rows != expect_rows || cols != expect_cols) {
    set_error("JPEG frame dimensions disagree with DICOM header");
    return false;
  }
  if (precision < 2 || precision > 16 || pt >= precision) {
    // T.81: lossless precision is 2-16; pt >= precision would make the
    // default predictor's shift count negative (UB)
    set_error("invalid JPEG precision/point-transform");
    return false;
  }

  const JHuffTable& table = tables[0][table_id];
  JBitReader r{data, len, pos};
  out->assign((size_t)rows * cols, 0);
  std::vector<int32_t> cur(cols), prev(cols);
  int32_t dflt = 1 << (precision - pt - 1);
  for (long y = 0; y < rows; ++y) {
    for (long x = 0; x < cols; ++x) {
      int ssss = huff_decode(r, table);
      if (ssss < 0 || !r.ok) { set_error("invalid JPEG Huffman code"); return false; }
      if (ssss > 16) {
        // DHT values are arbitrary bytes; >16 would be shift-count UB in
        // jpeg_extend and silent divergence from the Python reference
        set_error("invalid JPEG difference category");
        return false;
      }
      uint32_t extra = (ssss > 0 && ssss < 16) ? r.read_bits(ssss) : 0;
      if (!r.ok) { set_error("JPEG entropy data truncated"); return false; }
      int32_t diff = jpeg_extend(extra, ssss);
      int32_t pred;
      if (y == 0) {
        pred = (x == 0) ? dflt : cur[x - 1];
      } else if (x == 0) {
        pred = prev[0];
      } else {
        int32_t ra = cur[x - 1], rb = prev[x], rc = prev[x - 1];
        switch (sel) {
          case 1: pred = ra; break;
          case 2: pred = rb; break;
          case 3: pred = rc; break;
          case 4: pred = ra + rb - rc; break;
          case 5: pred = ra + ((rb - rc) >> 1); break;
          case 6: pred = rb + ((ra - rc) >> 1); break;
          default: pred = (ra + rb) >> 1; break;
        }
      }
      cur[x] = (pred + diff) & 0xFFFF;
      (*out)[(size_t)y * cols + x] = (uint16_t)(cur[x] << pt);
    }
    std::swap(cur, prev);
  }
  *rows_out = rows;
  *cols_out = cols;
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { set_error(std::string("cannot open ") + path); return false; }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) { std::fclose(f); set_error("ftell failed"); return false; }
  out->resize((size_t)n);
  size_t got = n ? std::fread(out->data(), 1, (size_t)n, f) : 0;
  std::fclose(f);
  if (got != (size_t)n) { set_error("short read"); return false; }
  return true;
}

// ---------------------------------------------------------------------------
// JPEG-LS (ITU-T T.87) decoder — native mirror of data/codecs.py
// jpegls_decode. LOCO-I: MED prediction, 365 bias-corrected Golomb contexts,
// run mode with two run-interruption contexts. Lossless + near-lossless,
// single component, interleave none; conformance pinned against CharLS
// streams by tests/test_jpegls.py::TestNativeParity (vendored goldens +
// live three-way fuzz) alongside the Python decoder.
// ---------------------------------------------------------------------------

struct JlsBitReader {
  const uint8_t* buf;
  size_t len, pos;
  uint64_t cache = 0;
  int nbits = 0;
  bool prev_ff = false;
  bool ok = true;

  bool fill() {
    if (pos >= len) { ok = false; return false; }
    uint8_t b = buf[pos];
    if (prev_ff) {
      if (b >= 0x80) { ok = false; return false; }  // marker ends the scan
      ++pos;
      cache = (cache << 7) | b;
      nbits += 7;
      prev_ff = false;
    } else {
      ++pos;
      cache = (cache << 8) | b;
      nbits += 8;
      prev_ff = (b == 0xFF);
    }
    return true;
  }
  int read_bit() {
    if (nbits == 0 && !fill()) return 0;
    --nbits;
    return (int)((cache >> nbits) & 1);
  }
  uint32_t read_bits(int n) {
    while (nbits < n) if (!fill()) return 0;
    nbits -= n;
    uint32_t v = (uint32_t)((cache >> nbits) & ((1u << n) - 1));
    cache &= (nbits ? ((uint64_t)1 << nbits) - 1 : 0);
    return v;
  }
  int read_zero_run(int cap) {
    int z = 0;
    while (true) {
      if (read_bit()) return z;
      if (!ok) return -1;
      if (++z > cap) { ok = false; return -1; }
    }
  }
};

struct JlsRunCtx { int32_t a, n, nn; };

bool jpegls_decode(const uint8_t* data, size_t len, long expect_rows,
                   long expect_cols, std::vector<uint16_t>* out,
                   long* rows_out, long* cols_out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) {
    set_error("not a JPEG-LS stream (missing SOI)");
    return false;
  }
  size_t pos = 2;
  int precision = -1;
  long rows = 0, cols = 0;
  long maxval_hdr = 0, t1_hdr = 0, t2_hdr = 0, t3_hdr = 0, reset_hdr = 0;
  int near = 0;
  size_t entropy_at = 0;
  bool got_sos = false;
  while (pos + 2 <= len) {
    if (data[pos] != 0xFF) { set_error("expected JPEG-LS marker"); return false; }
    // optional fill bytes (T.81 B.1.1.2): extra 0xFF may pad any marker
    while (pos + 1 < len && data[pos + 1] == 0xFF) ++pos;
    if (pos + 2 > len) { set_error("truncated JPEG-LS segment"); return false; }
    uint8_t marker = data[pos + 1];
    pos += 2;
    if (marker == 0xD9) break;  // EOI before SOS
    if (pos + 2 > len) { set_error("truncated JPEG-LS segment"); return false; }
    size_t seglen = ((size_t)data[pos] << 8) | data[pos + 1];
    size_t seg_end = pos + seglen;
    if (seglen < 2 || seg_end > len) { set_error("truncated JPEG-LS segment"); return false; }
    const uint8_t* body = data + pos + 2;
    size_t body_len = seglen - 2;
    if (marker == 0xF7) {  // SOF55
      if (body_len < 6) { set_error("short SOF55"); return false; }
      precision = body[0];
      rows = ((long)body[1] << 8) | body[2];
      cols = ((long)body[3] << 8) | body[4];
      if (body[5] != 1) { set_error("JPEG-LS: expected 1 component"); return false; }
    } else if (marker >= 0xC0 && marker <= 0xCB && marker != 0xC4 && marker != 0xC8) {
      set_error("not JPEG-LS (wrong SOF)");
      return false;
    } else if (marker == 0xF8) {  // LSE
      if (body_len < 1 || body[0] != 1) { set_error("unsupported LSE segment"); return false; }
      if (body_len < 11) { set_error("short LSE preset segment"); return false; }
      maxval_hdr = ((long)body[1] << 8) | body[2];
      t1_hdr = ((long)body[3] << 8) | body[4];
      t2_hdr = ((long)body[5] << 8) | body[6];
      t3_hdr = ((long)body[7] << 8) | body[8];
      reset_hdr = ((long)body[9] << 8) | body[10];
    } else if (marker == 0xDD) {
      set_error("JPEG-LS restart intervals unsupported");
      return false;
    } else if (marker == 0xDA) {  // SOS
      if (body_len < 6) { set_error("short JPEG-LS SOS"); return false; }
      if (body[0] != 1) { set_error("expected 1 scan component"); return false; }
      if (body[2] != 0) { set_error("JPEG-LS mapping tables unsupported"); return false; }
      near = body[3];
      if (body[4] != 0) { set_error("JPEG-LS interleave unsupported"); return false; }
      if ((body[5] & 0x0F) != 0) { set_error("JPEG-LS point transform unsupported"); return false; }
      entropy_at = seg_end;
      got_sos = true;
      break;
    }
    pos = seg_end;
  }
  if (precision < 2 || precision > 16) { set_error("JPEG-LS missing/invalid SOF55"); return false; }
  if (!got_sos) { set_error("JPEG-LS stream missing SOS"); return false; }
  if (expect_rows > 0 && (rows != expect_rows || cols != expect_cols)) {
    set_error("JPEG-LS frame dimensions disagree with DICOM header");
    return false;
  }
  if (rows <= 0 || cols <= 0 || rows > 32768 || cols > 32768) {
    set_error("implausible JPEG-LS dimensions");
    return false;
  }
  long maxval = maxval_hdr ? maxval_hdr : ((1L << precision) - 1);
  if (maxval <= 0 || maxval >= (1L << precision)) { set_error("invalid JPEG-LS MAXVAL"); return false; }
  if (near < 0 || near > maxval / 2) { set_error("invalid JPEG-LS NEAR"); return false; }

  // default thresholds (T.87 C.2.4.1.1.1)
  long t1, t2, t3, reset = 64;
  {
    auto clampv = [&](long i, long j) { return (i > maxval || i < j) ? j : i; };
    if (maxval >= 128) {
      long factor = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
      t1 = clampv(factor * 1 + 2 + 3 * near, near + 1);
      t2 = clampv(factor * 4 + 3 + 5 * near, t1);
      t3 = clampv(factor * 17 + 4 + 7 * near, t2);
    } else {
      long factor = 256 / (maxval + 1);
      long v1 = 3 / factor + 3 * near; if (v1 < 2) v1 = 2;
      long v2 = 7 / factor + 5 * near; if (v2 < 3) v2 = 3;
      long v3 = 21 / factor + 7 * near; if (v3 < 4) v3 = 4;
      t1 = clampv(v1, near + 1);
      t2 = clampv(v2, t1);
      t3 = clampv(v3, t2);
    }
  }
  if (t1_hdr) t1 = t1_hdr;
  if (t2_hdr) t2 = t2_hdr;
  if (t3_hdr) t3 = t3_hdr;
  if (reset_hdr) reset = reset_hdr;
  if (!(near + 1 <= t1 && t1 <= t2 && t2 <= t3 && t3 <= maxval)) {
    set_error("invalid JPEG-LS thresholds");
    return false;
  }
  // T.87 C.2.4.1.1 range; unbounded RESET would let the int32 context
  // accumulators overflow (UB) before the halving ever triggers
  if (reset < 3 || reset > (maxval > 255 ? maxval : 255)) {
    set_error("invalid JPEG-LS RESET");
    return false;
  }

  const long quant_step = 2L * near + 1;
  const long range = (maxval + 2 * near) / quant_step + 1;
  int qbpp = 1; while ((1L << qbpp) < range) ++qbpp;
  int bpp = 2; while ((1L << bpp) <= maxval) ++bpp;
  const int limit = 2 * (bpp > 8 ? 2 * bpp : bpp + 8);
  const long range_step = range * quant_step;

  static const int J[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                            4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};
  const int32_t a_init = (int32_t)std::max(2L, (range + 32) >> 6);
  std::vector<int32_t> A(365, a_init), B(365, 0), C(365, 0), N(365, 1);
  JlsRunCtx rctx[2] = {{a_init, 1, 0}, {a_init, 1, 0}};
  int run_index = 0;

  auto quantize = [&](long d) -> int {
    if (d <= -t3) return -4;
    if (d <= -t2) return -3;
    if (d <= -t1) return -2;
    if (d < -near) return -1;
    if (d <= near) return 0;
    if (d < t1) return 1;
    if (d < t2) return 2;
    if (d < t3) return 3;
    return 4;
  };

  JlsBitReader r{data, len, entropy_at};

  auto decode_value = [&](int k, int lim) -> long {
    int z = r.read_zero_run(lim);
    if (z < 0) return -1;
    if (z >= lim - qbpp - 1) return (long)r.read_bits(qbpp) + 1;
    if (k == 0) return z;
    return ((long)z << k) | r.read_bits(k);
  };

  auto fix_reconstructed = [&](long v) -> long {
    if (v < -near) v += range_step;
    else if (v > maxval + near) v -= range_step;
    if (v < 0) return 0;
    if (v > maxval) return maxval;
    return v;
  };

  auto decode_run_interruption_error = [&](int ctx) -> long {
    JlsRunCtx& c = rctx[ctx];
    long temp = c.a + (ctx ? (c.n >> 1) : 0);
    int k = 0;
    while (((long)c.n << k) < temp) { if (++k > 32) { r.ok = false; return 0; } }
    long em = decode_value(k, limit - J[run_index] - 1);
    if (em < 0) { r.ok = false; return 0; }
    long tv = em + ctx;
    int map_bit = (int)(tv & 1);
    long eabs = (tv + map_bit) >> 1;
    bool cond = (k != 0) || (2 * c.nn >= c.n);
    long err = (cond == (map_bit != 0)) ? -eabs : eabs;
    if (err < 0) ++c.nn;
    c.a += (int32_t)((em + 1 - ctx) >> 1);
    if (c.n == (int32_t)reset) { c.a >>= 1; c.n >>= 1; c.nn >>= 1; }
    ++c.n;
    return err;
  };

  out->assign((size_t)rows * cols, 0);
  std::vector<long> prev((size_t)cols + 2, 0), cur((size_t)cols + 2, 0);
  for (long y = 0; y < rows; ++y) {
    prev[cols + 1] = prev[cols];
    cur[0] = prev[1];
    long x = 1;
    while (x <= cols) {
      if (!r.ok) { set_error("truncated JPEG-LS entropy stream"); return false; }
      long ra = cur[x - 1], rb = prev[x], rc = prev[x - 1], rd = prev[x + 1];
      int q1 = quantize(rd - rb), q2 = quantize(rb - rc), q3 = quantize(rc - ra);
      if (q1 == 0 && q2 == 0 && q3 == 0) {
        // run mode
        long remaining = cols - x + 1;
        long count = 0;
        bool broke_on_zero = true;
        while (true) {
          if (count == remaining) { broke_on_zero = false; break; }
          int bit = r.read_bit();
          if (!r.ok) { set_error("truncated JPEG-LS entropy stream"); return false; }
          if (!bit) break;
          long seg = 1L << J[run_index];
          long take = seg < remaining - count ? seg : remaining - count;
          count += take;
          if (take == seg && run_index < 31) ++run_index;
          if (count == remaining) { broke_on_zero = false; break; }
        }
        if (broke_on_zero) {
          int j = J[run_index];
          if (j) count += r.read_bits(j);
          if (!r.ok || count >= remaining) { set_error("JPEG-LS run overruns the line"); return false; }
        }
        for (long i = 0; i < count; ++i) cur[x + i] = ra;
        x += count;
        if (!broke_on_zero) continue;
        rb = prev[x];
        int ritype = (std::labs(ra - rb) <= near) ? 1 : 0;
        long err = decode_run_interruption_error(ritype);
        if (!r.ok) { set_error("truncated JPEG-LS entropy stream"); return false; }
        long rx;
        if (ritype) rx = fix_reconstructed(ra + err * quant_step);
        else {
          long sgn = rb < ra ? -1 : 1;
          rx = fix_reconstructed(rb + sgn * err * quant_step);
        }
        cur[x] = rx;
        ++x;
        if (run_index > 0) --run_index;
        continue;
      }
      // regular mode
      long qs = 81L * q1 + 9L * q2 + q3;
      long sign = 1;
      if (qs < 0) { sign = -1; qs = -qs; }
      long px;
      long mn = ra < rb ? ra : rb, mx = ra < rb ? rb : ra;
      if (rc >= mx) px = mn;
      else if (rc <= mn) px = mx;
      else px = ra + rb - rc;
      px += sign > 0 ? C[qs] : -C[qs];
      if (px < 0) px = 0; else if (px > maxval) px = maxval;
      int32_t a = A[qs], n = N[qs];
      int k = 0;
      while (((long)n << k) < a) { if (++k > 32) { set_error("JPEG-LS k overflow"); return false; } }
      long m = decode_value(k, limit);
      if (m < 0) { set_error("truncated JPEG-LS entropy stream"); return false; }
      long err = ((m & 1) == 0) ? (m >> 1) : -((m + 1) >> 1);
      if (k == 0 && near == 0 && 2 * B[qs] <= -n) err = -err - 1;
      B[qs] += (int32_t)(err * quant_step);
      A[qs] += (int32_t)(err >= 0 ? err : -err);
      if (n == (int32_t)reset) { A[qs] >>= 1; B[qs] >>= 1; N[qs] = n >> 1; }
      ++N[qs];
      n = N[qs];
      if (B[qs] + n <= 0) {
        B[qs] += n;
        if (B[qs] <= -n) B[qs] = -n + 1;
        if (C[qs] > -128) --C[qs];
      } else if (B[qs] > 0) {
        B[qs] -= n;
        if (B[qs] > 0) B[qs] = 0;
        if (C[qs] < 127) ++C[qs];
      }
      cur[x] = fix_reconstructed(px + sign * err * quant_step);
      ++x;
    }
    for (long i = 0; i < cols; ++i)
      (*out)[(size_t)y * cols + i] = (uint16_t)cur[i + 1];
    std::swap(prev, cur);
  }
  // scan must terminate with EOI (acceptance agreement with the Python
  // decoder and CharLS); unread bits of the current byte are padding, and
  // fill 0xFF bytes may pad before the marker (T.81 B.1.1.2)
  size_t p = r.pos;
  if (r.prev_ff && p < len && data[p] < 0x80) {
    // step over the stuffed byte a final 0xFF data byte carries even when
    // the scan consumed none of its bits (mirrors the Python decoder)
    ++p;
  }
  if (!r.prev_ff && (p >= len || data[p] != 0xFF)) {
    set_error("JPEG-LS stream missing EOI");
    return false;
  }
  while (p < len && data[p] == 0xFF) ++p;
  if (p >= len || data[p] != 0xD9) {
    set_error("JPEG-LS stream missing EOI");
    return false;
  }
  *rows_out = rows;
  *cols_out = cols;
  return true;
}

// Decode one slice into `pixels` (resized), returning rows/cols.
// Mirrors read_dicom() in dicomlite.py.
bool decode_dicom(const uint8_t* raw, size_t raw_len,
                  std::vector<float>* pixels, int* rows_out, int* cols_out) {
  const uint8_t* body = raw;
  size_t body_len = raw_len;
  std::string transfer_syntax = "1.2.840.10008.1.2.1";

  if (raw_len >= 132 && std::memcmp(raw + 128, "DICM", 4) == 0) {
    // file meta group is always explicit VR LE
    ByteReader r{raw, raw_len, 132, true};
    size_t meta_end = raw_len;
    bool first = true;
    while (r.pos < meta_end && !r.atend()) {
      size_t mark = r.pos;
      Element e = read_element(r);
      if (!r.ok) break;
      if (e.group != 0x0002) { r.pos = mark; break; }
      if (e.length > raw_len - r.pos) { set_error("file meta overruns"); return false; }
      std::vector<uint8_t> value(raw + r.pos, raw + r.pos + e.length);
      r.pos += e.length;
      if (first && e.group == 0x0002 && e.elem == 0x0000 && value.size() == 4) {
        uint32_t glen = (uint32_t)value[0] | ((uint32_t)value[1] << 8) |
                        ((uint32_t)value[2] << 16) | ((uint32_t)value[3] << 24);
        meta_end = r.pos + glen;
      }
      if (e.group == 0x0002 && e.elem == 0x0010)
        transfer_syntax = ascii_value(value);
      first = false;
    }
    body = raw + r.pos;
    body_len = raw_len - r.pos;
  } else if (raw_len >= 4 && std::memcmp(raw, "DICM", 4) == 0) {
    body = raw + 4;
    body_len = raw_len - 4;
  }

  bool explicit_vr;
  bool rle = false, jpegll = false, jls = false, big = false;
  if (transfer_syntax == "1.2.840.10008.1.2.1") explicit_vr = true;
  else if (transfer_syntax == "1.2.840.10008.1.2") explicit_vr = false;
  else if (transfer_syntax == "1.2.840.10008.1.2.2") {
    explicit_vr = true;
    big = true;
  }
  else if (transfer_syntax == "1.2.840.10008.1.2.5") {
    // RLE Lossless, JPEG Lossless and JPEG-LS decode natively; other
    // compressed syntaxes (baseline JPEG, J2K) fall back to the Python
    // reader (cli/runner.py retries parse failures there)
    explicit_vr = true;
    rle = true;
  } else if (transfer_syntax == "1.2.840.10008.1.2.4.57" ||
             transfer_syntax == "1.2.840.10008.1.2.4.70") {
    explicit_vr = true;
    jpegll = true;
  } else if (transfer_syntax == "1.2.840.10008.1.2.4.80" ||
             transfer_syntax == "1.2.840.10008.1.2.4.81") {
    explicit_vr = true;
    jls = true;
  }
  else { set_error("unsupported transfer syntax: " + transfer_syntax); return false; }

  DataSet ds;
  if (!parse_dataset(body, body_len, explicit_vr, &ds, rle || jpegll || jls,
                     big))
    return false;

  long rows = 0, cols = 0;
  if (!meta_int(ds, tag(0x0028, 0x0010), &rows, big) ||
      !meta_int(ds, tag(0x0028, 0x0011), &cols, big) ||
      (!ds.pixel_data && ds.fragments.empty())) {
    set_error("missing Rows/Columns/PixelData");
    return false;
  }
  if ((rle || jpegll || jls) && ds.pixel_data) {
    set_error("compressed transfer syntax with native PixelData (malformed file)");
    return false;
  }
  long bits = 16, pixrep = 0, samples = 1;
  meta_int(ds, tag(0x0028, 0x0100), &bits, big);
  meta_int(ds, tag(0x0028, 0x0103), &pixrep, big);
  meta_int(ds, tag(0x0028, 0x0002), &samples, big);
  if (samples != 1) { set_error("only monochrome supported"); return false; }
  if (bits != 8 && bits != 16) { set_error("unsupported BitsAllocated"); return false; }
  bool is_signed = pixrep == 1;
  // photometric interpretation (PS3.3 C.7.6.3.1.2), checked BEFORE any
  // frame decompression: PALETTE COLOR stores LUT indexes (reject);
  // MONOCHROME1 stores inverted grayscale — normalize to MONOCHROME2 on
  // the stored values with base = lo+hi of the stored range (unsigned:
  // 2^BitsStored-1; signed: -1). Mirrors dicomlite.py.
  std::string pi;
  {
    auto it = ds.meta.find(tag(0x0028, 0x0004));
    if (it != ds.meta.end()) pi = ascii_value(it->second);
  }
  if (pi == "PALETTE COLOR") {
    set_error("PALETTE COLOR images are out of envelope; convert to grayscale");
    return false;
  }
  long bits_stored = bits;
  meta_int(ds, tag(0x0028, 0x0101), &bits_stored, big);
  if (bits_stored < 1 || bits_stored > bits) {
    set_error("BitsStored outside [1, BitsAllocated]");
    return false;
  }
  long high_bit = bits_stored - 1;
  meta_int(ds, tag(0x0028, 0x0102), &high_bit, big);
  if (high_bit != bits_stored - 1) {
    // standard layout only (PS3.5 8.1.1); exotic packings would misread
    set_error("HighBit != BitsStored-1; repack with gdcmconv/dcmconv");
    return false;
  }
  bool invert = pi == "MONOCHROME1";
  long invert_base = invert ? (is_signed ? -1 : (1L << bits_stored) - 1) : 0;

  // NumberOfFrames (0028,0008), VR IS: digits or absent. Mirrors the
  // Python reader's _meta_int_str STRICTLY — exactly one optional sign
  // then ASCII digits; anything else (embedded whitespace stol would
  // skip, binary-looking bytes) means 1. A positive value too large for
  // long can never match real data (Python rejects such files at its
  // size/fragment checks), so it rejects here — acceptance-identical.
  long nframes = 1;
  {
    auto it = ds.meta.find(tag(0x0028, 0x0008));
    if (it != ds.meta.end()) {
      std::string s = ascii_value(it->second);
      std::string body = (!s.empty() && (s[0] == '+' || s[0] == '-'))
                             ? s.substr(1)
                             : s;
      bool digits = !body.empty() &&
                    body.find_first_not_of("0123456789") == std::string::npos;
      if (digits) {
        if (!s.empty() && s[0] == '-') {
          nframes = 1;  // < 1 clamps to 1, like the Python reader
        } else {
          try {
            nframes = std::max(1L, std::stol(s));
          } catch (const std::out_of_range&) {
            set_error("NumberOfFrames implausible");
            return false;
          }
        }
      }
    }
  }

  size_t expected = (size_t)rows * cols * (bits / 8);
  // Plausibility bound BEFORE any decode-side allocation: the uncompressed
  // path is implicitly bounded by the file size (pixel_len < expected
  // rejects), but RLE expands, so hostile Rows/Columns (65535 x 65535 =
  // an 8.6 GB resize) must fail gracefully here, not via std::bad_alloc
  // escaping the C ABI.
  if (rows <= 0 || cols <= 0 || rows > 32768 || cols > 32768 ||
      expected > ((size_t)1 << 28)) {
    set_error("implausible Rows/Columns");
    return false;
  }
  std::vector<uint8_t> decomp_buf;  // decoded samples as LE bytes
  if (rle) {
    // one fragment per frame (PS3.5 A.4.2); this reader serves frame 0 of
    // a multi-frame file, like the Python reader's default
    if ((long)ds.fragments.size() != nframes) {
      set_error("RLE fragment count disagrees with NumberOfFrames");
      return false;
    }
    if (!rle_decode_frame(ds.fragments[0].first, ds.fragments[0].second,
                          (size_t)rows, (size_t)cols, (int)(bits / 8),
                          &decomp_buf))
      return false;
    ds.pixel_data = decomp_buf.data();
    ds.pixel_len = decomp_buf.size();
  } else if (jpegll || jls) {
    // single fragment (the common single-frame case) decodes in place; a
    // frame spanning fragments is joined first. Multi-frame files delimit
    // frames by their SOI-starting fragments — the codestream count must
    // match NumberOfFrames and frame 0's group decodes, mirroring the
    // Python reader's _frame_payload exactly (acceptance parity).
    size_t first_begin = 0, first_end = ds.fragments.size();
    if (nframes > 1) {
      long groups = 0;
      for (size_t i = 0; i < ds.fragments.size(); ++i) {
        bool soi = ds.fragments[i].second >= 2 &&
                   ds.fragments[i].first[0] == 0xFF &&
                   ds.fragments[i].first[1] == 0xD8;
        if (soi || groups == 0) {
          ++groups;
          if (groups == 1) first_begin = i;
          if (groups == 2) first_end = i;
        }
      }
      if (groups != nframes) {
        set_error("JPEG codestream count disagrees with NumberOfFrames");
        return false;
      }
    }
    const uint8_t* stream_ptr = ds.fragments[first_begin].first;
    size_t stream_len = ds.fragments[first_begin].second;
    std::vector<uint8_t> joined;
    if (first_end - first_begin > 1) {
      for (size_t i = first_begin; i < first_end; ++i)
        joined.insert(joined.end(), ds.fragments[i].first,
                      ds.fragments[i].first + ds.fragments[i].second);
      stream_ptr = joined.data();
      stream_len = joined.size();
    }
    std::vector<uint16_t> samples;
    long jr = 0, jc = 0;
    bool ok = jls ? jpegls_decode(stream_ptr, stream_len, rows, cols,
                                  &samples, &jr, &jc)
                  : jpeg_lossless_decode(stream_ptr, stream_len, rows, cols,
                                         &samples, &jr, &jc);
    if (!ok) return false;
    decomp_buf.resize(samples.size() * (bits / 8));
    if (bits == 16) {
      for (size_t i = 0; i < samples.size(); ++i) {
        decomp_buf[2 * i] = (uint8_t)(samples[i] & 0xFF);
        decomp_buf[2 * i + 1] = (uint8_t)(samples[i] >> 8);
      }
    } else {
      for (size_t i = 0; i < samples.size(); ++i) {
        if (samples[i] > 0xFF) {
          set_error((jls ? "JPEG-LS" : "lossless JPEG") +
                    std::string(" precision exceeds BitsAllocated=8"));
          return false;
        }
        decomp_buf[i] = (uint8_t)samples[i];
      }
    }
    ds.pixel_data = decomp_buf.data();
    ds.pixel_len = decomp_buf.size();
  }
  // a multi-frame file must carry ALL its declared frames even though
  // this reader serves only frame 0 — the Python reader enforces the same
  // (a lying NumberOfFrames is a malformed file, not a short read).
  // Division, not multiplication: expected * nframes could overflow
  // size_t and bypass the check (expected >= 1 — rows/cols validated > 0).
  if (ds.pixel_len < expected ||
      (!(rle || jpegll || jls) &&
       ds.pixel_len / expected < (size_t)nframes)) {
    set_error("PixelData truncated");
    return false;
  }

  double slope = meta_float(ds, tag(0x0028, 0x1053), 1.0);
  double intercept = meta_float(ds, tag(0x0028, 0x1052), 0.0);
  float fslope = (float)slope, fintercept = (float)intercept;

  pixels->resize((size_t)rows * cols);
  const uint8_t* p = ds.pixel_data;
  float* dst = pixels->data();
  size_t n = (size_t)rows * cols;
  // decoded/compressed buffers are always little-endian sample bytes; only
  // native big-endian PixelData arrives byte-swapped
  const int lo = big ? 1 : 0, hi = big ? 0 : 1;
  // bits above BitsStored are overlay planes / garbage in historical
  // files: mask (unsigned) or sign-extend from the stored sign bit
  // (signed), as DCMTK's DicomImage does; no-op when BitsStored ==
  // BitsAllocated (the sign extension below reproduces the (int16_t) /
  // (int8_t) casts the raw loops used to apply)
  const long stored_mask = (bits_stored >= 64) ? -1L : (1L << bits_stored) - 1;
  const long sign_bit = 1L << (bits_stored - 1);
  auto store = [&](size_t i, long raw) {
    raw &= stored_mask;
    if (is_signed) raw = (raw ^ sign_bit) - sign_bit;
    if (invert) raw = invert_base - raw;
    dst[i] = (float)raw * fslope + fintercept;
  };
  if (bits == 16) {
    for (size_t i = 0; i < n; ++i)
      store(i, (long)(uint16_t)(p[2 * i + lo] | (p[2 * i + hi] << 8)));
  } else {
    for (size_t i = 0; i < n; ++i) store(i, (long)p[i]);
  }
  *rows_out = (int)rows;
  *cols_out = (int)cols;
  return true;
}

// ---------------------------------------------------------------------------
// Baseline JPEG encoder (grayscale)
// ---------------------------------------------------------------------------

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ITU-T T.81 Table K.1 (luminance quantization)
const int kQuantLum[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

// ITU-T T.81 Annex K.3 standard luminance Huffman tables
const uint8_t kDcBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCode { uint16_t code; uint8_t len; };

// Canonical Huffman code assignment (T.81 Annex C).
void build_codes(const uint8_t bits[17], const uint8_t* vals, int nvals,
                 HuffCode table[256]) {
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len]; ++i) {
      table[vals[k]] = {(uint16_t)code, (uint8_t)len};
      ++code;
      ++k;
    }
    code <<= 1;
  }
  (void)nvals;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;

  void put(uint32_t bits, int len) {
    acc = (acc << len) | (bits & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);  // byte stuffing
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) put(0x7F, 8 - nbits);  // pad with 1s
  }
};

void put_marker_u16(std::vector<uint8_t>& o, uint16_t v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)(v & 0xFF));
}

int bit_category(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) { ++n; a >>= 1; }
  return n;
}

// Plain separable float DCT-II with precomputed basis; clear and fast enough
// for host-side export (encoding overlaps device compute in the runner).
struct DctBasis {
  float c[8][8];
  DctBasis() {
    for (int k = 0; k < 8; ++k)
      for (int x = 0; x < 8; ++x)
        c[k][x] = std::cos((2 * x + 1) * k * 3.14159265358979323846 / 16.0) *
                  (k == 0 ? std::sqrt(0.125) : 0.5);
  }
};

long jpeg_encode_gray(const uint8_t* pix, int h, int w, int quality,
                      uint8_t* out, long cap) {
  if (h <= 0 || w <= 0 || h > 65500 || w > 65500) { set_error("bad dims"); return -1; }
  quality = std::min(100, std::max(1, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  uint8_t qt[64];
  for (int i = 0; i < 64; ++i) {
    int v = (kQuantLum[i] * scale + 50) / 100;
    qt[i] = (uint8_t)std::min(255, std::max(1, v));
  }

  // magic statics: thread-safe one-time init (encoder runs on a thread pool)
  struct HuffTables {
    HuffCode dc[256] = {}, ac[256] = {};
    HuffTables() {
      build_codes(kDcBits, kDcVals, 12, dc);
      build_codes(kAcBits, kAcVals, 162, ac);
    }
  };
  static const HuffTables huff;
  const HuffCode* dc_table = huff.dc;
  const HuffCode* ac_table = huff.ac;
  static const DctBasis basis;

  std::vector<uint8_t> o;
  o.reserve((size_t)h * w / 4 + 1024);

  // SOI, APP0/JFIF
  put_marker_u16(o, 0xFFD8);
  put_marker_u16(o, 0xFFE0);
  put_marker_u16(o, 16);
  const char jfif[] = "JFIF";
  o.insert(o.end(), jfif, jfif + 5);
  o.push_back(1); o.push_back(1);       // version 1.1
  o.push_back(0);                        // aspect-ratio units
  put_marker_u16(o, 1); put_marker_u16(o, 1);
  o.push_back(0); o.push_back(0);       // no thumbnail

  // DQT (zigzag order)
  put_marker_u16(o, 0xFFDB);
  put_marker_u16(o, 2 + 1 + 64);
  o.push_back(0x00);
  for (int i = 0; i < 64; ++i) o.push_back(qt[kZigzag[i]]);

  // SOF0: 8-bit, 1 component
  put_marker_u16(o, 0xFFC0);
  put_marker_u16(o, 2 + 6 + 3);
  o.push_back(8);
  put_marker_u16(o, (uint16_t)h);
  put_marker_u16(o, (uint16_t)w);
  o.push_back(1);
  o.push_back(1); o.push_back(0x11); o.push_back(0);

  // DHT: DC then AC
  put_marker_u16(o, 0xFFC4);
  put_marker_u16(o, (uint16_t)(2 + 1 + 16 + 12));
  o.push_back(0x00);
  for (int i = 1; i <= 16; ++i) o.push_back(kDcBits[i]);
  o.insert(o.end(), kDcVals, kDcVals + 12);
  put_marker_u16(o, 0xFFC4);
  put_marker_u16(o, (uint16_t)(2 + 1 + 16 + 162));
  o.push_back(0x10);
  for (int i = 1; i <= 16; ++i) o.push_back(kAcBits[i]);
  o.insert(o.end(), kAcVals, kAcVals + 162);

  // SOS
  put_marker_u16(o, 0xFFDA);
  put_marker_u16(o, 2 + 1 + 2 + 3);
  o.push_back(1);
  o.push_back(1); o.push_back(0x00);
  o.push_back(0); o.push_back(63); o.push_back(0);

  BitWriter bw{o};
  int prev_dc = 0;
  float block[64], tmp[64], coef[64];

  for (int by = 0; by < h; by += 8) {
    for (int bx = 0; bx < w; bx += 8) {
      // fetch 8x8 block, edge-replicated, level-shifted
      for (int y = 0; y < 8; ++y) {
        int sy = std::min(by + y, h - 1);
        for (int x = 0; x < 8; ++x) {
          int sx = std::min(bx + x, w - 1);
          block[y * 8 + x] = (float)pix[(size_t)sy * w + sx] - 128.0f;
        }
      }
      // rows then columns
      for (int y = 0; y < 8; ++y)
        for (int k = 0; k < 8; ++k) {
          float s = 0;
          for (int x = 0; x < 8; ++x) s += block[y * 8 + x] * basis.c[k][x];
          tmp[y * 8 + k] = s;
        }
      for (int k = 0; k < 8; ++k)
        for (int u = 0; u < 8; ++u) {
          float s = 0;
          for (int y = 0; y < 8; ++y) s += tmp[y * 8 + k] * basis.c[u][y];
          coef[u * 8 + k] = s;
        }

      int q[64];
      for (int i = 0; i < 64; ++i) {
        float v = coef[kZigzag[i]] / (float)qt[kZigzag[i]];
        q[i] = (int)std::lround(v);
      }

      // DC
      int diff = q[0] - prev_dc;
      prev_dc = q[0];
      int s = bit_category(diff);
      bw.put(dc_table[s].code, dc_table[s].len);
      if (s) bw.put(diff < 0 ? (uint32_t)(diff + (1 << s) - 1) : (uint32_t)diff, s);

      // AC with run-length, ZRL, EOB
      int run = 0;
      for (int i = 1; i < 64; ++i) {
        if (q[i] == 0) { ++run; continue; }
        while (run > 15) {
          bw.put(ac_table[0xF0].code, ac_table[0xF0].len);
          run -= 16;
        }
        int sz = bit_category(q[i]);
        int sym = (run << 4) | sz;
        bw.put(ac_table[sym].code, ac_table[sym].len);
        bw.put(q[i] < 0 ? (uint32_t)(q[i] + (1 << sz) - 1) : (uint32_t)q[i], sz);
        run = 0;
      }
      if (run > 0) bw.put(ac_table[0x00].code, ac_table[0x00].len);
    }
  }
  bw.flush();
  put_marker_u16(o, 0xFFD9);

  if ((long)o.size() > cap) { set_error("output buffer too small"); return -1; }
  std::memcpy(out, o.data(), o.size());
  return (long)o.size();
}

// ---------------------------------------------------------------------------
// Host-export renderer — mirrors render/host_render.py operation for
// operation (same f32 arithmetic, same association order, numpy's
// round-half-even via nearbyintf, truncating uint8 casts), so the C++ and
// NumPy paths produce IDENTICAL bytes. The library builds with
// -ffp-contract=off so the compiler cannot fuse the lerp into FMAs numpy
// does not use. Reference contract: RenderToImage(Black, 512, 512) +
// ImageRenderer / SegmentationRenderer({1: White}, 0.6, 1.0, 2)
// (main_sequential.cpp:49-78).
// ---------------------------------------------------------------------------

struct LetterboxCoords {
  std::vector<float> src_y, src_x;
  std::vector<uint8_t> in_y, in_x;
};

LetterboxCoords letterbox_coords(int h, int w, int out_size) {
  LetterboxCoords lc;
  lc.src_y.resize(out_size); lc.src_x.resize(out_size);
  lc.in_y.resize(out_size); lc.in_x.resize(out_size);
  float fh = (float)h, fw = (float)w;
  float scale = std::min((float)out_size / fh, (float)out_size / fw);
  float dest_h = fh * scale, dest_w = fw * scale;
  float off_y = ((float)out_size - dest_h) / 2.0f;
  float off_x = ((float)out_size - dest_w) / 2.0f;
  for (int o = 0; o < out_size; ++o) {
    float fo = (float)o;
    lc.src_y[o] = (fo - off_y + 0.5f) / scale - 0.5f;
    lc.src_x[o] = (fo - off_x + 0.5f) / scale - 0.5f;
    lc.in_y[o] = (fo >= std::floor(off_y)) && (fo < std::ceil(off_y + dest_h));
    lc.in_x[o] = (fo >= std::floor(off_x)) && (fo < std::ceil(off_x + dest_w));
  }
  return lc;
}

void render_gray_impl(const float* pixels, int stride, int h, int w,
                      const LetterboxCoords& lc, int out_size,
                      uint8_t* out) {
  // auto-window over the true region only
  float vmin = pixels[0], vmax = pixels[0];
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      float v = pixels[(size_t)y * stride + x];
      vmin = std::min(vmin, v);
      vmax = std::max(vmax, v);
    }
  float rng = std::max(vmax - vmin, 1e-6f);
  // per-column sample coordinates are row-invariant: compute once
  std::vector<int> x0s(out_size), x1s(out_size);
  std::vector<float> fxs(out_size);
  for (int ox = 0; ox < out_size; ++ox) {
    float sx = lc.src_x[ox];
    x0s[ox] = std::min(std::max((int)std::floor(sx), 0), w - 1);
    x1s[ox] = std::min(x0s[ox] + 1, w - 1);
    fxs[ox] = std::min(std::max(sx - (float)x0s[ox], 0.0f), 1.0f);
  }
  for (int oy = 0; oy < out_size; ++oy) {
    uint8_t* orow = out + (size_t)oy * out_size;
    if (!lc.in_y[oy]) {
      std::memset(orow, 0, out_size);
      continue;
    }
    float sy = lc.src_y[oy];
    int y0 = std::min(std::max((int)std::floor(sy), 0), h - 1);
    int y1 = std::min(y0 + 1, h - 1);
    float fy = std::min(std::max(sy - (float)y0, 0.0f), 1.0f);
    const float* r0 = pixels + (size_t)y0 * stride;
    const float* r1 = pixels + (size_t)y1 * stride;
    for (int ox = 0; ox < out_size; ++ox) {
      uint8_t px = 0;
      if (lc.in_x[ox]) {
        int x0 = x0s[ox], x1 = x1s[ox];
        float fx = fxs[ox];
        // numpy: rows = img[y0]*(1-fy) + img[y1]*fy; out = rows[x0]*(1-fx)
        //        + rows[x1]*fx — keep the exact association
        float a = r0[x0] * (1.0f - fy) + r1[x0] * fy;
        float b = r0[x1] * (1.0f - fy) + r1[x1] * fy;
        float sampled = a * (1.0f - fx) + b * fx;
        float g = (sampled - vmin) / rng * 255.0f;
        g = std::min(std::max(g, 0.0f), 255.0f);
        px = (uint8_t)g;  // truncation, like astype(uint8)
      }
      orow[ox] = px;
    }
  }
}

void render_seg_impl(const uint8_t* mask, int stride, int h, int w,
                     const LetterboxCoords& lc, int out_size, float opacity,
                     float border_opacity, int border_radius, uint8_t* out) {
  // nearest-sampled binary mask, restricted to the letterbox interior
  std::vector<uint8_t> m((size_t)out_size * out_size);
  std::vector<int> yy(out_size), xx(out_size);
  for (int o = 0; o < out_size; ++o) {
    // numpy np.round rounds half to even: nearbyintf under the default
    // FE_TONEAREST mode matches it exactly
    yy[o] = std::min(std::max((int)std::nearbyintf(lc.src_y[o]), 0), h - 1);
    xx[o] = std::min(std::max((int)std::nearbyintf(lc.src_x[o]), 0), w - 1);
  }
  for (int oy = 0; oy < out_size; ++oy)
    for (int ox = 0; ox < out_size; ++ox)
      m[(size_t)oy * out_size + ox] =
          (mask[(size_t)yy[oy] * stride + xx[ox]] > 0) && lc.in_y[oy] &&
          lc.in_x[ox];
  // binary erosion, euclidean-disk element of size 2r+1, zero padding —
  // the same offsets ops.neighborhood.footprint_offsets(size, "disk")
  // enumerates
  int size = 2 * border_radius + 1;
  int r = size / 2;
  double rad2 = (size / 2.0) * (size / 2.0);
  std::vector<std::pair<int, int>> offs;
  for (int dr = -r; dr <= r; ++dr)
    for (int dc = -r; dc <= r; ++dc)
      if ((double)(dr * dr + dc * dc) <= rad2) offs.emplace_back(dr, dc);
  const uint8_t interior_px = (uint8_t)std::min(
      std::max(opacity * 255.0f, 0.0f), 255.0f);
  const uint8_t border_px = (uint8_t)std::min(
      std::max(border_opacity * 255.0f, 0.0f), 255.0f);
  for (int oy = 0; oy < out_size; ++oy) {
    for (int ox = 0; ox < out_size; ++ox) {
      uint8_t cur = m[(size_t)oy * out_size + ox];
      if (!cur) {  // outside the mask the erosion result is irrelevant
        out[(size_t)oy * out_size + ox] = 0;
        continue;
      }
      uint8_t interior = 1;
      for (auto& od : offs) {
        int y = oy + od.first, x = ox + od.second;
        uint8_t v = (y >= 0 && y < out_size && x >= 0 && x < out_size)
                        ? m[(size_t)y * out_size + x]
                        : 0;
        if (!v) { interior = 0; break; }
      }
      out[(size_t)oy * out_size + ox] = interior ? interior_px : border_px;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

NM03_EXPORT const char* nm03_last_error() { return g_error.c_str(); }

NM03_EXPORT int nm03_version() { return 1; }

// Decode one slice. `out` must hold max_elems floats; rows*cols must fit.
// Returns 0 on success.
NM03_EXPORT int nm03_dicom_read(const char* path, float* out, long max_elems,
                                int* rows, int* cols) {
  try {
    std::vector<uint8_t> raw;
    if (!read_file(path, &raw)) return 1;
    std::vector<float> pixels;
    if (!decode_dicom(raw.data(), raw.size(), &pixels, rows, cols)) return 2;
    if ((long)pixels.size() > max_elems) { set_error("output buffer too small"); return 3; }
    std::memcpy(out, pixels.data(), pixels.size() * sizeof(float));
    return 0;
  } catch (const std::exception& e) {
    // an exception must never unwind through the extern "C" boundary (UB)
    set_error(std::string("decode exception: ") + e.what());
    return 2;
  }
}

// Thread-pool batch decode into a padded canvas arena.
//
// This is the native core of the host->HBM prefetch path: the TPU-side
// replacement for the reference's OpenMP parallel-for over a slice batch
// (main_parallel.cpp:336) applied where it belongs on TPU — the host decode
// stage, so the device sees one contiguous (n, canvas_h, canvas_w) float32
// arena ready for device_put.
//
//   paths    — n C strings
//   out      — n * canvas_h * canvas_w floats, zero-padded per slot
//   dims     — n * 2 ints (rows, cols); untouched slots stay as passed in
//   ok       — n flags: 1 decoded + guards passed, 0 failed (per-slice
//              catch-and-continue, main_sequential.cpp:267-271)
//   err      — optional (may be NULL) n codes: 0 ok, 1 read failed,
//              2 parse failed, 3 below min_dim, 4 exceeds canvas
//   min_dim  — reject slices smaller than this (main_sequential.cpp:189-192)
// Returns the number of successfully decoded slices.
NM03_EXPORT int nm03_load_batch(const char** paths, int n, int canvas_h,
                                int canvas_w, int min_dim, int threads,
                                float* out, int* dims, unsigned char* ok,
                                int* err) {
  if (n <= 0) return 0;
  threads = std::max(1, std::min(threads, n));
  std::atomic<int> next(0), good(0);
  auto worker = [&]() {
    std::vector<float> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      ok[i] = 0;
      auto fail = [&](int code) { if (err) err[i] = code; };
      int rows = 0, cols = 0;
      std::vector<uint8_t> raw;
      try {
        if (!read_file(paths[i], &raw)) { fail(1); continue; }
        if (!decode_dicom(raw.data(), raw.size(), &pixels, &rows, &cols)) {
          fail(2);
          continue;
        }
      } catch (const std::exception&) {
        // per-slice catch-and-continue: an exception escaping a std::thread
        // lambda would std::terminate the whole Python process
        fail(2);
        continue;
      }
      if (rows < min_dim || cols < min_dim) { fail(3); continue; }
      if (rows > canvas_h || cols > canvas_w) { fail(4); continue; }
      if (err) err[i] = 0;
      float* slot = out + (size_t)i * canvas_h * canvas_w;
      std::memset(slot, 0, (size_t)canvas_h * canvas_w * sizeof(float));
      for (int y = 0; y < rows; ++y)
        std::memcpy(slot + (size_t)y * canvas_w, pixels.data() + (size_t)y * cols,
                    (size_t)cols * sizeof(float));
      dims[2 * i] = rows;
      dims[2 * i + 1] = cols;
      ok[i] = 1;
      good.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return good.load();
}

// Baseline JPEG (grayscale). Returns bytes written, or -1 on error.
// Render the export pair for one slice: letterboxed auto-windowed grayscale
// + white-overlay segmentation render, byte-identical to the NumPy host
// renderer (render/host_render.py). pixels is the (canvas_h, canvas_w)
// padded f32 canvas; (h, w) the slice's true dims; both outputs are
// (out_size, out_size) uint8. Returns 0 on success.
NM03_EXPORT int nm03_render_pair(const float* pixels, int canvas_h,
                                 int canvas_w, const unsigned char* mask,
                                 int mask_h, int mask_w, int h, int w,
                                 int out_size, float opacity,
                                 float border_opacity, int border_radius,
                                 unsigned char* gray_out,
                                 unsigned char* seg_out) {
  try {
    if (h <= 0 || w <= 0 || h > canvas_h || w > canvas_w || h > mask_h ||
        w > mask_w || out_size <= 0 || border_radius < 0) {
      set_error("render: bad dimensions");
      return 1;
    }
    LetterboxCoords lc = letterbox_coords(h, w, out_size);
    render_gray_impl(pixels, canvas_w, h, w, lc, out_size, gray_out);
    render_seg_impl(mask, mask_w, h, w, lc, out_size, opacity,
                    border_opacity, border_radius, seg_out);
    return 0;
  } catch (const std::exception& e) {
    set_error(std::string("render exception: ") + e.what());
    return 2;
  }
}

NM03_EXPORT long nm03_jpeg_encode_gray(const unsigned char* pixels, int h,
                                       int w, int quality, unsigned char* out,
                                       long out_capacity) {
  return jpeg_encode_gray(pixels, h, w, quality, out, out_capacity);
}
