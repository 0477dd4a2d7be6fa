// Optional GDCM-backed fallback importer for the JPEG 2000 transfer
// syntaxes (1.2.840.10008.1.2.4.90/.91 and the Part-2 variants).
//
// The in-tree importer (data/dicomlite.py + csrc/nm03native.cpp) owns every
// syntax the cohort actually uses — uncompressed LE/BE, RLE, JPEG lossless,
// JPEG-LS, baseline JPEG. JPEG 2000's EBCOT arithmetic coder is the one
// family where a from-scratch decoder buys nothing over the system
// libraries, so — exactly like the reference sits on DCMTK for its whole
// importer (FAST_directives.hpp:30) — this shim hands J2K files to the
// system GDCM when present. It is compiled on demand by
// nm03_capstone_project_tpu/data/gdcm_fallback.py only when the gdcm-3.0
// headers exist, and the importer degrades to the transcode-remedy error
// without it.
//
// Build (done by gdcm_fallback.py):
//   g++ -O2 -std=c++17 -shared -fPIC csrc/nm03gdcm.cpp \
//     -I/usr/include/gdcm-3.0 -lgdcmMSFF -lgdcmDSED -lgdcmCommon \
//     -o libnm03gdcm.so

#include <cstdint>
#include <cstring>
#include <string>

#include <gdcmImage.h>
#include <gdcmImageReader.h>
#include <gdcmPixelFormat.h>

#define NM03_EXPORT extern "C" __attribute__((visibility("default")))

namespace {
thread_local std::string g_error;
void set_error(const std::string& msg) { g_error = msg; }
}  // namespace

NM03_EXPORT const char* nm03_gdcm_last_error() { return g_error.c_str(); }

// Decode one 2D monochrome DICOM file into rescaled float32 pixels.
// Returns 0 on success; out must hold cap floats. rows/cols are outputs;
// scalar_out reports the raw sample type (0=u8, 1=i8, 2=u16, 3=i16) so the
// caller can surface an honest raw_dtype.
NM03_EXPORT int nm03_gdcm_read(const char* path, float* out, long cap,
                               long* rows_out, long* cols_out,
                               int* scalar_out) {
  try {
    gdcm::ImageReader reader;
    reader.SetFileName(path);
    if (!reader.Read()) {
      set_error("gdcm could not read the file");
      return 1;
    }
    const gdcm::Image& img = reader.GetImage();
    if (img.GetNumberOfDimensions() != 2) {
      set_error("gdcm fallback: only single-slice 2D files are in envelope");
      return 2;
    }
    const unsigned int* dims = img.GetDimensions();
    const long cols = dims[0], rows = dims[1];
    if (rows <= 0 || cols <= 0 || rows > 32768 || cols > 32768 ||
        rows * cols > cap) {
      set_error("gdcm fallback: implausible or oversized dimensions");
      return 3;
    }
    const gdcm::PixelFormat& pf = img.GetPixelFormat();
    if (pf.GetSamplesPerPixel() != 1) {
      set_error("gdcm fallback: only monochrome supported");
      return 4;
    }
    const size_t buflen = img.GetBufferLength();
    std::string buffer(buflen, '\0');
    if (!img.GetBuffer(buffer.data())) {
      set_error("gdcm fallback: pixel decode failed");
      return 5;
    }
    const double slope = img.GetSlope(), intercept = img.GetIntercept();
    const size_t n = (size_t)rows * cols;
    const auto st = pf.GetScalarType();
    if (st == gdcm::PixelFormat::UINT16 && buflen >= n * 2) {
      const uint8_t* p = (const uint8_t*)buffer.data();
      for (size_t i = 0; i < n; ++i)
        out[i] = (float)((double)(uint16_t)(p[2 * i] | (p[2 * i + 1] << 8)) *
                             slope + intercept);
      *scalar_out = 2;
    } else if (st == gdcm::PixelFormat::INT16 && buflen >= n * 2) {
      const uint8_t* p = (const uint8_t*)buffer.data();
      for (size_t i = 0; i < n; ++i)
        out[i] = (float)((double)(int16_t)(p[2 * i] | (p[2 * i + 1] << 8)) *
                             slope + intercept);
      *scalar_out = 3;
    } else if (st == gdcm::PixelFormat::UINT8 && buflen >= n) {
      const uint8_t* p = (const uint8_t*)buffer.data();
      for (size_t i = 0; i < n; ++i)
        out[i] = (float)((double)p[i] * slope + intercept);
      *scalar_out = 0;
    } else if (st == gdcm::PixelFormat::INT8 && buflen >= n) {
      const int8_t* p = (const int8_t*)buffer.data();
      for (size_t i = 0; i < n; ++i)
        out[i] = (float)((double)p[i] * slope + intercept);
      *scalar_out = 1;
    } else {
      set_error("gdcm fallback: unsupported pixel format " +
                std::string(pf.GetScalarTypeAsString()));
      return 6;
    }
    *rows_out = rows;
    *cols_out = cols;
    return 0;
  } catch (const std::exception& e) {
    set_error(std::string("gdcm fallback exception: ") + e.what());
    return 7;
  } catch (...) {
    set_error("gdcm fallback: unknown exception");
    return 7;
  }
}
