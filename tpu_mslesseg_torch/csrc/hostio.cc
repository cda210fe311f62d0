// hostio: native host-side IO for the pipeline's artifact fan-out.
//
// The extraction/prediction stages write hundreds of grayscale PNGs per
// patient (the reference does this serially through matplotlib/cv2,
// `extraer_dataset.py:192`, `generar_predicciones.py:153`). This library
// provides a minimal zlib-based PNG encoder and an OpenMP-parallel batch
// writer, exposed through a C ABI consumed via ctypes
// (tpu_mslesseg_torch/io/native.py).
//
// Build: g++ -O3 -shared -fPIC -fopenmp hostio.cc -lz -o libhostio.so

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, static_cast<uInt>(len + 4));
  put_be32(out, crc);
}

// Encode an 8-bit grayscale image into an in-memory PNG.
bool encode_gray_png(const uint8_t* img, int h, int w, int level,
                     std::vector<uint8_t>& out) {
  out.clear();
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 0;   // color type: grayscale
  ihdr[10] = 0;  // compression
  ihdr[11] = 0;  // filter
  ihdr[12] = 0;  // interlace
  put_chunk(out, "IHDR", ihdr, 13);

  // raw scanlines with filter byte 0
  std::vector<uint8_t> raw(static_cast<size_t>(h) * (w + 1));
  for (int r = 0; r < h; ++r) {
    raw[static_cast<size_t>(r) * (w + 1)] = 0;
    std::memcpy(&raw[static_cast<size_t>(r) * (w + 1) + 1],
                img + static_cast<size_t>(r) * w, w);
  }

  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> comp(bound);
  if (compress2(comp.data(), &bound, raw.data(),
                static_cast<uLong>(raw.size()), level) != Z_OK) {
    return false;
  }
  put_chunk(out, "IDAT", comp.data(), bound);
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

bool write_file(const char* path, const std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  size_t n = std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return n == buf.size();
}

}  // namespace

extern "C" {

// Write one grayscale PNG. Returns 0 on success.
int hostio_write_gray_png(const char* path, const uint8_t* img, int h, int w,
                          int level) {
  std::vector<uint8_t> buf;
  if (!encode_gray_png(img, h, w, level, buf)) return 1;
  return write_file(path, buf) ? 0 : 2;
}

// Write n grayscale PNGs in parallel. `paths` is an array of n C strings;
// `imgs` is n contiguous h*w images. Returns number of failures.
int hostio_write_gray_png_batch(const char** paths, const uint8_t* imgs,
                                int n, int h, int w, int level, int threads) {
  int failures = 0;
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#pragma omp parallel for reduction(+ : failures) schedule(dynamic)
#endif
  for (int i = 0; i < n; ++i) {
    std::vector<uint8_t> buf;
    const uint8_t* img = imgs + static_cast<size_t>(i) * h * w;
    if (!encode_gray_png(img, h, w, level, buf) || !write_file(paths[i], buf)) {
      failures += 1;
    }
  }
  return failures;
}

// gzip-compress a buffer (for .nii.gz payloads). Returns compressed size,
// or -1 on failure. `out` must have capacity `out_cap`.
long hostio_gzip(const uint8_t* in, long in_len, uint8_t* out, long out_cap,
                 int level) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 15+16 => gzip container
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK) {
    return -1;
  }
  zs.next_in = const_cast<Bytef*>(in);
  zs.avail_in = static_cast<uInt>(in_len);
  zs.next_out = out;
  zs.avail_out = static_cast<uInt>(out_cap);
  int rc = deflate(&zs, Z_FINISH);
  long written = static_cast<long>(zs.total_out);
  deflateEnd(&zs);
  return rc == Z_STREAM_END ? written : -1;
}

}  // extern "C"
