// Native I/O core for msm_tpu: npy pair writer for complex grids.
//
// Counterpart of the reference's Rust async dump path
// (`simulator/src/utils/io.rs:34-97`: host the array, split real/imag,
// write two npy files on worker threads). The Python layer owns threading
// and throttling (io/npy.py, mirroring MAX_CONCURRENT_GRID_WRITES,
// `simulator/src/simulation_object.rs:39`); this library makes the
// per-write work cheap:
//
//  - splits interleaved complex data into planar real/imag in one pass
//    while streaming to disk (no numpy .real/.imag temporaries)
//  - writes npy v1.0 headers directly, to the exact path (no ".npy" suffix)
//  - releases the GIL for the entire call (invoked via ctypes)
//
// Build: make -C native   (produces libmsm_io.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// npy v1.0 header for little-endian dtype `descr` and C-order `shape`.
std::string npy_header(const char *descr, const uint64_t *shape, int ndim) {
  std::string dict = "{'descr': '";
  dict += descr;
  dict += "', 'fortran_order': False, 'shape': (";
  for (int i = 0; i < ndim; ++i) {
    dict += std::to_string(shape[i]);
    if (i + 1 < ndim) dict += ", ";
  }
  if (ndim == 1) dict += ",";  // numpy writes 1-tuples as "(n,)"
  dict += "), }";
  // Pad with spaces so that len(magic + header) % 64 == 0, newline-terminated.
  size_t base = 10 + dict.size() + 1;
  size_t pad = (64 - base % 64) % 64;
  dict.append(pad, ' ');
  dict += '\n';

  std::string out;
  out += "\x93NUMPY";
  out += '\x01';
  out += '\x00';
  uint16_t hlen = static_cast<uint16_t>(dict.size());
  out += static_cast<char>(hlen & 0xff);
  out += static_cast<char>((hlen >> 8) & 0xff);
  out += dict;
  return out;
}

constexpr size_t kChunkElems = 1 << 20;  // 1M elements per streamed chunk

template <typename T>
int write_plane(const char *path, const char *descr, const T *src,
                uint64_t n, const uint64_t *shape, int ndim, int stride,
                int offset) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return -1;
  std::string header = npy_header(descr, shape, ndim);
  if (std::fwrite(header.data(), 1, header.size(), f) != header.size()) {
    std::fclose(f);
    return -2;
  }
  std::vector<T> buf(std::min<uint64_t>(n, kChunkElems));
  uint64_t done = 0;
  while (done < n) {
    uint64_t m = std::min<uint64_t>(n - done, kChunkElems);
    const T *p = src + (done + 0) * stride + offset;
    for (uint64_t i = 0; i < m; ++i) buf[i] = p[i * stride];
    if (std::fwrite(buf.data(), sizeof(T), m, f) != m) {
      std::fclose(f);
      return -3;
    }
    done += m;
  }
  if (std::fclose(f) != 0) return -4;
  return 0;
}

template <typename T>
int write_pair_impl(const char *base, const char *descr, const T *data,
                    uint64_t n, const uint64_t *shape, int ndim) {
  std::string real_path = std::string(base) + "_real";
  std::string imag_path = std::string(base) + "_imag";
  // interleaved complex: stride 2, offsets 0 (re) and 1 (im)
  int rc = write_plane<T>(real_path.c_str(), descr, data, n, shape, ndim, 2, 0);
  if (rc != 0) return rc;
  return write_plane<T>(imag_path.c_str(), descr, data, n, shape, ndim, 2, 1);
}

template <typename T>
int read_plane(const char *path, T *dst, uint64_t n, int stride, int offset) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  // npy v1.0/v2.0 header: magic(6) ver(2) then u16/u32 header length
  unsigned char pre[10];
  if (std::fread(pre, 1, 10, f) != 10 || std::memcmp(pre, "\x93NUMPY", 6)) {
    std::fclose(f);
    return -2;
  }
  uint64_t hlen;
  long data_off;
  if (pre[6] == 1) {
    hlen = pre[8] | (pre[9] << 8);
    data_off = 10 + static_cast<long>(hlen);
  } else {
    unsigned char ext[2];
    if (std::fread(ext, 1, 2, f) != 2) {
      std::fclose(f);
      return -2;
    }
    hlen = pre[8] | (pre[9] << 8) | (static_cast<uint64_t>(ext[0]) << 16) |
           (static_cast<uint64_t>(ext[1]) << 24);
    data_off = 12 + static_cast<long>(hlen);
  }
  if (std::fseek(f, data_off, SEEK_SET) != 0) {
    std::fclose(f);
    return -3;
  }
  std::vector<T> buf(std::min<uint64_t>(n, kChunkElems));
  uint64_t done = 0;
  while (done < n) {
    uint64_t m = std::min<uint64_t>(n - done, kChunkElems);
    if (std::fread(buf.data(), sizeof(T), m, f) != m) {
      std::fclose(f);
      return -4;
    }
    T *p = dst + done * stride + offset;
    for (uint64_t i = 0; i < m; ++i) p[i * stride] = buf[i];
    done += m;
  }
  std::fclose(f);
  return 0;
}

}  // namespace

extern "C" {

// Read `{base}_real` / `{base}_imag` npy files into an interleaved complex
// buffer of n_elems elements (caller parses headers for shape/dtype and
// allocates). Returns 0 on success.
int msm_read_complex_pair(const char *base, void *out, uint64_t n_elems,
                          int is_double) {
  std::string real_path = std::string(base) + "_real";
  std::string imag_path = std::string(base) + "_imag";
  if (is_double) {
    double *dst = static_cast<double *>(out);
    int rc = read_plane<double>(real_path.c_str(), dst, n_elems, 2, 0);
    if (rc != 0) return rc;
    return read_plane<double>(imag_path.c_str(), dst, n_elems, 2, 1);
  }
  float *dst = static_cast<float *>(out);
  int rc = read_plane<float>(real_path.c_str(), dst, n_elems, 2, 0);
  if (rc != 0) return rc;
  return read_plane<float>(imag_path.c_str(), dst, n_elems, 2, 1);
}

// Write `{base}_real` / `{base}_imag` npy files from interleaved complex
// data (complex64 when is_double=0, complex128 when is_double=1).
// Returns 0 on success, negative on I/O failure.
int msm_write_complex_pair(const char *base, const void *data,
                           uint64_t n_elems, int is_double,
                           const uint64_t *shape, int ndim) {
  if (is_double) {
    return write_pair_impl<double>(base, "<f8",
                                   static_cast<const double *>(data), n_elems,
                                   shape, ndim);
  }
  return write_pair_impl<float>(base, "<f4", static_cast<const float *>(data),
                                n_elems, shape, ndim);
}

// Write a real npy file at exactly `path` (no suffix added).
int msm_write_npy(const char *path, const void *data, uint64_t n_elems,
                  int is_double, const uint64_t *shape, int ndim) {
  if (is_double) {
    return write_plane<double>(path, "<f8", static_cast<const double *>(data),
                               n_elems, shape, ndim, 1, 0);
  }
  return write_plane<float>(path, "<f4", static_cast<const float *>(data),
                            n_elems, shape, ndim, 1, 0);
}

}  // extern "C"
