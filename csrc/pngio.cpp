// Native PNG encoder for the dataset writer's host-side hot path.
//
// The reference writes every frame's PNGs through Python imageio on
// ad-hoc threads (reference: pegasus.py:346-358).  The renderer outruns
// Python PNG encoding by an order of magnitude, so the
// encoder is native: zlib deflate + CRC behind a tiny C ABI, called from a
// bounded Python thread pool (the GIL is released for the entire encode,
// so the pool parallelizes for real).
//
// Supports: 8-bit gray/RGB/RGBA and 16-bit gray (the BOP depth format,
// millimeters, big-endian per the PNG spec).  Filter: per-row "up"/"sub"
// selection kept trivial (filter 0) — deflate already captures most of the
// win on rendered content, and encode speed is the point.
//
// Build: make -C csrc   (g++ -O3 -shared -fPIC pngio.cpp -lz)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

void put_u32_be(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

void write_chunk(std::vector<uint8_t>& out, const char type[4],
                 const uint8_t* data, size_t len) {
  put_u32_be(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out.data() + start, static_cast<uInt>(4 + len));
  put_u32_be(out, crc);
}

}  // namespace

extern "C" {

// Encode a PNG into a malloc'd buffer. Returns 0 on success.
//   data: row-major pixels; for bit_depth 16 the values are host-endian
//         uint16 and get byte-swapped to PNG big-endian here.
//   channels: 1, 3 or 4.  compression: zlib level 0-9.
// The caller frees *out with png_free().
int png_encode(const uint8_t* data, int width, int height, int channels,
               int bit_depth, int compression, uint8_t** out,
               size_t* out_len) {
  if (width <= 0 || height <= 0) return 1;
  if (channels != 1 && channels != 3 && channels != 4) return 2;
  if (bit_depth != 8 && bit_depth != 16) return 3;
  if (bit_depth == 16 && channels != 1) return 4;  // BOP depth only

  const int bytes_per_px = channels * (bit_depth / 8);
  const size_t stride = static_cast<size_t>(width) * bytes_per_px;

  // raw scanlines with filter byte 0
  std::vector<uint8_t> raw((stride + 1) * height);
  for (int y = 0; y < height; ++y) {
    uint8_t* row = raw.data() + y * (stride + 1);
    row[0] = 0;  // filter: none
    const uint8_t* src = data + y * stride;
    if (bit_depth == 16) {
      // host little-endian -> PNG big-endian
      for (int x = 0; x < width; ++x) {
        row[1 + 2 * x] = src[2 * x + 1];
        row[2 + 2 * x] = src[2 * x];
      }
    } else {
      std::memcpy(row + 1, src, stride);
    }
  }

  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> compressed(bound);
  if (compress2(compressed.data(), &bound, raw.data(),
                static_cast<uLong>(raw.size()), compression) != Z_OK) {
    return 5;
  }
  compressed.resize(bound);

  std::vector<uint8_t> png;
  png.reserve(compressed.size() + 128);
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  png.insert(png.end(), magic, magic + 8);

  uint8_t ihdr[13];
  ihdr[0] = (width >> 24) & 0xff;
  ihdr[1] = (width >> 16) & 0xff;
  ihdr[2] = (width >> 8) & 0xff;
  ihdr[3] = width & 0xff;
  ihdr[4] = (height >> 24) & 0xff;
  ihdr[5] = (height >> 16) & 0xff;
  ihdr[6] = (height >> 8) & 0xff;
  ihdr[7] = height & 0xff;
  ihdr[8] = static_cast<uint8_t>(bit_depth);
  ihdr[9] = channels == 1 ? 0 : (channels == 3 ? 2 : 6);  // color type
  ihdr[10] = 0;  // compression
  ihdr[11] = 0;  // filter
  ihdr[12] = 0;  // interlace
  write_chunk(png, "IHDR", ihdr, 13);
  write_chunk(png, "IDAT", compressed.data(), compressed.size());
  write_chunk(png, "IEND", nullptr, 0);

  *out_len = png.size();
  *out = static_cast<uint8_t*>(std::malloc(png.size()));
  if (!*out) return 6;
  std::memcpy(*out, png.data(), png.size());
  return 0;
}

void png_free(uint8_t* p) { std::free(p); }

// Encode + write to disk in one call (keeps the whole op outside the GIL).
int png_write_file(const char* path, const uint8_t* data, int width,
                   int height, int channels, int bit_depth, int compression) {
  uint8_t* buf = nullptr;
  size_t len = 0;
  int rc = png_encode(data, width, height, channels, bit_depth, compression,
                      &buf, &len);
  if (rc != 0) return rc;
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    png_free(buf);
    return 7;
  }
  size_t written = std::fwrite(buf, 1, len, f);
  std::fclose(f);
  png_free(buf);
  return written == len ? 0 : 8;
}

}  // extern "C"
