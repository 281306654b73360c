// Copy of tophat_tpu/native/bgzf.cpp (host code), unchanged below this line.
// Multithreaded BGZF encoder.
//
// The role of the reference's vendored libbam bgzf writer plus its pigz
// parallel-compression preference (reference: samtools-0.1.18/bgzf.c;
// zipper selection src/tophat.py:376-395): BGZF blocks are independent
// deflate members, so they compress in parallel and write out in order.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 bgzf.cpp -o libbgzf.so -lz

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBlock = 65000;  // uncompressed bytes per BGZF block

const uint8_t kEof[28] = {0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00,
                          0x00, 0xff, 0x06, 0x00, 0x42, 0x43, 0x02, 0x00,
                          0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
                          0x00, 0x00, 0x00, 0x00};

// One BGZF block: gzip header with the BC extra field, raw deflate
// payload, crc32 + isize trailer.
bool compress_block(const uint8_t* src, int len, int level,
                    std::vector<uint8_t>* out) {
  uLong bound = compressBound(len) + 64;
  out->resize(18 + bound + 8);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK) {
    return false;
  }
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = len;
  zs.next_out = out->data() + 18;
  zs.avail_out = bound;
  int rc = deflate(&zs, Z_FINISH);
  uLong clen = zs.total_out;
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return false;

  uint8_t* h = out->data();
  const uint8_t hdr[12] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                           6,    0};
  std::memcpy(h, hdr, 12);
  h[12] = 'B';
  h[13] = 'C';
  h[14] = 2;
  h[15] = 0;
  uint32_t bsize = static_cast<uint32_t>(clen) + 25;  // total - 1
  if (bsize > 0xffff) {
    // incompressible payload expanded past the 16-bit BSIZE field:
    // redo as stored deflate (level 0), whose worst case for 65000
    // bytes is ~65012 -> bsize ~65037 < 0xffff (samtools caps the
    // compressed size the same way, bgzf.c deflate_block)
    if (level == 0) return false;
    return compress_block(src, len, 0, out);
  }
  h[16] = bsize & 0xff;
  h[17] = (bsize >> 8) & 0xff;

  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, src, len);
  uint8_t* t = out->data() + 18 + clen;
  for (int i = 0; i < 4; ++i) t[i] = (crc >> (8 * i)) & 0xff;
  for (int i = 0; i < 4; ++i) t[4 + i] = (static_cast<uint32_t>(len)
                                          >> (8 * i)) & 0xff;
  out->resize(18 + clen + 8);
  return true;
}

}  // namespace

extern "C" {

// Compress `len` bytes into a BGZF file at `path` (with EOF marker).
// Returns 0 on success.
int bgzf_write_file(const char* path, const uint8_t* data, int64_t len,
                    int level, int nthreads) {
  int64_t nblocks = (len + kBlock - 1) / kBlock;
  std::vector<std::vector<uint8_t>> blocks(nblocks);
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;

  bool ok = true;
  auto worker = [&](int tid) {
    for (int64_t b = tid; b < nblocks; b += nthreads) {
      int64_t off = b * kBlock;
      int n = static_cast<int>(len - off < kBlock ? len - off : kBlock);
      if (!compress_block(data + off, n, level, &blocks[b])) ok = false;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < nthreads; ++t) ts.emplace_back(worker, t);
  worker(0);
  for (auto& t : ts) t.join();
  if (!ok) return 1;

  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  for (auto& b : blocks) {
    if (std::fwrite(b.data(), 1, b.size(), f) != b.size()) {
      std::fclose(f);
      return 3;
    }
  }
  if (std::fwrite(kEof, 1, sizeof(kEof), f) != sizeof(kEof)) {
    std::fclose(f);
    return 3;
  }
  std::fclose(f);
  return 0;
}

// Decompress an entire BGZF file into `out` (caller-allocated, size
// `cap`). Returns the decompressed length, or -1 on error / -2 if the
// buffer is too small (call again with a bigger one).
int64_t bgzf_read_file(const char* path, uint8_t* out, int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t total = 0;
  std::vector<uint8_t> cbuf;
  for (;;) {
    uint8_t hdr[18];
    size_t got = std::fread(hdr, 1, 18, f);
    if (got == 0) break;
    if (got < 18 || hdr[0] != 0x1f || hdr[1] != 0x8b) {
      std::fclose(f);
      return -1;
    }
    uint16_t xlen = hdr[10] | (hdr[11] << 8);
    // scan extra subfields for BC
    std::vector<uint8_t> extra(xlen);
    std::memcpy(extra.data(), hdr + 12, 6);
    if (xlen > 6 &&
        std::fread(extra.data() + 6, 1, xlen - 6, f) != size_t(xlen - 6)) {
      std::fclose(f);
      return -1;
    }
    int bsize = -1;
    for (int i = 0; i + 4 <= xlen;) {
      uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
      if (extra[i] == 'B' && extra[i + 1] == 'C')
        bsize = extra[i + 4] | (extra[i + 5] << 8);
      i += 4 + slen;
    }
    if (bsize < 0) {
      std::fclose(f);
      return -1;
    }
    int clen = bsize - xlen - 19;
    cbuf.resize(clen);
    if (std::fread(cbuf.data(), 1, clen, f) != size_t(clen)) {
      std::fclose(f);
      return -1;
    }
    uint8_t trailer[8];
    if (std::fread(trailer, 1, 8, f) != 8) {
      std::fclose(f);
      return -1;
    }
    uint32_t isize = trailer[4] | (trailer[5] << 8) | (trailer[6] << 16) |
                     (uint32_t(trailer[7]) << 24);
    if (total + isize > cap) {
      std::fclose(f);
      return -2;
    }
    if (isize > 0) {
      z_stream zs;
      std::memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) {
        std::fclose(f);
        return -1;
      }
      zs.next_in = cbuf.data();
      zs.avail_in = clen;
      zs.next_out = out + total;
      zs.avail_out = isize;
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) {
        std::fclose(f);
        return -1;
      }
      total += isize;
    }
  }
  std::fclose(f);
  return total;
}

}  // extern "C"
