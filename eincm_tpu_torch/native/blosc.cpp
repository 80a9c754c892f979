// LZ77 codecs decoded from their published formats (no external deps): the
// Blosc1 codecs blosclz (c-blosc's FastLZ-derived codec), the LZ4 block
// format (which LZ4HC writes too) and the raw Snappy format, and liblzf's
// format (h5py's LZF filter, HDF5 filter 32000). utils/blosc.py parses a
// Blosc chunk (header, block starts, split streams, shuffles) and calls
// these on each stream, utils/h5_lite.py calls lzf_decompress on a chunk;
// the plain Python decoders of utils/blosc.py are the reference they are
// tested against. Every read stays inside the source and every write inside
// the destination: a malformed stream returns -1, never reads or writes past.
// Zstd (Blosc codec 4, HDF5 filter 32015) is zstd.cpp's.

#include <cstdint>
#include <cstring>

namespace {

// out[op .. op + len) = out[op - dist .. op - dist + len), byte by byte
// where the two overlap (a run)
inline void copy_match(uint8_t* dst, int64_t op, int64_t dist, int64_t len) {
  const uint8_t* ref = dst + op - dist;
  uint8_t* out = dst + op;
  if (dist >= len) {
    std::memcpy(out, ref, static_cast<size_t>(len));
  } else {
    for (int64_t k = 0; k < len; ++k) out[k] = ref[k];
  }
}

constexpr int64_t kBlosclzMaxDistance = 8191;

}  // namespace

extern "C" {

// blosclz: a first literal run whose control byte's top 3 bits are free;
// then control bytes: < 32 a literal run of ctrl + 1 bytes, else a match of
// (ctrl >> 5) + 2 bytes (7: 9 + the sum of extra bytes, ended by one below
// 255) at distance ((ctrl & 31) << 8 | next) + 1, or, where that reads
// 31 << 8 | 255, at 8192 + the next two bytes (big endian).
// Returns the bytes written (which must be n_out), or -1.
int64_t blosclz_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t n_out) {
  if (n <= 0) return n_out == 0 ? 0 : -1;
  int64_t ip = 0, op = 0;
  uint32_t ctrl = src[ip++] & 31u;
  while (true) {
    if (ctrl >= 32) {
      int64_t len = static_cast<int64_t>(ctrl >> 5) - 1;
      int64_t ofs = static_cast<int64_t>(ctrl & 31u) << 8;
      if (len == 6) {
        uint8_t code;
        do {
          if (ip >= n) return -1;
          code = src[ip++];
          len += code;
        } while (code == 255);
      }
      if (ip >= n) return -1;
      uint8_t code = src[ip++];
      len += 3;
      int64_t dist = ofs + code + 1;
      if (code == 255 && ofs == (31 << 8)) {
        if (ip + 2 > n) return -1;
        dist = ((static_cast<int64_t>(src[ip]) << 8) | src[ip + 1]) + kBlosclzMaxDistance + 1;
        ip += 2;
      }
      if (dist > op || op + len > n_out) return -1;
      copy_match(dst, op, dist, len);
      op += len;
    } else {
      int64_t run = static_cast<int64_t>(ctrl) + 1;
      if (ip + run > n || op + run > n_out) return -1;
      std::memcpy(dst + op, src + ip, static_cast<size_t>(run));
      ip += run;
      op += run;
    }
    if (ip >= n) break;
    ctrl = src[ip++];
  }
  return op;
}

// LZ4 block: sequences of a token (literal length in the high nibble,
// match length - 4 in the low one; 15 continues in bytes up to one below
// 255), the literals, a 2-byte little-endian offset and the match; the
// last sequence has literals only. Returns the bytes written, or -1.
int64_t lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t n_out) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    uint8_t token = src[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n || op + lit > n_out) return -1;
    std::memcpy(dst + op, src + ip, static_cast<size_t>(lit));
    ip += lit;
    op += lit;
    if (ip >= n) break;  // the last sequence: literals only
    if (ip + 2 > n) return -1;
    int64_t dist = src[ip] | (static_cast<int64_t>(src[ip + 1]) << 8);
    ip += 2;
    int64_t len = (token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        len += b;
      } while (b == 255);
    }
    if (dist == 0 || dist > op || op + len > n_out) return -1;
    copy_match(dst, op, dist, len);
    op += len;
  }
  return op;
}

// Snappy's raw format: a varint (7 bits a byte, low first) of the
// uncompressed length, then elements by their tag's low 2 bits: 0 a literal
// of (tag >> 2) + 1 bytes (60-63: the length - 1 in the next 1-4 bytes,
// little endian); 1 a copy of 4 + ((tag >> 2) & 7) bytes at offset
// (tag >> 5) << 8 | the next byte; 2 and 3 a copy of (tag >> 2) + 1 bytes
// at the offset in the next 2 or 4 bytes. Returns the bytes written (the
// length the varint states), or -1.
int64_t snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t n_out) {
  int64_t ip = 0, op = 0, len = 0;
  for (int shift = 0;; shift += 7) {
    if (ip >= n || shift > 28) return -1;
    const uint8_t b = src[ip++];
    len |= static_cast<int64_t>(b & 127) << shift;
    if (!(b & 128)) break;
  }
  if (len > n_out) return -1;
  while (ip < n) {
    const uint8_t tag = src[ip++];
    int64_t run, dist = 0;
    if ((tag & 3) == 0) {
      run = tag >> 2;
      if (run >= 60) {
        const int nb = static_cast<int>(run) - 59;
        if (ip + nb > n) return -1;
        run = 0;
        for (int k = nb - 1; k >= 0; --k) run = (run << 8) | src[ip + k];
        ip += nb;
      }
      run += 1;
      if (run > n - ip || run > len - op) return -1;
      std::memcpy(dst + op, src + ip, static_cast<size_t>(run));
      ip += run;
      op += run;
      continue;
    }
    if ((tag & 3) == 1) {
      if (ip + 1 > n) return -1;
      run = 4 + ((tag >> 2) & 7);
      dist = (static_cast<int64_t>(tag >> 5) << 8) | src[ip++];
    } else {
      const int nb = (tag & 3) == 2 ? 2 : 4;
      if (ip + nb > n) return -1;
      run = (tag >> 2) + 1;
      for (int k = nb - 1; k >= 0; --k) dist = (dist << 8) | src[ip + k];
      ip += nb;
    }
    if (dist == 0 || dist > op || run > len - op) return -1;
    copy_match(dst, op, dist, run);
    op += run;
  }
  return op == len ? op : -1;
}

// liblzf: control bytes; below 32 a literal run of ctrl + 1 bytes, else a
// match of (ctrl >> 5) + 2 bytes (7: 9 + the next byte) at distance
// ((ctrl & 31) << 8 | the byte after) + 1. Returns the bytes written, or -1.
int64_t lzf_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t n_out) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    const uint32_t ctrl = src[ip++];
    if (ctrl < 32) {
      const int64_t run = ctrl + 1;
      if (ip + run > n || op + run > n_out) return -1;
      std::memcpy(dst + op, src + ip, static_cast<size_t>(run));
      ip += run;
      op += run;
      continue;
    }
    int64_t run = ctrl >> 5;
    if (run == 7) {
      if (ip >= n) return -1;
      run += src[ip++];
    }
    if (ip >= n) return -1;
    const int64_t dist = (static_cast<int64_t>(ctrl & 31) << 8 | src[ip++]) + 1;
    run += 2;
    if (dist > op || op + run > n_out) return -1;
    copy_match(dst, op, dist, run);
    op += run;
  }
  return op;
}

}  // extern "C"
