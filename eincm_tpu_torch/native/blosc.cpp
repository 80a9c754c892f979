// The two Blosc1 codecs that need no package, decoded from their published
// formats (no external deps): blosclz (c-blosc's FastLZ-derived codec) and
// the LZ4 block format (which LZ4HC writes too). utils/blosc.py parses the
// chunk (header, block starts, split streams, shuffles) and calls these on
// each stream; its plain Python decoders are the reference they are tested
// against. Every read stays inside the source and every write inside the
// destination: a malformed stream returns -1, never reads or writes past.

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

}  // extern "C"
