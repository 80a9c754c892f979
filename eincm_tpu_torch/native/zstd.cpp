// A Zstandard decoder written from RFC 8878 ("Zstandard Compression and the
// application/zstd Media Type"), section 3, less dictionaries: the frames of
// Blosc1's codec 4 and of HDF5 filter 32015 (hdf5plugin's Zstd), which
// utils/blosc.py and utils/h5_lite.py hand to `zstd_decompress`.
//
// Simple and table driven: one FSE decode table per stream (literal lengths,
// offsets, match lengths, the Huffman weights), one Huffman table of
// 1 << Max_Number_of_Bits entries, a bit reader that loads up to 8 bytes per
// read. Every read stays inside the source and every write inside the
// destination, and no match reaches before its frame's first byte: a
// malformed or truncated input returns a negative code, never reads or
// writes out of bounds.

#include <cstdint>
#include <cstring>
#include <memory>

namespace {

// the failure classes; native/blosc.py turns each into a message
constexpr int64_t kTruncated = -1;    // the input ends inside a frame
constexpr int64_t kCorrupt = -2;      // a field or a stream breaks the format
constexpr int64_t kOverflow = -3;     // the output does not fit in n_out bytes
constexpr int64_t kChecksum = -4;     // Content_Checksum differs
constexpr int64_t kDictionary = -5;   // a frame names a dictionary
constexpr int64_t kNotZstd = -6;      // neither a Zstandard nor a skippable frame
constexpr int64_t kContentSize = -7;  // the frame decoded to another size than its header's

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;  // low 4 bits free
constexpr int64_t kBlockSizeMax = 128 * 1024;
constexpr int kMaxHuffmanBits = 11;

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

inline uint64_t le64(const uint8_t* p) {
  uint64_t v = 0;
  for (int k = 7; k >= 0; --k) v = (v << 8) | p[k];
  return v;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---- XXH64 (seed 0): Content_Checksum is its low 32 bits ------------------

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull, kP2 = 0xC2B2AE3D27D4EB4Full,
                   kP3 = 0x165667B19E3779F9ull, kP4 = 0x85EBCA77C2B2AE63ull,
                   kP5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * kP2;
  return rotl64(acc, 31) * kP1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * kP1 + kP4;
}

uint64_t xxh64(const uint8_t* p, int64_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    for (; end - p >= 32; p += 32) {
      v1 = xxh_round(v1, le64(p));
      v2 = xxh_round(v2, le64(p + 8));
      v3 = xxh_round(v3, le64(p + 16));
      v4 = xxh_round(v4, le64(p + 24));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = kP5;
  }
  h += static_cast<uint64_t>(len);
  for (; end - p >= 8; p += 8) h = rotl64(h ^ xxh_round(0, le64(p)), 27) * kP1 + kP4;
  if (end - p >= 4) {
    h = rotl64(h ^ (le32(p) * kP1), 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl64(h ^ (*p * kP5), 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  return h ^ (h >> 32);
}

// ---- bit readers ------------------------------------------------------------

// bits [pos, pos + nb) of p[0 .. n), least significant bit of p[0] first;
// bits past the end read as 0 (nb <= 56)
inline uint64_t bits_at(const uint8_t* p, int64_t n, int64_t pos, int nb) {
  if (nb == 0) return 0;
  int64_t byte = pos >> 3;
  uint64_t v = 0;
  if (byte + 8 <= n) {
    std::memcpy(&v, p + byte, 8);  // little endian host (x86-64, aarch64)
  } else {
    for (int64_t k = n - 1; k >= byte; --k) v = (v << 8) | p[k];
  }
  return (v >> (pos & 7)) & ((uint64_t{1} << nb) - 1);
}

// A backward bit stream: read from the end, the highest set bit of the last
// byte marking where the bits start. `left` counts the bits not yet read and
// goes below 0 once a read passes the stream's start (those bits read as 0).
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t n = 0, left = 0;

  bool init(const uint8_t* src, int64_t len) {
    if (len <= 0 || src[len - 1] == 0) return false;
    p = src;
    n = len;
    left = 8 * (len - 1) + highbit32(src[len - 1]);
    return true;
  }
  uint64_t peek(int nb) const {  // nb <= 56
    int64_t lo = left - nb;
    if (lo >= 0) return bits_at(p, n, lo, nb);
    if (left <= 0) return 0;
    return bits_at(p, n, 0, static_cast<int>(left)) << (-lo);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    left -= nb;
    return v;
  }
};

// ---- FSE ----------------------------------------------------------------------

struct FseEntry {
  uint16_t base;  // the next state is base + the `bits` bits read
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  FseEntry e[512];  // 1 << 9, the largest accuracy log (literal and match lengths)
  int log = 0;
};

// Build the decode table of normalized counts norm[0 .. n_sym) (-1: "less
// than 1") summing to 1 << log (RFC 8878 4.1.1).
bool build_fse(const int16_t* norm, int n_sym, int log, FseTable& t) {
  const int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < n_sym; ++s) {
    if (norm[s] == -1) {
      t.e[high--].symbol = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n_sym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = static_cast<uint8_t>(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    uint32_t state = next[t.e[u].symbol]++;
    int nb = log - highbit32(state);
    t.e[u].bits = static_cast<uint8_t>(nb);
    t.e[u].base = static_cast<uint16_t>((state << nb) - size);
  }
  t.log = log;
  return true;
}

void rle_fse(uint8_t symbol, FseTable& t) {
  t.e[0] = {0, symbol, 0};
  t.log = 0;
}

// The FSE table description at p[0 .. n) (RFC 8878 4.1.1): accuracy log,
// then the normalized counts of symbols 0.., with repeat flags after a zero.
// Returns the bytes it takes, or a negative code.
int64_t read_fse(const uint8_t* p, int64_t n, int max_log, int max_symbol, FseTable& t) {
  if (n < 1) return kTruncated;
  const int log = (p[0] & 15) + 5;
  if (log > max_log) return kCorrupt;
  int16_t norm[256] = {0};
  int64_t bit = 4;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int n0 = symbol;
      while (true) {  // 2-bit flags: 3 means 3 more zeros and another flag
        int r = static_cast<int>(bits_at(p, n, bit, 2));
        bit += 2;
        n0 += r;
        if (r != 3) break;
        if (n0 > max_symbol) return kCorrupt;
      }
      if (n0 > max_symbol) return kCorrupt;
      while (symbol < n0) norm[symbol++] = 0;
    }
    const int max = (2 * threshold - 1) - remaining;
    const int v = static_cast<int>(bits_at(p, n, bit, nbits));
    int count;
    if ((v & (threshold - 1)) < max) {
      count = v & (threshold - 1);
      bit += nbits - 1;
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= max;
      bit += nbits;
    }
    --count;  // -1: probability "less than 1"
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = static_cast<int16_t>(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return kCorrupt;
  const int64_t bytes = (bit + 7) >> 3;
  if (bytes > n) return kTruncated;
  if (!build_fse(norm, symbol, log, t)) return kCorrupt;
  return bytes;
}

// ---- sequences' code tables (RFC 8878 3.1.1.3.2.1) ------------------------

constexpr uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,  12,  13,   14,   15,   16,   18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// the predefined distributions (RFC 8878 3.1.1.3.2.2)
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---- one frame's state ------------------------------------------------------

struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct Frame {
  FseTable ll, of, ml;  // the last tables used, for Repeat mode
  bool have_ll = false, have_of = false, have_ml = false;
  HufEntry huf[1 << kMaxHuffmanBits];  // the last Huffman table, for Treeless literals
  int huf_bits = 0;
  bool have_huf = false;
  uint64_t rep[3] = {1, 4, 8};
  int64_t block_max = 0;
};

struct Output {
  uint8_t* dst;
  int64_t cap, op, frame_start;
};

// The Huffman tree description at p[0 .. n) (RFC 8878 4.2.1): weights, direct
// (header >= 128) or FSE compressed, the last one implied. Fills f.huf and
// returns the bytes it takes, or a negative code.
int64_t read_huffman(const uint8_t* p, int64_t n, Frame& f) {
  if (n < 1) return kTruncated;
  const int header = p[0];
  uint8_t w[256];
  int n_w = 0;
  int64_t used;
  if (header >= 128) {
    n_w = header - 127;
    used = 1 + (n_w + 1) / 2;
    if (used > n) return kTruncated;
    for (int i = 0; i < n_w; ++i) w[i] = (i & 1) ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4;
  } else {
    used = 1 + header;
    if (used > n) return kTruncated;
    FseTable t;
    int64_t hdr = read_fse(p + 1, header, 6, 12, t);
    if (hdr < 0) return hdr;
    BackBits b;
    if (!b.init(p + 1 + hdr, header - hdr)) return kCorrupt;
    // two states over one table, taking turns; once a read passes the
    // stream's start, the other state gives the last weight. At most 255
    // weights are coded (the 256th is implied).
    uint32_t s[2] = {static_cast<uint32_t>(b.read(t.log)), 0};
    s[1] = static_cast<uint32_t>(b.read(t.log));
    for (int k = 0;; k ^= 1) {
      if (n_w >= 254) return kCorrupt;
      w[n_w++] = t.e[s[k]].symbol;
      s[k] = t.e[s[k]].base + static_cast<uint32_t>(b.read(t.e[s[k]].bits));
      if (b.left < 0) {
        w[n_w++] = t.e[s[k ^ 1]].symbol;
        break;
      }
    }
  }
  uint32_t total = 0;
  int rank[kMaxHuffmanBits + 2] = {0};
  for (int i = 0; i < n_w; ++i) {
    if (w[i] > kMaxHuffmanBits) return kCorrupt;
    ++rank[w[i]];
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) return kCorrupt;
  const int max_bits = highbit32(total) + 1;
  if (max_bits > kMaxHuffmanBits) return kCorrupt;
  const uint32_t rest = (1u << max_bits) - total;  // the last weight's share
  if (rest & (rest - 1)) return kCorrupt;
  const int last = highbit32(rest) + 1;
  w[n_w++] = static_cast<uint8_t>(last);
  ++rank[last];
  if (rank[1] < 2 || (rank[1] & 1)) return kCorrupt;
  // weight 1's symbols first, each taking one entry, then weight 2's (two
  // entries each), ...; within a weight, by symbol value
  uint32_t start[kMaxHuffmanBits + 2];
  uint32_t next = 0;
  for (int wt = 1; wt <= max_bits; ++wt) {
    start[wt] = next;
    next += static_cast<uint32_t>(rank[wt]) << (wt - 1);
  }
  for (int s = 0; s < n_w; ++s) {
    const int wt = w[s];
    if (wt == 0) continue;
    const HufEntry e{static_cast<uint8_t>(s), static_cast<uint8_t>(max_bits + 1 - wt)};
    const uint32_t len = 1u << (wt - 1);
    for (uint32_t u = start[wt]; u < start[wt] + len; ++u) f.huf[u] = e;
    start[wt] += len;
  }
  f.huf_bits = max_bits;
  f.have_huf = true;
  return used;
}

// `k` Huffman-coded streams (1 or 4) of count[j] literals each, decoded in
// turn so that their table walks overlap; each must end exactly at its
// stream's first bit.
bool huffman_streams(int k, const uint8_t* const* p, const int64_t* n, uint8_t* const* out,
                     const int64_t* count, const Frame& f) {
  BackBits b[4];
  int64_t common = count[0];
  for (int j = 0; j < k; ++j) {
    if (!b[j].init(p[j], n[j])) return false;
    if (count[j] < common) common = count[j];
  }
  for (int64_t i = 0; i < common; ++i) {
    for (int j = 0; j < k; ++j) {
      const HufEntry e = f.huf[b[j].peek(f.huf_bits)];
      out[j][i] = e.symbol;
      b[j].left -= e.bits;
    }
  }
  for (int j = 0; j < k; ++j) {
    for (int64_t i = common; i < count[j]; ++i) {
      const HufEntry e = f.huf[b[j].peek(f.huf_bits)];
      out[j][i] = e.symbol;
      b[j].left -= e.bits;
    }
    if (b[j].left != 0) return false;
  }
  return true;
}

// The literals section at p[0 .. n) (RFC 8878 3.1.1.3.1). Sets *lit to the
// literals (in src for Raw, else in buf) and *n_lit; returns the bytes it
// takes, or a negative code.
int64_t read_literals(const uint8_t* p, int64_t n, Frame& f, uint8_t* buf, const uint8_t** lit,
                      int64_t* n_lit) {
  if (n < 1) return kTruncated;
  const int type = p[0] & 3, size_format = (p[0] >> 2) & 3;
  if (type < 2) {  // Raw, RLE
    int64_t hs, size;
    if ((size_format & 1) == 0) {
      hs = 1;
      size = p[0] >> 3;
    } else if (size_format == 1) {
      hs = 2;
      if (n < hs) return kTruncated;
      size = (p[0] >> 4) | (p[1] << 4);
    } else {
      hs = 3;
      if (n < hs) return kTruncated;
      size = (p[0] >> 4) | (p[1] << 4) | (static_cast<int64_t>(p[2]) << 12);
    }
    if (size > f.block_max) return kCorrupt;
    *n_lit = size;
    if (type == 0) {
      if (hs + size > n) return kTruncated;
      *lit = p + hs;
      return hs + size;
    }
    if (hs + 1 > n) return kTruncated;
    std::memset(buf, p[hs], static_cast<size_t>(size));
    *lit = buf;
    return hs + 1;
  }
  // Compressed, Treeless: 1 stream (size format 0) or 4
  const int hs = size_format < 2 ? 3 : size_format + 2;
  if (n < hs) return kTruncated;
  uint64_t h = 0;
  for (int k = hs - 1; k >= 0; --k) h = (h << 8) | p[k];
  const int field = size_format < 2 ? 10 : (size_format == 2 ? 14 : 18);
  const int64_t size = static_cast<int64_t>((h >> 4) & ((1u << field) - 1));
  const int64_t csize = static_cast<int64_t>((h >> (4 + field)) & ((1u << field) - 1));
  if (size > f.block_max) return kCorrupt;
  if (hs + csize > n) return kTruncated;
  const uint8_t* q = p + hs;
  int64_t qn = csize;
  if (type == 2) {
    int64_t used = read_huffman(q, qn, f);
    if (used < 0) return used;
    q += used;
    qn -= used;
  } else if (!f.have_huf) {
    return kCorrupt;  // Treeless with no earlier table in the frame
  }
  if (size_format == 0) {
    const int64_t count[1] = {size};
    uint8_t* const out[1] = {buf};
    if (!huffman_streams(1, &q, &qn, out, count, f)) return kCorrupt;
  } else {
    // a jump table of the first three streams' sizes; each of them holds
    // ceil(size / 4) literals, the fourth the rest
    if (qn < 6) return kCorrupt;
    const int64_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8), s3 = q[4] | (q[5] << 8);
    const int64_t s4 = qn - 6 - s1 - s2 - s3;
    const int64_t seg = (size + 3) / 4;
    if (s4 < 0 || 3 * seg > size) return kCorrupt;
    const uint8_t* const streams[4] = {q + 6, q + 6 + s1, q + 6 + s1 + s2, q + 6 + s1 + s2 + s3};
    const int64_t sizes[4] = {s1, s2, s3, s4};
    uint8_t* const out[4] = {buf, buf + seg, buf + 2 * seg, buf + 3 * seg};
    const int64_t count[4] = {seg, seg, seg, size - 3 * seg};
    if (!huffman_streams(4, streams, sizes, out, count, f)) return kCorrupt;
  }
  *lit = buf;
  *n_lit = size;
  return hs + csize;
}

// One of the three tables of a sequences section, by its 2-bit mode:
// Predefined, RLE, FSE_Compressed or Repeat. Returns the bytes it takes.
int64_t read_table(const uint8_t* p, int64_t n, int mode, int max_log, int max_symbol,
                   const int16_t* predefined, int n_predefined, int predefined_log,
                   FseTable& t, bool& have) {
  int64_t used = 0;
  if (mode == 0) {
    build_fse(predefined, n_predefined, predefined_log, t);
  } else if (mode == 1) {
    if (n < 1) return kTruncated;
    if (p[0] > max_symbol) return kCorrupt;
    rle_fse(p[0], t);
    used = 1;
  } else if (mode == 2) {
    used = read_fse(p, n, max_log, max_symbol, t);
    if (used < 0) return used;
  } else if (!have) {
    return kCorrupt;  // Repeat with no earlier table in the frame
  }
  have = true;
  return used;
}

inline int64_t copy_out(Output& o, const uint8_t* src, int64_t len) {
  if (len > o.cap - o.op) return kOverflow;
  std::memcpy(o.dst + o.op, src, static_cast<size_t>(len));
  o.op += len;
  return 0;
}

// A Compressed_Block's content p[0 .. n) (RFC 8878 3.1.1.3).
int64_t decode_block(const uint8_t* p, int64_t n, Frame& f, uint8_t* buf, Output& o) {
  const uint8_t* lit;
  int64_t n_lit;
  int64_t used = read_literals(p, n, f, buf, &lit, &n_lit);
  if (used < 0) return used;
  p += used;
  n -= used;
  const int64_t block_start = o.op;
  if (n < 1) return kTruncated;
  int64_t n_seq, pos;
  if (p[0] < 128) {
    n_seq = p[0];
    pos = 1;
  } else if (p[0] < 255) {
    if (n < 2) return kTruncated;
    n_seq = ((p[0] - 128) << 8) + p[1];
    pos = 2;
  } else {
    if (n < 3) return kTruncated;
    n_seq = p[1] + (p[2] << 8) + 0x7F00;
    pos = 3;
  }
  if (n_seq == 0) {
    if (pos != n) return kCorrupt;
    if (n_lit > f.block_max) return kCorrupt;
    return copy_out(o, lit, n_lit);
  }
  if (pos >= n) return kTruncated;
  const int modes = p[pos++];
  if (modes & 3) return kCorrupt;
  used = read_table(p + pos, n - pos, modes >> 6, 9, 35, kLLDefault, 36, 6, f.ll, f.have_ll);
  if (used < 0) return used;
  pos += used;
  used = read_table(p + pos, n - pos, (modes >> 4) & 3, 8, 31, kOFDefault, 29, 5, f.of, f.have_of);
  if (used < 0) return used;
  pos += used;
  used = read_table(p + pos, n - pos, (modes >> 2) & 3, 9, 52, kMLDefault, 53, 6, f.ml, f.have_ml);
  if (used < 0) return used;
  pos += used;

  BackBits b;
  if (!b.init(p + pos, n - pos)) return kCorrupt;
  uint32_t sll = static_cast<uint32_t>(b.read(f.ll.log));
  uint32_t sof = static_cast<uint32_t>(b.read(f.of.log));
  uint32_t sml = static_cast<uint32_t>(b.read(f.ml.log));
  int64_t lit_pos = 0;
  for (int64_t i = 0; i < n_seq; ++i) {
    const int of_code = f.of.e[sof].symbol, ll_code = f.ll.e[sll].symbol,
              ml_code = f.ml.e[sml].symbol;
    // offset, then match length, then literal length bits
    const uint64_t of_value = (uint64_t{1} << of_code) + b.read(of_code);
    const int64_t ml = kMLBase[ml_code] + static_cast<int64_t>(b.read(kMLBits[ml_code]));
    const int64_t ll = kLLBase[ll_code] + static_cast<int64_t>(b.read(kLLBits[ll_code]));
    // repeat offsets (RFC 8878 3.1.1.5); with no literals they shift by one
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = offset;
    } else {
      const uint64_t idx = of_value - 1 + (ll == 0);
      if (idx == 0) {
        offset = f.rep[0];
      } else if (idx == 1) {
        offset = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      } else {
        offset = idx == 3 ? f.rep[0] - 1 : f.rep[2];
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      }
    }
    if (i + 1 < n_seq) {  // literal length, then match length, then offset state
      sll = f.ll.e[sll].base + static_cast<uint32_t>(b.read(f.ll.e[sll].bits));
      sml = f.ml.e[sml].base + static_cast<uint32_t>(b.read(f.ml.e[sml].bits));
      sof = f.of.e[sof].base + static_cast<uint32_t>(b.read(f.of.e[sof].bits));
    }
    if (b.left < 0) return kCorrupt;
    if (ll > n_lit - lit_pos) return kCorrupt;
    int64_t r = copy_out(o, lit + lit_pos, ll);
    if (r < 0) return r;
    lit_pos += ll;
    if (offset == 0 || offset > static_cast<uint64_t>(o.op - o.frame_start)) return kCorrupt;
    if (ml > o.cap - o.op) return kOverflow;
    uint8_t* out = o.dst + o.op;
    const uint8_t* ref = out - offset;
    if (offset >= static_cast<uint64_t>(ml)) {
      std::memcpy(out, ref, static_cast<size_t>(ml));
    } else {
      for (int64_t k = 0; k < ml; ++k) out[k] = ref[k];  // a run
    }
    o.op += ml;
    if (o.op - block_start > f.block_max) return kCorrupt;
  }
  if (b.left != 0) return kCorrupt;
  int64_t r = copy_out(o, lit + lit_pos, n_lit - lit_pos);
  if (r < 0) return r;
  if (o.op - block_start > f.block_max) return kCorrupt;
  return 0;
}

// One Zstandard frame at src[0 .. n), magic included. Returns the bytes it
// takes, or a negative code.
int64_t decode_frame(const uint8_t* src, int64_t n, Output& o, std::unique_ptr<uint8_t[]>& buf) {
  if (n < 5) return kTruncated;
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, did_flag = fhd & 3;
  const bool single = fhd & 0x20, checksum = fhd & 0x04;
  if (fhd & 0x08) return kCorrupt;  // reserved bit
  const int did_size = did_flag == 3 ? 4 : did_flag;
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
  int64_t ip = 5;
  if (ip + (single ? 0 : 1) + did_size + fcs_size > n) return kTruncated;
  uint64_t window = 0;
  if (!single) {
    const int exponent = src[ip] >> 3, mantissa = src[ip] & 7;
    const uint64_t base = uint64_t{1} << (10 + exponent);
    window = base + (base / 8) * mantissa;
    ++ip;
  }
  uint64_t did = 0;
  for (int k = did_size - 1; k >= 0; --k) did = (did << 8) | src[ip + k];
  ip += did_size;
  if (did != 0) return kDictionary;
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  for (int k = fcs_size - 1; k >= 0; --k) fcs = (fcs << 8) | src[ip + k];
  if (fcs_size == 2) fcs += 256;
  ip += fcs_size;
  if (single) window = fcs;
  if (has_fcs && fcs > static_cast<uint64_t>(o.cap - o.op)) return kOverflow;

  auto f = std::make_unique<Frame>();  // tables and repeat offsets start anew
  f->block_max = static_cast<int64_t>(window < kBlockSizeMax ? window : kBlockSizeMax);
  o.frame_start = o.op;
  while (true) {
    if (ip + 3 > n) return kTruncated;
    const uint32_t bh = src[ip] | (src[ip + 1] << 8) | (src[ip + 2] << 16);
    ip += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const int64_t size = bh >> 3;
    if (type == 3 || size > f->block_max) return kCorrupt;
    if (type == 1) {  // RLE: one byte, `size` times
      if (ip + 1 > n) return kTruncated;
      if (size > o.cap - o.op) return kOverflow;
      std::memset(o.dst + o.op, src[ip], static_cast<size_t>(size));
      o.op += size;
      ip += 1;
    } else {
      if (ip + size > n) return kTruncated;
      int64_t r;
      if (type == 0) {
        r = copy_out(o, src + ip, size);
      } else {
        if (!buf) buf.reset(new uint8_t[kBlockSizeMax]);
        r = decode_block(src + ip, size, *f, buf.get(), o);
      }
      if (r < 0) return r;
      ip += size;
    }
    if (last) break;
  }
  if (has_fcs && static_cast<uint64_t>(o.op - o.frame_start) != fcs) return kContentSize;
  if (checksum) {
    if (ip + 4 > n) return kTruncated;
    const uint64_t h = xxh64(o.dst + o.frame_start, o.op - o.frame_start);
    if (static_cast<uint32_t>(h) != le32(src + ip)) return kChecksum;
    ip += 4;
  }
  return ip;
}

}  // namespace

extern "C" {

// Decode the Zstandard frames in src[0 .. n) (skippable frames skipped) into
// dst[0 .. n_out). Returns the bytes written, or a negative code: -1
// truncated input, -2 corrupt data, -3 output past n_out, -4 checksum
// mismatch, -5 a dictionary, -6 not a Zstandard frame, -7 a frame whose
// content differs in size from its Frame_Content_Size.
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t n_out) {
  if (n <= 0) return kTruncated;
  if (n_out < 0) return kOverflow;
  Output o{dst, n_out, 0, 0};
  std::unique_ptr<uint8_t[]> buf;  // the literals of one block
  int64_t ip = 0;
  while (ip < n) {
    if (n - ip < 4) return kTruncated;
    const uint32_t magic = le32(src + ip);
    if ((magic & 0xFFFFFFF0u) == kSkippableMagic) {
      if (n - ip < 8) return kTruncated;
      const int64_t size = le32(src + ip + 4);
      if (size > n - ip - 8) return kTruncated;
      ip += 8 + size;
      continue;
    }
    if (magic != kMagic) return kNotZstd;
    const int64_t used = decode_frame(src + ip, n - ip, o, buf);
    if (used < 0) return used;
    ip += used;
  }
  return o.op;
}

}  // extern "C"
