// A Zstandard decoder (RFC 8878), decode only, for the orbax checkpoints'
// zarr chunks and OCDBT nodes. Host C++17 with a plain C interface, bound
// with ctypes by neoplanner_tpu_torch/io/zstd.py.
//
// It reads concatenated and skippable frames; raw, RLE and compressed
// blocks; raw, RLE, Huffman (1 or 4 streams) and treeless literals; and
// sequences in predefined, RLE, FSE and repeat modes, with the Huffman and
// FSE tables and the three repeat offsets carried from block to block of a
// frame. A frame's content size, when present, and its xxh64 content
// checksum, when present, are verified. A frame that names a dictionary, a
// reserved bit that is set, or a stream that does not decode exactly is an
// error: zstd_decompress returns 1 with a message and no output.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Corrupt(msg); }

// How often each branch of the format was decoded since the last reset: a
// diagnostic that lets tests show which parts of the format their frames
// reach (not synchronized; one decoding thread at a time).
const char* const kBranches[] = {
    "raw_block",        "rle_block",          "compressed_block",
    "raw_literals",     "rle_literals",       "huffman_literals",
    "treeless_literals", "one_stream",        "four_streams",
    "direct_weights",   "fse_weights",        "predefined_table",
    "rle_table",        "fse_table",          "repeat_table",
    "skippable_frame",  "checksum",           "content_size",
    "single_segment",   "repeat_offset",      "repeat_offset_ll0",
    "match_into_earlier_block", "no_sequences", "less_than_one_count"};
constexpr int kNumBranches = sizeof(kBranches) / sizeof(kBranches[0]);
uint64_t g_counts[kNumBranches] = {0};
enum Branch {
  RAW_BLOCK, RLE_BLOCK, COMPRESSED_BLOCK, RAW_LITERALS, RLE_LITERALS,
  HUFFMAN_LITERALS, TREELESS_LITERALS, ONE_STREAM, FOUR_STREAMS,
  DIRECT_WEIGHTS, FSE_WEIGHTS, PREDEFINED_TABLE, RLE_TABLE, FSE_TABLE,
  REPEAT_TABLE, SKIPPABLE_FRAME, CHECKSUM, CONTENT_SIZE, SINGLE_SEGMENT,
  REPEAT_OFFSET, REPEAT_OFFSET_LL0, MATCH_INTO_EARLIER_BLOCK, NO_SEQUENCES,
  LESS_THAN_ONE_COUNT
};
inline void seen(Branch b) { ++g_counts[b]; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

uint64_t le64(const uint8_t* p) {
  return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32;
}

// ---- xxh64 (seed 0), the frame's content checksum ----------------------
constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bit readers --------------------------------------------------------
// Forward, least significant bit first: the FSE table descriptions.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed
  ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int nb) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int k = 0; k < 8 && byte + k < n; ++k) v |= uint64_t(p[byte + k]) << (8 * k);
    return uint32_t((v >> (pos & 7)) & ((uint64_t(1) << nb) - 1));
  }
  void skip(int nb) {
    pos += nb;
    if (pos > 8 * n) fail("an FSE table description runs past its block");
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward: the Huffman and FSE streams, read from the last byte down; the
// last byte's highest set bit marks the start. Bits below the stream's
// first byte read as zeros; `pos` then goes negative, which the callers
// treat as overrun.
struct BackwardBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;  // bits left
  BackwardBits(const uint8_t* p_, size_t n_) : p(p_), n(int64_t(n_)) {
    if (n == 0) fail("an empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("a bitstream without its end mark");
    pos = (n - 1) * 8 + highbit(last);
  }
  // bits [lo, lo + nb) of the stream, nb <= 32, zero below bit 0
  uint32_t bits_at(int64_t lo, int nb) const {
    if (nb == 0) return 0;
    if (lo < 0) {
      int keep = nb + int(lo);
      if (keep <= 0) return 0;
      return bits_at(0, keep) << (-lo);
    }
    int64_t byte = lo >> 3;
    uint64_t v;
    if (byte + 8 <= n) {
      std::memcpy(&v, p + byte, 8);
    } else {
      v = 0;
      for (int64_t k = 0; byte + k < n; ++k) v |= uint64_t(p[byte + k]) << (8 * k);
    }
    return uint32_t((v >> (lo & 7)) & ((uint64_t(1) << nb) - 1));
  }
  uint32_t peek(int nb) const { return bits_at(pos - nb, nb); }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

// ---- FSE ----------------------------------------------------------------
struct FseEntry {
  uint16_t symbol;
  uint8_t nb_bits;
  uint16_t baseline;
};

struct FseTable {
  int log = -1;  // -1: none yet
  std::vector<FseEntry> t;
};

void fse_build(FseTable& out, const int16_t* norm, int n_symbols, int log) {
  const int size = 1 << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(n_symbols);
  int high = size - 1;
  for (int s = 0; s < n_symbols; ++s) {
    if (norm[s] == -1) {
      out.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n_symbols; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("an FSE distribution that does not fill its table");
  for (int u = 0; u < size; ++u) {
    int s = out.t[u].symbol;
    uint32_t state = next[s]++;
    int nb = log - highbit(state);
    out.t[u].nb_bits = uint8_t(nb);
    out.t[u].baseline = uint16_t((state << nb) - size);
  }
}

void fse_rle(FseTable& out, int symbol) {
  out.log = 0;
  out.t.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

// Reads an FSE table description at p (at most n bytes); returns the bytes
// it takes.
size_t fse_read(FseTable& out, const uint8_t* p, size_t n, int max_log,
                int max_symbol) {
  if (n == 0) fail("a missing FSE table description");
  ForwardBits br(p, n);
  const int log = int(br.peek(4)) + 5;
  br.skip(4);
  if (log > max_log) fail("an FSE accuracy log above its maximum");
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  int s = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      for (;;) {
        int rep = int(br.peek(2));
        br.skip(2);
        s += rep;
        if (rep != 3) break;
      }
      if (s > max_symbol) fail("an FSE description with too many symbols");
    }
    if (s > max_symbol) fail("an FSE description with too many symbols");
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const int low = int(br.peek(nb - 1));
    if (low < max) {
      count = low;
      br.skip(nb - 1);
    } else {
      count = int(br.peek(nb));
      if (count >= threshold) count -= max;
      br.skip(nb);
    }
    count -= 1;  // -1: a probability below 1
    if (count < 0) seen(LESS_THAN_ONE_COUNT);
    remaining -= count < 0 ? -count : count;
    norm[s++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("an FSE distribution that does not sum to 1");
  fse_build(out, norm, s, log);
  return br.bytes();
}

// ---- Huffman ------------------------------------------------------------
struct HufEntry {
  uint8_t symbol;
  uint8_t nb_bits;
};

struct HufTable {
  int max_bits = 0;  // 0: none yet
  std::vector<HufEntry> t;
};

// Reads a Huffman tree description; returns the bytes it takes.
size_t huf_read(HufTable& out, const uint8_t* p, size_t n) {
  if (n == 0) fail("a missing Huffman tree description");
  uint8_t w[256] = {0};
  int n_w;
  size_t used;
  const int header = p[0];
  if (header >= 128) {  // direct: 4 bits a weight
    seen(DIRECT_WEIGHTS);
    n_w = header - 127;
    used = 1 + (size_t(n_w) + 1) / 2;
    if (used > n) fail("a Huffman tree description runs past its block");
    for (int i = 0; i < n_w; ++i) {
      uint8_t b = p[1 + i / 2];
      w[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {  // FSE-compressed, two interleaved states
    seen(FSE_WEIGHTS);
    used = 1 + size_t(header);
    if (header == 0 || used > n) fail("a bad FSE-compressed Huffman header");
    FseTable ft;
    size_t d = fse_read(ft, p + 1, header, 6, 255);
    if (d >= size_t(header)) fail("Huffman weights without a bitstream");
    BackwardBits br(p + 1 + d, header - d);
    uint32_t s1 = br.read(ft.log), s2 = br.read(ft.log);
    if (br.pos < 0) fail("a truncated Huffman weight stream");
    n_w = 0;
    // each state in turn; past the stream's start, the other state's
    // symbol is the last
    uint32_t* st[2] = {&s1, &s2};
    for (int k = 0;; k ^= 1) {
      if (n_w >= 255) fail("too many Huffman weights");
      const FseEntry& e = ft.t[*st[k]];
      w[n_w++] = uint8_t(e.symbol);
      *st[k] = e.baseline + br.read(e.nb_bits);
      if (br.pos < 0) {
        if (n_w >= 255) fail("too many Huffman weights");
        w[n_w++] = uint8_t(ft.t[*st[k ^ 1]].symbol);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < n_w; ++i) {
    if (w[i] > 11) fail("a Huffman weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights that are all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("a Huffman code longer than 11 bits");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights that leave no last weight");
  w[n_w] = uint8_t(highbit(rest) + 1);
  const int n_sym = n_w + 1;
  out.max_bits = max_bits;
  out.t.assign(size_t(1) << max_bits, HufEntry{0, 0});
  size_t pos = 0;
  for (int weight = 1; weight <= max_bits; ++weight) {
    for (int s = 0; s < n_sym; ++s) {
      if (w[s] != weight) continue;
      const size_t len = size_t(1) << (weight - 1);
      for (size_t k = 0; k < len; ++k)
        out.t[pos + k] = HufEntry{uint8_t(s), uint8_t(max_bits + 1 - weight)};
      pos += len;
    }
  }
  if (pos != out.t.size()) fail("Huffman weights that do not fill the code");
  return used;
}

// Decodes k (1 or 4) Huffman streams: stream j's n[j] bytes at p[j] into
// count[j] literals at out[j]. While every stream has four symbols (at
// most 44 bits) and a 56-bit load left, a round takes four symbols of each
// stream in turn, the streams' dependency chains apart; each stream then
// ends one symbol at a time and must be consumed exactly.
void huf_streams(const HufTable& h, int k, const uint8_t* const* p,
                 const size_t* n, uint8_t* const* out, const size_t* count) {
  const int mb = h.max_bits;
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  const HufEntry* const t = h.t.data();
  int64_t pos[4];
  size_t least = count[0];
  for (int j = 0; j < k; ++j) {
    pos[j] = BackwardBits(p[j], n[j]).pos;
    least = std::min(least, count[j]);
  }
  size_t i = 0;
  for (; i + 4 <= least; i += 4) {
    bool room = true;
    for (int j = 0; j < k; ++j) room &= pos[j] >= 56;
    if (!room) break;
    for (int j = 0; j < k; ++j) {
      const int64_t lo = pos[j] - 56;
      uint64_t v;
      std::memcpy(&v, p[j] + (lo >> 3), 8);
      v >>= (lo & 7);
      int avail = 56;
      uint32_t four = 0;  // one store a round: byte stores alias all
      for (int s = 0; s < 4; ++s) {
        const HufEntry e = t[(v >> (avail - mb)) & mask];
        four |= uint32_t(e.symbol) << (8 * s);
        avail -= e.nb_bits;
      }
      std::memcpy(out[j] + i, &four, 4);
      pos[j] -= 56 - avail;
    }
  }
  for (int j = 0; j < k; ++j) {
    BackwardBits br(p[j], n[j]);
    br.pos = pos[j];
    for (size_t m = i; m < count[j]; ++m) {
      const HufEntry& e = h.t[br.peek(mb)];
      out[j][m] = e.symbol;
      br.pos -= e.nb_bits;
    }
    if (br.pos != 0) fail("a Huffman stream not consumed exactly");
  }
}

// ---- the sequences' codes -----------------------------------------------
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,
    12, 13, 14, 15, 16, 18, 20,  22,  24,  28,  32,   40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,  17,  18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,  34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr size_t BLOCK_MAX = 1 << 17;

// ---- a frame's decoding state ---------------------------------------------
struct Output {
  std::vector<uint8_t> buf;
  size_t n = 0;
  size_t limit;  // the most bytes the caller accepts
  uint8_t* reserve(size_t k) {
    if (n + k > limit) fail("more output than the expected size");
    if (n + k > buf.size()) buf.resize(std::max(n + k, 2 * buf.size()));
    return buf.data() + n;
  }
};

struct Frame {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
  size_t start = 0;  // the frame's first output byte
};

// The literals section at p (n bytes of the block); fills f.lit, returns
// the bytes it takes.
size_t read_literals(Frame& f, const uint8_t* p, size_t n) {
  if (n == 0) fail("a compressed block without literals");
  const int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    size_t regen, hsize;
    if (fmt == 0 || fmt == 2) {
      regen = p[0] >> 3;
      hsize = 1;
    } else if (fmt == 1) {
      if (n < 2) fail("a truncated literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      hsize = 2;
    } else {
      if (n < 3) fail("a truncated literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      hsize = 3;
    }
    if (regen > BLOCK_MAX) fail("more literals than a block holds");
    f.lit.resize(regen);
    seen(type == 0 ? RAW_LITERALS : RLE_LITERALS);
    if (type == 0) {
      if (hsize + regen > n) fail("raw literals run past their block");
      std::memcpy(f.lit.data(), p + hsize, regen);
      return hsize + regen;
    }
    if (hsize + 1 > n) fail("RLE literals run past their block");
    std::memset(f.lit.data(), p[hsize], regen);
    return hsize + 1;
  }
  size_t regen, comp, hsize;
  const bool one = fmt == 0;
  if (fmt < 2) {
    if (n < 3) fail("a truncated literals header");
    uint32_t v = p[0] | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
    regen = (v >> 4) & 0x3ff;
    comp = (v >> 14) & 0x3ff;
    hsize = 3;
  } else if (fmt == 2) {
    if (n < 4) fail("a truncated literals header");
    uint32_t v = le32(p);
    regen = (v >> 4) & 0x3fff;
    comp = v >> 18;
    hsize = 4;
  } else {
    if (n < 5) fail("a truncated literals header");
    uint64_t v = le32(p) | uint64_t(p[4]) << 32;
    regen = (v >> 4) & 0x3ffff;
    comp = (v >> 22) & 0x3ffff;
    hsize = 5;
  }
  if (regen > BLOCK_MAX) fail("more literals than a block holds");
  if (hsize + comp > n) fail("compressed literals run past their block");
  const uint8_t* q = p + hsize;
  size_t qn = comp;
  seen(type == 2 ? HUFFMAN_LITERALS : TREELESS_LITERALS);
  seen(one ? ONE_STREAM : FOUR_STREAMS);
  if (type == 2) {
    size_t d = huf_read(f.huf, q, qn);
    q += d;
    qn -= d;
  } else if (f.huf.max_bits == 0) {
    fail("treeless literals before any Huffman table");
  }
  f.lit.resize(regen);
  if (one) {
    uint8_t* o = f.lit.data();
    huf_streams(f.huf, 1, &q, &qn, &o, &regen);
  } else {
    if (qn < 10) fail("a truncated four-stream jump table");
    size_t sz[4] = {q[0] | size_t(q[1]) << 8, q[2] | size_t(q[3]) << 8,
                    q[4] | size_t(q[5]) << 8, 0};
    if (6 + sz[0] + sz[1] + sz[2] > qn) fail("a jump table past its literals");
    sz[3] = qn - 6 - sz[0] - sz[1] - sz[2];
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("four literal streams of too few literals");
    const uint8_t* ps[4] = {q + 6, q + 6 + sz[0], q + 6 + sz[0] + sz[1],
                            q + 6 + sz[0] + sz[1] + sz[2]};
    uint8_t* os[4] = {f.lit.data(), f.lit.data() + seg,
                      f.lit.data() + 2 * seg, f.lit.data() + 3 * seg};
    const size_t cs[4] = {seg, seg, seg, regen - 3 * seg};
    huf_streams(f.huf, 4, ps, sz, os, cs);
  }
  return hsize + comp;
}

// One of the three tables of a sequences section, in mode `mode`; returns
// the bytes its description takes.
size_t read_table(FseTable& t, int mode, const uint8_t* p, size_t n,
                  const int16_t* def, int def_n, int def_log, int max_log,
                  int max_symbol) {
  seen(Branch(PREDEFINED_TABLE + mode));
  switch (mode) {
    case 0:
      fse_build(t, def, def_n, def_log);
      return 0;
    case 1:
      if (n < 1) fail("a missing RLE symbol");
      if (p[0] > max_symbol) fail("an RLE symbol out of range");
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read(t, p, n, max_log, max_symbol);
    default:
      if (t.log < 0) fail("a repeated table before any table");
      return 0;
  }
}

void compressed_block(Frame& f, Output& out, const uint8_t* p, size_t n) {
  size_t used = read_literals(f, p, n);
  p += used;
  n -= used;
  if (n == 0) fail("a compressed block without its sequences section");
  size_t n_seq;
  if (p[0] < 128) {
    n_seq = p[0];
    used = 1;
  } else if (p[0] < 255) {
    if (n < 2) fail("a truncated sequence count");
    n_seq = (size_t(p[0] - 128) << 8) + p[1];
    used = 2;
  } else {
    if (n < 3) fail("a truncated sequence count");
    n_seq = p[1] + (size_t(p[2]) << 8) + 0x7f00;
    used = 3;
  }
  p += used;
  n -= used;
  const uint8_t* lit = f.lit.data();
  size_t n_lit = f.lit.size(), li = 0;
  uint8_t* base = nullptr;
  if (n_seq == 0) {
    seen(NO_SEQUENCES);
    if (n != 0) fail("bytes after an empty sequences section");
    base = out.reserve(n_lit);
    std::memcpy(base, lit, n_lit);
    out.n += n_lit;
    return;
  }
  if (n < 1) fail("a missing symbol compression modes byte");
  const uint8_t modes = p[0];
  if (modes & 3) fail("a reserved bit set in the compression modes");
  p += 1;
  n -= 1;
  used = read_table(f.ll, modes >> 6, p, n, LL_DEFAULT, 36, 6, 9, 35);
  p += used;
  n -= used;
  used = read_table(f.of, (modes >> 4) & 3, p, n, OF_DEFAULT, 29, 5, 8, 31);
  p += used;
  n -= used;
  used = read_table(f.ml, (modes >> 2) & 3, p, n, ML_DEFAULT, 53, 6, 9, 52);
  p += used;
  n -= used;
  BackwardBits br(p, n);
  uint32_t s_ll = br.read(f.ll.log), s_of = br.read(f.of.log),
           s_ml = br.read(f.ml.log);
  const size_t block_start = out.n;
  for (size_t i = 0; i < n_seq; ++i) {
    const FseEntry& e_ll = f.ll.t[s_ll];
    const FseEntry& e_of = f.of.t[s_of];
    const FseEntry& e_ml = f.ml.t[s_ml];
    const int of_code = e_of.symbol, ml_code = e_ml.symbol,
              ll_code = e_ll.symbol;
    if (ll_code > 35 || ml_code > 52 || of_code > 31)
      fail("a sequence code out of range");
    uint32_t of_value = (1u << of_code) + br.read(of_code);
    uint32_t ml = ML_BASE[ml_code] + br.read(ML_BITS[ml_code]);
    uint32_t ll = LL_BASE[ll_code] + br.read(LL_BITS[ll_code]);
    uint32_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = offset;
    } else {
      seen(ll == 0 ? REPEAT_OFFSET_LL0 : REPEAT_OFFSET);
      int idx = int(of_value) - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = f.rep[0];
      } else {
        offset = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
        if (offset == 0) fail("a repeat offset of 0");
        if (idx >= 2) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      }
    }
    if (i + 1 < n_seq) {
      s_ll = e_ll.baseline + br.read(e_ll.nb_bits);
      s_ml = e_ml.baseline + br.read(e_ml.nb_bits);
      s_of = e_of.baseline + br.read(e_of.nb_bits);
    }
    if (br.pos < 0) fail("a sequence bitstream overrun");
    if (ll > n_lit - li) fail("a sequence past the block's literals");
    uint8_t* o = out.reserve(size_t(ll) + ml);
    std::memcpy(o, lit + li, ll);
    li += ll;
    o += ll;
    out.n += ll;
    if (offset > out.n - f.start) fail("a match before the frame's start");
    if (offset > out.n - block_start) seen(MATCH_INTO_EARLIER_BLOCK);
    const uint8_t* m = o - offset;
    if (offset >= ml) {
      std::memcpy(o, m, ml);
    } else {
      for (uint32_t k = 0; k < ml; ++k) o[k] = m[k];
    }
    out.n += ml;
  }
  if (br.pos != 0) fail("a sequence bitstream not consumed exactly");
  const size_t rest = n_lit - li;
  uint8_t* o = out.reserve(rest);
  std::memcpy(o, lit + li, rest);
  out.n += rest;
  if (out.n - block_start > BLOCK_MAX) fail("a block larger than 128 KiB");
}

// Decodes the frame at p (n bytes left); returns the bytes it takes.
size_t decode_frame(const uint8_t* p, size_t n, Output& out) {
  if (n < 4) fail("a truncated frame magic number");
  const uint32_t magic = le32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // a skippable frame
    if (n < 8) fail("a truncated skippable frame");
    const uint64_t size = le32(p + 4);
    if (size > n - 8) fail("a skippable frame past the input");
    seen(SKIPPABLE_FRAME);
    return 8 + size_t(size);
  }
  if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic number)");
  size_t i = 4;
  if (n < 5) fail("a truncated frame header");
  const uint8_t fhd = p[i++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            reserved = (fhd >> 3) & 1, checksum = (fhd >> 2) & 1,
            did_flag = fhd & 3;
  if (reserved) fail("the frame header's reserved bit is set");
  if (single) seen(SINGLE_SEGMENT);
  if (checksum) seen(CHECKSUM);
  if (fcs_flag || single) seen(CONTENT_SIZE);
  if (!single) {
    if (i >= n) fail("a truncated frame header");
    ++i;  // the window descriptor: the whole frame is kept in memory
  }
  const int did_size = did_flag == 3 ? 4 : did_flag;
  if (i + did_size > n) fail("a truncated frame header");
  uint32_t did = 0;
  for (int k = 0; k < did_size; ++k) did |= uint32_t(p[i + k]) << (8 * k);
  i += did_size;
  if (did != 0) fail("a frame that needs dictionary " + std::to_string(did));
  int fcs_size = fcs_flag == 0 ? single : (1 << fcs_flag);
  if (i + fcs_size > n) fail("a truncated frame header");
  bool has_size = fcs_size > 0;
  uint64_t content = 0;
  for (int k = 0; k < fcs_size; ++k) content |= uint64_t(p[i + k]) << (8 * k);
  if (fcs_size == 2) content += 256;
  i += fcs_size;
  if (has_size && content > out.limit - out.n)
    fail("a frame content size above the expected size");
  if (has_size && content < (uint64_t(1) << 32))
    out.buf.reserve(out.n + size_t(content));
  Frame f;
  f.start = out.n;
  for (;;) {
    if (i + 3 > n) fail("a truncated block header");
    const uint32_t bh = p[i] | uint32_t(p[i + 1]) << 8 | uint32_t(p[i + 2]) << 16;
    i += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail("a reserved block type");
    seen(Branch(RAW_BLOCK + type));
    if (size > BLOCK_MAX) fail("a block larger than 128 KiB");
    if (type == 1) {
      if (i + 1 > n) fail("a truncated RLE block");
      std::memset(out.reserve(size), p[i], size);
      out.n += size;
      i += 1;
    } else {
      if (i + size > n) fail("a block past the input");
      if (type == 0) {
        std::memcpy(out.reserve(size), p + i, size);
        out.n += size;
      } else {
        compressed_block(f, out, p + i, size);
      }
      i += size;
    }
    if (last) break;
  }
  const size_t produced = out.n - f.start;
  if (has_size && produced != content)
    fail("a frame of " + std::to_string(produced) +
         " bytes against its content size " + std::to_string(content));
  if (checksum) {
    if (i + 4 > n) fail("a truncated content checksum");
    const uint32_t want = le32(p + i);
    const uint32_t got =
        uint32_t(xxh64(out.buf.data() + f.start, produced) & 0xFFFFFFFFu);
    if (got != want) fail("a content checksum mismatch");
    i += 4;
  }
  return i;
}

}  // namespace

extern "C" {

// Decodes every frame of src[0, n). expect < 0: any size; else the output
// must be exactly expect bytes. On success returns 0 and a malloc'd buffer
// of *out_n bytes in *out (free it with zstd_free); on failure returns 1
// with a message in err.
int zstd_decompress(const uint8_t* src, size_t n, long long expect,
                    uint8_t** out, size_t* out_n, char* err, size_t err_cap) {
  *out = nullptr;
  *out_n = 0;
  try {
    if (n == 0) fail("no frame in an empty input");
    Output o;
    o.limit = expect < 0 ? SIZE_MAX : size_t(expect);
    if (expect > 0) o.buf.reserve(size_t(expect));
    size_t i = 0;
    while (i < n) i += decode_frame(src + i, n - i, o);
    if (expect >= 0 && o.n != size_t(expect))
      fail("decoded " + std::to_string(o.n) + " bytes, expected " +
           std::to_string(expect));
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(o.n ? o.n : 1));
    if (!buf) fail("out of memory");
    if (o.n) std::memcpy(buf, o.buf.data(), o.n);
    *out = buf;
    *out_n = o.n;
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, err_cap, "%s", e.what());
    return 1;
  }
}

void zstd_free(uint8_t* p) { std::free(p); }

int zstd_num_branches() { return kNumBranches; }

const char* zstd_branch_name(int i) {
  return i >= 0 && i < kNumBranches ? kBranches[i] : nullptr;
}

// Copies the branch counts into out[0, n) and, with reset, zeroes them.
void zstd_branch_counts(uint64_t* out, int n, int reset) {
  for (int i = 0; i < n && i < kNumBranches; ++i) out[i] = g_counts[i];
  if (reset) std::memset(g_counts, 0, sizeof(g_counts));
}
}
