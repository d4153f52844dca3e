// vcf_tpu native entropy runtime.
//
// Host-side sequential bit-level loops that have no efficient
// accelerator mapping: canonical Huffman encode/decode, an adaptive range coder
// with order-N byte contexts (capability parity with the reference's
// CBAAC, src/CBAAC.py), and a context-based adaptive Huffman coder
// that rebuilds its code from context counts before every symbol
// (parity with src/CBAHC.py:184-201 semantics).
//
// Exposed as a C ABI consumed through ctypes (vcf_tpu/native/__init__.py).
// All functions return bytes written / symbols read, or -1 on error.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <queue>

namespace {

// ---------------------------------------------------------------------------
// Bit I/O (MSB-first, matching the Python fallback in entropy/huffman.py)
// ---------------------------------------------------------------------------

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t byte_pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}

  inline void put(uint64_t code, int len) {
    acc = (acc << len) | code;
    nbits += len;
    while (nbits >= 8) {
      if (byte_pos >= cap) { overflow = true; return; }
      out[byte_pos++] = (uint8_t)(acc >> (nbits - 8));
      nbits -= 8;
    }
  }

  int64_t finish() {
    if (nbits > 0) {
      if (byte_pos >= cap) return -1;
      out[byte_pos++] = (uint8_t)(acc << (8 - nbits));
      nbits = 0;
    }
    return overflow ? -1 : byte_pos;
  }
};

struct BitReader {
  const uint8_t* in;
  int64_t nbytes;
  int64_t byte_pos = 0;
  uint64_t acc = 0;
  int nbits = 0;

  BitReader(const uint8_t* i, int64_t n) : in(i), nbytes(n) {}

  inline void fill(int need) {
    while (nbits < need) {
      uint64_t b = byte_pos < nbytes ? in[byte_pos++] : 0;  // zero guard tail
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }
  inline uint32_t peek(int len) {
    fill(len);
    return (uint32_t)((acc >> (nbits - len)) & ((1ull << len) - 1));
  }
  inline void consume(int len) { nbits -= len; }
  inline uint32_t get(int len) {
    uint32_t v = peek(len);
    consume(len);
    return v;
  }
};

// ---------------------------------------------------------------------------
// Canonical Huffman: codes from lengths (must match
// entropy/huffman.py::canonical_codes — shorter first, ties by symbol).
// ---------------------------------------------------------------------------

void build_canonical(const uint8_t* lengths, int n_values,
                     std::vector<uint64_t>& codes) {
  codes.assign(n_values, 0);
  std::vector<int> syms;
  syms.reserve(64);
  for (int s = 0; s < n_values; ++s)
    if (lengths[s]) syms.push_back(s);
  std::stable_sort(syms.begin(), syms.end(), [&](int a, int b) {
    return lengths[a] != lengths[b] ? lengths[a] < lengths[b] : a < b;
  });
  uint64_t code = 0;
  int prev_len = syms.empty() ? 0 : lengths[syms[0]];
  for (int s : syms) {
    code <<= (lengths[s] - prev_len);
    codes[s] = code++;
    prev_len = lengths[s];
  }
}

// Canonical decode state: symbols in canonical order + per-length ranges.
struct CanonicalDecoder {
  std::vector<int> syms;                // canonical order
  int max_len = 0;
  uint64_t first_code[64];
  int64_t first_idx[64];                // index into syms of first code of len l
  int64_t count_at[64];

  void build(const uint8_t* lengths, int n_values) {
    syms.clear();
    max_len = 0;
    for (int s = 0; s < n_values; ++s) {
      if (lengths[s]) {
        syms.push_back(s);
        max_len = std::max(max_len, (int)lengths[s]);
      }
    }
    std::stable_sort(syms.begin(), syms.end(), [&](int a, int b) {
      return lengths[a] != lengths[b] ? lengths[a] < lengths[b] : a < b;
    });
    int64_t idx = 0;
    uint64_t code = 0;
    for (int l = 1; l <= max_len; ++l) {
      code <<= 1;
      first_code[l] = code;
      first_idx[l] = idx;
      int64_t cnt = 0;
      while (idx + cnt < (int64_t)syms.size() && lengths[syms[idx + cnt]] == l)
        ++cnt;
      count_at[l] = cnt;
      idx += cnt;
      code += cnt;
    }
  }

  // bit-serial canonical walk (used when no fast table applies)
  inline int decode(BitReader& br) const {
    uint64_t code = 0;
    for (int l = 1; l <= max_len; ++l) {
      code = (code << 1) | br.get(1);
      if (code >= first_code[l] &&
          (int64_t)(code - first_code[l]) < count_at[l]) {
        return syms[first_idx[l] + (int64_t)(code - first_code[l])];
      }
    }
    return -1;
  }
};

}  // namespace

extern "C" {

// symbols are uint16 (uint8 inputs are widened on the Python side)
int64_t vcf_huf_encode(const uint16_t* syms, int64_t n, const uint8_t* lengths,
                       int n_values, uint8_t* out, int64_t cap) {
  std::vector<uint64_t> codes;
  build_canonical(lengths, n_values, codes);
  BitWriter bw(out, cap);
  for (int64_t i = 0; i < n; ++i) {
    uint16_t s = syms[i];
    if (s >= n_values || lengths[s] == 0) return -1;
    bw.put(codes[s], lengths[s]);
    if (bw.overflow) return -1;
  }
  return bw.finish();
}

int64_t vcf_huf_decode(const uint8_t* in, int64_t in_bytes, int64_t n_syms,
                       const uint8_t* lengths, int n_values, uint16_t* out) {
  int max_len = 0;
  for (int s = 0; s < n_values; ++s) max_len = std::max(max_len, (int)lengths[s]);
  if (max_len == 0) return n_syms == 0 ? 0 : -1;

  BitReader br(in, in_bytes);
  if (max_len <= 14) {
    // single-level table decode
    std::vector<uint64_t> codes;
    build_canonical(lengths, n_values, codes);
    std::vector<uint16_t> tsym(1u << max_len);
    std::vector<uint8_t> tlen(1u << max_len, 0);
    for (int s = 0; s < n_values; ++s) {
      if (!lengths[s]) continue;
      uint32_t prefix = (uint32_t)(codes[s] << (max_len - lengths[s]));
      uint32_t span = 1u << (max_len - lengths[s]);
      for (uint32_t j = 0; j < span; ++j) {
        tsym[prefix + j] = (uint16_t)s;
        tlen[prefix + j] = lengths[s];
      }
    }
    for (int64_t i = 0; i < n_syms; ++i) {
      uint32_t w = br.peek(max_len);
      if (!tlen[w]) return -1;
      out[i] = tsym[w];
      br.consume(tlen[w]);
    }
  } else {
    CanonicalDecoder cd;
    cd.build(lengths, n_values);
    for (int64_t i = 0; i < n_syms; ++i) {
      int s = cd.decode(br);
      if (s < 0) return -1;
      out[i] = (uint16_t)s;
    }
  }
  return n_syms;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Adaptive range coder with order-N byte contexts (CBAAC capability,
// src/CBAAC.py: AdaptiveModel rescaled at total>=16384, dict of
// per-context models).  Classic carry-less 32-bit range coder.
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t RC_TOP = 1u << 24;
constexpr uint32_t RC_BOT = 1u << 16;
constexpr uint32_t MAX_TOTAL = 16384;

struct Model {
  uint16_t freq[256];
  uint32_t total;
  Model() {
    for (int i = 0; i < 256; ++i) freq[i] = 1;
    total = 256;
  }
  inline void cum(int sym, uint32_t& lo, uint32_t& hi) const {
    uint32_t c = 0;
    for (int i = 0; i < sym; ++i) c += freq[i];
    lo = c;
    hi = c + freq[sym];
  }
  inline int find(uint32_t scaled, uint32_t& lo, uint32_t& hi) const {
    uint32_t c = 0;
    int s = 0;
    while (c + freq[s] <= scaled) c += freq[s++];
    lo = c;
    hi = c + freq[s];
    return s;
  }
  // Reference update law (src/CBAAC.py:34-47): +1 increment; the
  // rescale fires when the total BEFORE the increment had reached
  // max_freq (the reference checks the stale self.total), and halves
  // as (f >> 1) + 1.
  inline void update(int sym) {
    const uint32_t prev_total = total;
    freq[sym] += 1;
    total += 1;
    if (prev_total >= MAX_TOTAL) {
      total = 0;
      for (int i = 0; i < 256; ++i) {
        freq[i] = (uint16_t)((freq[i] >> 1) + 1);
        total += freq[i];
      }
    }
  }
};

template <typename M>
struct ContextTable {
  std::vector<M*> slots;
  std::vector<M> small;

  explicit ContextTable(int order) {
    // 9 bits per context slot: the PAD symbol (256) is representable,
    // so initial-window contexts never collide with real byte contexts
    // (src/CBAHC.py:123-153).
    size_t n = (size_t)1 << (9 * order);
    if (n <= 512) {
      small.resize(n);
      slots.resize(n);
      for (size_t i = 0; i < n; ++i) slots[i] = &small[i];
    } else {
      slots.assign(n, nullptr);
    }
  }
  ~ContextTable() {
    if (small.empty())
      for (M* m : slots) delete m;
  }
  inline M& get(uint32_t ctx) {
    M*& m = slots[ctx];
    if (!m) m = new M();
    return *m;
  }
};

inline uint32_t ctx_mask(int order) {
  return order ? (((uint32_t)1 << (9 * order)) - 1) : 0;
}

// Initial context: every slot holds PAD = 256 (src/CBAHC.py:123-153).
inline uint32_t ctx_init(int order) {
  uint32_t c = 0;
  for (int i = 0; i < order; ++i) c = (c << 9) | 256u;
  return c;
}

struct RangeEncoder {
  uint8_t* out;
  int64_t cap, pos = 0;
  uint32_t low = 0, range = 0xFFFFFFFFu;
  bool overflow = false;

  RangeEncoder(uint8_t* o, int64_t c) : out(o), cap(c) {}

  inline void put_byte() {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = (uint8_t)(low >> 24);
    low <<= 8;
    range <<= 8;
  }
  inline void encode(uint32_t cum_lo, uint32_t cum_hi, uint32_t total) {
    range /= total;
    low += cum_lo * range;
    range *= (cum_hi - cum_lo);
    while ((low ^ (low + range)) < RC_TOP ||
           (range < RC_BOT && ((range = (0u - low) & (RC_BOT - 1)), true))) {
      put_byte();
      if (overflow) return;
    }
  }
  int64_t finish() {
    for (int i = 0; i < 4; ++i) {
      if (pos >= cap) return -1;
      out[pos++] = (uint8_t)(low >> 24);
      low <<= 8;
    }
    return overflow ? -1 : pos;
  }
};

struct RangeDecoder {
  const uint8_t* in;
  int64_t nbytes, pos = 0;
  uint32_t low = 0, range = 0xFFFFFFFFu, code = 0;

  RangeDecoder(const uint8_t* i, int64_t n) : in(i), nbytes(n) {
    for (int j = 0; j < 4; ++j) code = (code << 8) | next();
  }
  inline uint8_t next() { return pos < nbytes ? in[pos++] : 0; }

  inline uint32_t decode_freq(uint32_t total) {
    range /= total;
    return (code - low) / range;
  }
  inline void decode_update(uint32_t cum_lo, uint32_t cum_hi) {
    low += cum_lo * range;
    range *= (cum_hi - cum_lo);
    while ((low ^ (low + range)) < RC_TOP ||
           (range < RC_BOT && ((range = (0u - low) & (RC_BOT - 1)), true))) {
      code = (code << 8) | next();
      low <<= 8;
      range <<= 8;
    }
  }
};

}  // namespace

extern "C" {

int64_t vcf_rc_encode(const uint8_t* syms, int64_t n, int order, uint8_t* out,
                      int64_t cap) {
  if (order < 0 || order > 2) return -1;
  ContextTable<Model> ctxs(order);
  RangeEncoder enc(out, cap);
  uint32_t ctx = ctx_init(order), mask = ctx_mask(order);
  for (int64_t i = 0; i < n; ++i) {
    Model& m = ctxs.get(ctx);
    uint32_t lo, hi;
    m.cum(syms[i], lo, hi);
    enc.encode(lo, hi, m.total);
    if (enc.overflow) return -1;
    m.update(syms[i]);
    if (order) ctx = ((ctx << 9) | syms[i]) & mask;
  }
  return enc.finish();
}

int64_t vcf_rc_decode(const uint8_t* in, int64_t n_bytes, int64_t n_syms,
                      int order, uint8_t* out) {
  if (order < 0 || order > 2) return -1;
  ContextTable<Model> ctxs(order);
  RangeDecoder dec(in, n_bytes);
  uint32_t ctx = ctx_init(order), mask = ctx_mask(order);
  for (int64_t i = 0; i < n_syms; ++i) {
    Model& m = ctxs.get(ctx);
    uint32_t scaled = dec.decode_freq(m.total);
    uint32_t lo, hi;
    int s = m.find(scaled, lo, hi);
    dec.decode_update(lo, hi);
    m.update(s);
    out[i] = (uint8_t)s;
    if (order) ctx = ((ctx << 9) | s) & mask;
  }
  return n_syms;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Context-based adaptive Huffman (CBAHC capability, src/CBAHC.py):
// order-N byte context; Laplace-smoothed counts; the Huffman code is
// rebuilt from the live context counts before EVERY symbol with
// deterministic (freq, uid) tie-breaking (src/CBAHC.py:44-70,184-201).
// Encoder and decoder derive identical code tables so only code bits
// hit the stream.
// ---------------------------------------------------------------------------

namespace {

struct CountModel {
  uint32_t counts[256];
  CountModel() {
    for (int i = 0; i < 256; ++i) counts[i] = 1;
  }
};

// Huffman code lengths over 256 symbols; ties by (freq, uid) with leaf
// uid = symbol value and internal uids in creation order.
void huffman_lengths_256(const uint32_t* counts, uint8_t* lengths) {
  struct N { uint64_t f; int uid; int parent; };
  static thread_local std::vector<N> nodes;
  nodes.clear();
  nodes.reserve(512);
  for (int s = 0; s < 256; ++s) nodes.push_back({counts[s], s, -1});
  auto cmp = [](const N* a, const N* b) {
    return a->f != b->f ? a->f > b->f : a->uid > b->uid;
  };
  // index-heap over stable storage (reserve prevents reallocation)
  std::priority_queue<N*, std::vector<N*>, decltype(cmp)> heap(cmp);
  for (int i = 0; i < 256; ++i) heap.push(&nodes[i]);
  int uid = 256;
  while (heap.size() > 1) {
    N* a = heap.top(); heap.pop();
    N* b = heap.top(); heap.pop();
    nodes.push_back({a->f + b->f, uid++, -1});
    N* p = &nodes.back();
    a->parent = (int)(p - nodes.data());
    b->parent = (int)(p - nodes.data());
    heap.push(p);
  }
  for (int s = 0; s < 256; ++s) {
    int d = 0, n = s;
    while (nodes[n].parent >= 0) { n = nodes[n].parent; ++d; }
    lengths[s] = (uint8_t)d;
  }
}

}  // namespace

extern "C" {

int64_t vcf_cbahc_encode(const uint8_t* syms, int64_t n, int order,
                         uint8_t* out, int64_t cap) {
  if (order < 0 || order > 2) return -1;
  ContextTable<CountModel> ctxs(order);
  BitWriter bw(out, cap);
  uint32_t ctx = ctx_init(order), mask = ctx_mask(order);
  uint8_t lengths[256];
  std::vector<uint64_t> codes;
  for (int64_t i = 0; i < n; ++i) {
    CountModel& m = ctxs.get(ctx);
    huffman_lengths_256(m.counts, lengths);
    build_canonical(lengths, 256, codes);
    int s = syms[i];
    bw.put(codes[s], lengths[s]);
    if (bw.overflow) return -1;
    m.counts[s] += 1;
    if (order) ctx = ((ctx << 9) | s) & mask;
  }
  return bw.finish();
}

int64_t vcf_cbahc_decode(const uint8_t* in, int64_t n_bytes, int64_t n_syms,
                         int order, uint8_t* out) {
  if (order < 0 || order > 2) return -1;
  ContextTable<CountModel> ctxs(order);
  BitReader br(in, n_bytes);
  uint32_t ctx = ctx_init(order), mask = ctx_mask(order);
  uint8_t lengths[256];
  CanonicalDecoder cd;
  for (int64_t i = 0; i < n_syms; ++i) {
    CountModel& m = ctxs.get(ctx);
    huffman_lengths_256(m.counts, lengths);
    cd.build(lengths, 256);
    int s = cd.decode(br);
    if (s < 0) return -1;
    out[i] = (uint8_t)s;
    m.counts[s] += 1;
    if (order) ctx = ((ctx << 9) | s) & mask;
  }
  return n_syms;
}


// ---------------------------------------------------------------------------
// PNG scanline unfiltering (entropy/png.py decode hot loop): each byte
// predicts from RECONSTRUCTED neighbors, so decode is inherently
// sequential per scanline -- the right home is this native runtime
// (reference role: the libpng/zlib C inside iio.imread, src/PNG.py:37-44).
// data: h * (stride + 1) filtered bytes (leading filter-type byte per
// row); out: h * stride reconstructed bytes.  Returns h or -1.
// ---------------------------------------------------------------------------

int64_t vcf_png_unfilter(const uint8_t* data, int64_t h, int64_t stride,
                         int bpp, uint8_t* out) {
  std::vector<uint8_t> zero((size_t)stride, 0);
  const uint8_t* prev = zero.data();
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = data + y * (stride + 1);
    int ft = row[0];
    const uint8_t* cur = row + 1;
    uint8_t* rec = out + y * stride;
    switch (ft) {
      case 0:
        std::memcpy(rec, cur, (size_t)stride);
        break;
      case 1:  // Sub
        for (int64_t x = 0; x < stride; ++x)
          rec[x] = (uint8_t)(cur[x] + (x >= bpp ? rec[x - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t x = 0; x < stride; ++x)
          rec[x] = (uint8_t)(cur[x] + prev[x]);
        break;
      case 3:  // Average (prefix split hoists the x >= bpp test)
        for (int64_t x = 0; x < bpp && x < stride; ++x)
          rec[x] = (uint8_t)(cur[x] + (prev[x] >> 1));
        for (int64_t x = bpp; x < stride; ++x)
          rec[x] = (uint8_t)(cur[x] + ((rec[x - bpp] + prev[x]) >> 1));
        break;
      case 4: {  // Paeth: prefix split + branchless predictor.  The
        // serial chain is pixel-to-pixel only — within a pixel the
        // bpp channels are independent — so the specialized constant-
        // width loops keep the previous pixel in registers and let the
        // compiler SLP-vectorize the channel lanes (libpng's SIMD
        // structure, r5: generic loop ran ~140 MB/s on this host).
        for (int64_t x = 0; x < bpp && x < stride; ++x)
          rec[x] = (uint8_t)(cur[x] + prev[x]);  // a=c=0 -> pred=b
        auto paeth = [](int a, int b, int c) {
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        };
        if (bpp == 3 && stride % 3 == 0) {
          int a0 = rec[0], a1 = rec[1], a2 = rec[2];
          for (int64_t x = 3; x < stride; x += 3) {
            int b0 = prev[x], b1 = prev[x + 1], b2 = prev[x + 2];
            int c0 = prev[x - 3], c1 = prev[x - 2], c2 = prev[x - 1];
            a0 = (uint8_t)(cur[x] + paeth(a0, b0, c0));
            a1 = (uint8_t)(cur[x + 1] + paeth(a1, b1, c1));
            a2 = (uint8_t)(cur[x + 2] + paeth(a2, b2, c2));
            rec[x] = (uint8_t)a0;
            rec[x + 1] = (uint8_t)a1;
            rec[x + 2] = (uint8_t)a2;
          }
        } else if (bpp == 4 && stride % 4 == 0) {
          int a0 = rec[0], a1 = rec[1], a2 = rec[2], a3 = rec[3];
          for (int64_t x = 4; x < stride; x += 4) {
            a0 = (uint8_t)(cur[x] + paeth(a0, prev[x], prev[x - 4]));
            a1 = (uint8_t)(cur[x + 1] + paeth(a1, prev[x + 1], prev[x - 3]));
            a2 = (uint8_t)(cur[x + 2] + paeth(a2, prev[x + 2], prev[x - 2]));
            a3 = (uint8_t)(cur[x + 3] + paeth(a3, prev[x + 3], prev[x - 1]));
            rec[x] = (uint8_t)a0;
            rec[x + 1] = (uint8_t)a1;
            rec[x + 2] = (uint8_t)a2;
            rec[x + 3] = (uint8_t)a3;
          }
        } else {
          for (int64_t x = bpp; x < stride; ++x)
            rec[x] = (uint8_t)(cur[x] + paeth(rec[x - bpp], prev[x],
                                              prev[x - bpp]));
        }
        break;
      }
      default:
        return -1;
    }
    prev = rec;
  }
  return h;
}

// ---------------------------------------------------------------------------
// PNG scanline filtering (entropy/png.py encode hot loop): adaptive
// per-row choice among filters 0-4 by minimum sum of absolute signed
// residuals (the standard libpng heuristic).  Encode predicts from the
// RAW previous row, so rows are independent; one pass computes all five
// costs, a second writes the winner.  Byte-identical to the Python
// _filter_rows (argmin is first-wins on ties).
// raw: h * stride bytes; out: h * (stride + 1).  Returns h.
// ---------------------------------------------------------------------------

int64_t vcf_png_filter(const uint8_t* raw, int64_t h, int64_t stride,
                       int bpp, uint8_t* out) {
  std::vector<uint8_t> zero((size_t)stride, 0);
  const uint8_t* prev = zero.data();
  auto abs8 = [](uint8_t v) -> uint64_t {
    int s = (int8_t)v;
    return (uint64_t)(s < 0 ? -s : s);
  };
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* cur = raw + y * stride;
    uint64_t cost[5] = {0, 0, 0, 0, 0};
    for (int64_t x = 0; x < stride; ++x) {
      int r = cur[x];
      int a = x >= bpp ? cur[x - bpp] : 0;
      int b = prev[x];
      int c = x >= bpp ? prev[x - bpp] : 0;
      int p = a + b - c;
      int pa = p > a ? p - a : a - p;
      int pb = p > b ? p - b : b - p;
      int pc = p > c ? p - c : c - p;
      int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      cost[0] += abs8((uint8_t)r);
      cost[1] += abs8((uint8_t)(r - a));
      cost[2] += abs8((uint8_t)(r - b));
      cost[3] += abs8((uint8_t)(r - ((a + b) >> 1)));
      cost[4] += abs8((uint8_t)(r - pred));
    }
    int ft = 0;
    for (int i = 1; i < 5; ++i)
      if (cost[i] < cost[ft]) ft = i;
    uint8_t* dst = out + y * (stride + 1);
    dst[0] = (uint8_t)ft;
    uint8_t* o = dst + 1;
    switch (ft) {
      case 0:
        std::memcpy(o, cur, (size_t)stride);
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          o[x] = (uint8_t)(cur[x] - (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x)
          o[x] = (uint8_t)(cur[x] - prev[x]);
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          o[x] = (uint8_t)(cur[x] - ((a + prev[x]) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = prev[x];
          int c = x >= bpp ? prev[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[x] = (uint8_t)(cur[x] - pred);
        }
        break;
    }
    prev = cur;
  }
  return h;
}

int vcf_native_version() { return 3; }

}  // extern "C"

// ---------------------------------------------------------------------------
// High-throughput uint8 Huffman path: multi-threaded histogram and
// chunked encode/decode.  The payload is self-framing:
//   [u32 n_chunks][u64 chunk_syms][u64 byte_len x n_chunks][chunk streams]
// Each chunk is an independent byte-aligned canonical-Huffman stream, so
// encode and decode both parallelize across cores and, later, across
// tile streams (SURVEY §7.3 "many independent per-tile streams").
// ---------------------------------------------------------------------------

#include <thread>
#include <atomic>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? (int)n : 2;
}

void hist_range(const uint8_t* p, int64_t n, int64_t* out) {
  int64_t c[4][256] = {};
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    ++c[0][p[i]];
    ++c[1][p[i + 1]];
    ++c[2][p[i + 2]];
    ++c[3][p[i + 3]];
  }
  for (; i < n; ++i) ++c[0][p[i]];
  for (int s = 0; s < 256; ++s)
    out[s] = c[0][s] + c[1][s] + c[2][s] + c[3][s];
}

// Encode one chunk; returns bytes written or -1.
int64_t encode_chunk(const uint8_t* syms, int64_t n,
                     const uint64_t* codes, const uint8_t* lengths,
                     uint8_t* out, int64_t cap) {
  // 64-bit accumulator, flush 4 bytes whenever >= 32 bits pending.
  uint64_t acc = 0;
  int nbits = 0;
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    int s = syms[i];
    acc = (acc << lengths[s]) | codes[s];
    nbits += lengths[s];
    if (nbits >= 32) {
      if (pos + 4 > cap) return -1;
      uint32_t w = (uint32_t)(acc >> (nbits - 32));
      out[pos++] = (uint8_t)(w >> 24);
      out[pos++] = (uint8_t)(w >> 16);
      out[pos++] = (uint8_t)(w >> 8);
      out[pos++] = (uint8_t)w;
      nbits -= 32;
    }
  }
  while (nbits > 0) {
    if (pos >= cap) return -1;
    int take = nbits >= 8 ? 8 : nbits;
    uint8_t b = (uint8_t)((acc >> (nbits - take)) << (8 - take));
    out[pos++] = b;
    nbits -= take;
  }
  return pos;
}

// Table-driven decode of one chunk (max_len <= 14 guaranteed by the
// Python side's length limiter).
void decode_chunk(const uint8_t* in, int64_t in_bytes, int64_t n_syms,
                  const uint16_t* tsym, const uint8_t* tlen, int max_len,
                  uint8_t* out, bool* ok) {
  BitReader br(in, in_bytes);
  for (int64_t i = 0; i < n_syms; ++i) {
    uint32_t w = br.peek(max_len);
    if (!tlen[w]) { *ok = false; return; }
    out[i] = (uint8_t)tsym[w];
    br.consume(tlen[w]);
  }
  *ok = true;
}

}  // namespace

extern "C" {

void vcf_hist8(const uint8_t* syms, int64_t n, int64_t* out) {
  int nt = std::min(hw_threads(), 8);
  if (n < (1 << 20)) nt = 1;
  std::vector<std::thread> threads;
  std::vector<std::vector<int64_t>> parts(nt, std::vector<int64_t>(256, 0));
  int64_t step = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * step, hi = std::min(n, lo + step);
    if (lo >= hi) break;
    threads.emplace_back(hist_range, syms + lo, hi - lo, parts[t].data());
  }
  for (auto& th : threads) th.join();
  for (int s = 0; s < 256; ++s) {
    int64_t acc = 0;
    for (auto& p : parts) acc += p[s];
    out[s] = acc;
  }
}

// Chunked parallel encode.  chunk_syms == 0 -> pick automatically.
int64_t vcf_huf_encode8(const uint8_t* syms, int64_t n, const uint8_t* lengths,
                        uint8_t* out, int64_t cap, int64_t chunk_syms) {
  std::vector<uint64_t> codes;
  build_canonical(lengths, 256, codes);
  int max_len = 0;
  for (int s = 0; s < 256; ++s) max_len = std::max(max_len, (int)lengths[s]);
  if (max_len == 0) return -1;
  if (chunk_syms <= 0) chunk_syms = 8 << 20;
  int64_t n_chunks = n ? (n + chunk_syms - 1) / chunk_syms : 0;
  int64_t header = 4 + 8 + 8 * n_chunks;
  if (header > cap) return -1;

  // worst-case bytes per chunk
  int64_t worst = chunk_syms * ((max_len + 7) / 8 + 1) + 8;
  std::vector<int64_t> sizes(n_chunks, 0);
  std::vector<std::vector<uint8_t>> bufs(n_chunks);

  int nt = std::min<int64_t>(std::min(hw_threads(), 8), std::max<int64_t>(n_chunks, 1));
  std::vector<std::thread> threads;
  std::atomic_bool fail{false};
  auto work = [&](int tid) {
    for (int64_t c = tid; c < n_chunks; c += nt) {
      int64_t lo = c * chunk_syms, hi = std::min(n, lo + chunk_syms);
      bufs[c].resize((size_t)std::min<int64_t>(worst, (hi - lo) * ((max_len + 7) / 8 + 1) + 8));
      int64_t sz = encode_chunk(syms + lo, hi - lo, codes.data(), lengths,
                                bufs[c].data(), (int64_t)bufs[c].size());
      if (sz < 0) { fail = true; return; }
      sizes[c] = sz;
    }
  };
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  if (fail) return -1;

  int64_t total = header;
  for (int64_t c = 0; c < n_chunks; ++c) total += sizes[c];
  if (total > cap) return -1;
  // header
  uint8_t* p = out;
  auto put32 = [&](uint32_t v) { memcpy(p, &v, 4); p += 4; };
  auto put64 = [&](uint64_t v) { memcpy(p, &v, 8); p += 8; };
  put32((uint32_t)n_chunks);
  put64((uint64_t)chunk_syms);
  for (int64_t c = 0; c < n_chunks; ++c) put64((uint64_t)sizes[c]);
  for (int64_t c = 0; c < n_chunks; ++c) {
    memcpy(p, bufs[c].data(), (size_t)sizes[c]);
    p += sizes[c];
  }
  return total;
}

int64_t vcf_huf_decode8(const uint8_t* in, int64_t in_bytes, int64_t n_syms,
                        const uint8_t* lengths, uint8_t* out) {
  int max_len = 0;
  for (int s = 0; s < 256; ++s) max_len = std::max(max_len, (int)lengths[s]);
  if (max_len == 0 || max_len > 14) return -1;
  if (in_bytes < 12) return -1;
  uint32_t n_chunks;
  uint64_t chunk_syms;
  memcpy(&n_chunks, in, 4);
  memcpy(&chunk_syms, in + 4, 8);
  int64_t header = 4 + 8 + 8 * (int64_t)n_chunks;
  if (in_bytes < header) return -1;
  std::vector<int64_t> sizes(n_chunks), offsets(n_chunks);
  int64_t off = header;
  for (uint32_t c = 0; c < n_chunks; ++c) {
    uint64_t sz;
    memcpy(&sz, in + 12 + 8 * c, 8);
    sizes[c] = (int64_t)sz;
    offsets[c] = off;
    off += sz;
  }
  if (off > in_bytes) return -1;

  // shared decode table
  std::vector<uint64_t> codes;
  build_canonical(lengths, 256, codes);
  std::vector<uint16_t> tsym(1u << max_len);
  std::vector<uint8_t> tlen(1u << max_len, 0);
  for (int s = 0; s < 256; ++s) {
    if (!lengths[s]) continue;
    uint32_t prefix = (uint32_t)(codes[s] << (max_len - lengths[s]));
    uint32_t span = 1u << (max_len - lengths[s]);
    for (uint32_t j = 0; j < span; ++j) {
      tsym[prefix + j] = (uint16_t)s;
      tlen[prefix + j] = lengths[s];
    }
  }

  int nt = std::min<int64_t>(std::min(hw_threads(), 8), std::max<uint32_t>(n_chunks, 1));
  std::vector<std::thread> threads;
  std::vector<uint8_t> oks(n_chunks, 0);
  auto work = [&](int tid) {
    for (int64_t c = tid; c < (int64_t)n_chunks; c += nt) {
      int64_t lo = c * (int64_t)chunk_syms;
      int64_t hi = std::min(n_syms, lo + (int64_t)chunk_syms);
      bool ok = false;
      decode_chunk(in + offsets[c], sizes[c], hi - lo, tsym.data(),
                   tlen.data(), max_len, out + lo, &ok);
      oks[c] = ok;
    }
  };
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  for (uint32_t c = 0; c < n_chunks; ++c)
    if (!oks[c]) return -1;
  return n_syms;
}

}  // extern "C"
