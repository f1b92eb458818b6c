// Arithmetic-coded JPEG entropy codec (ITU-T T.81 Annexes D/F/G) of the
// PyTorch port: a copy of the JAX package's jpeg/native/arith.cpp. It is
// the only route of the port's arithmetic coding (jpeg/arith.py binds
// it through jpeg/native.py:get_arith); arith.py's pure-Python QM coder
// is its plain specification, which tests/test_torch_arith.py holds it
// to bit for bit on decode results and encoded streams.
//
// Role parity: the reference reaches arithmetic JPEG through
// libjpeg-turbo's jdarith (D_ARITH_CODING_SUPPORTED) behind
// lib/src/jpegdecoderhelper.cpp:422.
//
// Build (jpeg/native.py does this at first use):
//   g++ -O3 -std=c++17 -shared -fPIC arith.cpp -o arith.so

#include <cstdint>
#include <cstring>

namespace {

// ITU-T T.81 Table D.3: Qe value and probability estimation state
// machine, (Qe, NMPS, NLPS, Switch). Index 113 is the fixed
// equiprobable state used for AC sign decisions (F.1.4.3.1).
struct QeEntry { uint16_t qe; uint8_t nmps, nlps, sw; };
const QeEntry kQe[114] = {
    {0x5A1D, 1, 1, 1},   {0x2586, 2, 14, 0},  {0x1114, 3, 16, 0},
    {0x080B, 4, 18, 0},  {0x03D8, 5, 20, 0},  {0x01DA, 6, 23, 0},
    {0x00E5, 7, 25, 0},  {0x006F, 8, 28, 0},  {0x0036, 9, 30, 0},
    {0x001A, 10, 33, 0}, {0x000D, 11, 35, 0}, {0x0006, 12, 9, 0},
    {0x0003, 13, 10, 0}, {0x0001, 13, 12, 0}, {0x5A7F, 15, 15, 1},
    {0x3F25, 16, 36, 0}, {0x2CF2, 17, 38, 0}, {0x207C, 18, 39, 0},
    {0x17B9, 19, 40, 0}, {0x1182, 20, 42, 0}, {0x0CEF, 21, 43, 0},
    {0x09A1, 22, 45, 0}, {0x072F, 23, 46, 0}, {0x055C, 24, 48, 0},
    {0x0406, 25, 49, 0}, {0x0303, 26, 51, 0}, {0x0240, 27, 52, 0},
    {0x01B1, 28, 54, 0}, {0x0144, 29, 56, 0}, {0x00F5, 30, 57, 0},
    {0x00B7, 31, 59, 0}, {0x008A, 32, 60, 0}, {0x0068, 33, 62, 0},
    {0x004E, 34, 63, 0}, {0x003B, 35, 32, 0}, {0x002C, 9, 33, 0},
    {0x5AE1, 37, 37, 1}, {0x484C, 38, 64, 0}, {0x3A0D, 39, 65, 0},
    {0x2EF1, 40, 67, 0}, {0x261F, 41, 68, 0}, {0x1F33, 42, 69, 0},
    {0x19A8, 43, 70, 0}, {0x1518, 44, 72, 0}, {0x1177, 45, 73, 0},
    {0x0E74, 46, 74, 0}, {0x0BFB, 47, 75, 0}, {0x09F8, 48, 77, 0},
    {0x0861, 49, 78, 0}, {0x0706, 50, 79, 0}, {0x05CD, 51, 48, 0},
    {0x04DE, 52, 50, 0}, {0x040F, 53, 50, 0}, {0x0363, 54, 51, 0},
    {0x02D4, 55, 52, 0}, {0x025C, 56, 53, 0}, {0x01F8, 57, 54, 0},
    {0x01A4, 58, 55, 0}, {0x0160, 59, 56, 0}, {0x0125, 60, 57, 0},
    {0x00F6, 61, 58, 0}, {0x00CB, 62, 59, 0}, {0x00AB, 63, 61, 0},
    {0x008F, 32, 61, 0}, {0x5B12, 65, 65, 1}, {0x4D04, 66, 80, 0},
    {0x412C, 67, 81, 0}, {0x37D8, 68, 82, 0}, {0x2FE8, 69, 83, 0},
    {0x293C, 70, 84, 0}, {0x2379, 71, 86, 0}, {0x1EDF, 72, 87, 0},
    {0x1AA9, 73, 87, 0}, {0x174E, 74, 72, 0}, {0x1424, 75, 72, 0},
    {0x119C, 76, 74, 0}, {0x0F6B, 77, 74, 0}, {0x0D51, 78, 75, 0},
    {0x0BB6, 79, 77, 0}, {0x0A40, 48, 77, 0}, {0x5832, 81, 80, 1},
    {0x4D1C, 82, 88, 0}, {0x438E, 83, 89, 0}, {0x3BDD, 84, 90, 0},
    {0x34EE, 85, 91, 0}, {0x2EAE, 86, 92, 0}, {0x299A, 87, 93, 0},
    {0x2516, 71, 86, 0}, {0x5570, 89, 88, 1}, {0x4CA9, 90, 95, 0},
    {0x44D9, 91, 96, 0}, {0x3E22, 92, 97, 0}, {0x3824, 93, 99, 0},
    {0x32B4, 94, 99, 0}, {0x2E17, 86, 93, 0}, {0x56A8, 96, 95, 1},
    {0x4F46, 97, 101, 0}, {0x47E5, 98, 102, 0}, {0x41CF, 99, 103, 0},
    {0x3C3D, 100, 104, 0}, {0x375E, 93, 99, 0}, {0x5231, 102, 105, 0},
    {0x4C0F, 103, 106, 0}, {0x4639, 104, 107, 0}, {0x415E, 99, 103, 0},
    {0x5627, 106, 105, 1}, {0x50E7, 107, 108, 0}, {0x4B85, 103, 109, 0},
    {0x5597, 109, 110, 0}, {0x504F, 107, 111, 0}, {0x5A10, 111, 110, 1},
    {0x5522, 109, 112, 0}, {0x59EB, 111, 112, 1}, {0x5A1D, 113, 113, 0},
};

const int kFixedState = 113;
const int kDcBins = 64;
const int kAcBins = 256;

// Error codes (negated block index is used by the scan loops; these are
// the generic stream errors).
const long kErrStream = -1000000001;  // malformed arithmetic stream
const long kErrRestart = -1000000002; // restart marker missing/order

struct ArithError { };

// ---------------------------------------------------------------------------
// QM decoder (T.81 D.2), arith.py's Decoder. `c` holds the
// code window with `ct` fed-but-unconsumed low bits; the byte feed
// collapses FF00 stuffing and coasts on zeros once a marker is hit.
// ---------------------------------------------------------------------------

struct Decoder {
  const uint8_t* data;
  long pos;
  long end;
  int marker;   // -1 = none yet
  uint32_t a;
  uint32_t c;
  int ct;

  inline int byte_in() {
    if (marker >= 0) return 0;
    long p = pos;
    if (p >= end) { marker = 0xD9; return 0; }
    uint8_t b = data[p];
    ++p;
    if (b != 0xFF) { pos = p; return b; }
    while (p < end && data[p] == 0xFF) ++p;
    if (p < end && data[p] == 0x00) { pos = p + 1; return 0xFF; }
    marker = p < end ? data[p] : 0xD9;
    pos = p;  // left AT the marker code byte
    return 0;
  }

  inline void init(const uint8_t* d, long at, long e) {
    data = d;
    pos = at;
    end = e;
    marker = -1;
    a = 0x10000;
    uint32_t b0 = (uint32_t)byte_in();
    c = (b0 << 8) | (uint32_t)byte_in();
    ct = 0;
  }

  inline int decode(uint8_t* stats, int i) {
    uint8_t st = stats[i];
    int mps = st >> 7;
    const QeEntry& q = kQe[st & 0x7F];
    uint32_t na = a - q.qe;
    int d;
    if (c < (na << ct)) {
      if (na >= 0x8000) { a = na; return mps; }
      if (na < q.qe) {
        d = mps ^ 1;
        if (q.sw) mps ^= 1;
        stats[i] = (uint8_t)((mps << 7) | q.nlps);
      } else {
        d = mps;
        stats[i] = (uint8_t)((mps << 7) | q.nmps);
      }
    } else {
      c -= na << ct;
      if (na < q.qe) {
        d = mps;
        stats[i] = (uint8_t)((mps << 7) | q.nmps);
      } else {
        d = mps ^ 1;
        if (q.sw) mps ^= 1;
        stats[i] = (uint8_t)((mps << 7) | q.nlps);
      }
      na = q.qe;
    }
    while (na < 0x8000) {
      if (ct == 0) {
        c = (c << 8) | (uint32_t)byte_in();
        ct = 8;
      }
      na <<= 1;
      --ct;
    }
    a = na;
    return d;
  }
};

// ---------------------------------------------------------------------------
// QM encoder (T.81 D.1) — port of arith.py Encoder: carry over
// stacked FF bytes, 0x00 stuffing after emitted FFs.
// ---------------------------------------------------------------------------

struct Encoder {
  uint32_t a = 0x10000;
  uint32_t c = 0;
  int ct = 11;
  int buffer = -1;  // pending byte (carry target); -1 = none
  long sc = 0;      // stacked 0xFF bytes
  uint8_t* out;
  long cap;
  long pos = 0;
  bool overflow = false;

  inline void emit(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = b;
    if (b == 0xFF) {
      if (pos >= cap) { overflow = true; return; }
      out[pos++] = 0x00;  // stuffing (B.1.1.5)
    }
  }

  inline void byte_out() {
    uint32_t temp = c >> 19;
    if (temp > 0xFF) {
      if (buffer >= 0) emit((uint8_t)(buffer + 1));
      for (; sc > 0; --sc) emit(0x00);
      buffer = (int)(temp & 0xFF);
    } else if (temp == 0xFF) {
      ++sc;
    } else {
      if (buffer >= 0) emit((uint8_t)buffer);
      for (; sc > 0; --sc) emit(0xFF);
      buffer = (int)temp;
    }
    c &= 0x7FFFF;
    ct = 8;
  }

  inline void encode(uint8_t* stats, int i, int bit) {
    uint8_t st = stats[i];
    int mps = st >> 7;
    const QeEntry& q = kQe[st & 0x7F];
    uint32_t na = a - q.qe;
    if (bit == mps) {
      if (na >= 0x8000) { a = na; return; }
      if (na < q.qe) { c += na; na = q.qe; }
      stats[i] = (uint8_t)((mps << 7) | q.nmps);
    } else {
      if (na >= q.qe) { c += na; na = q.qe; }
      if (q.sw) mps ^= 1;
      stats[i] = (uint8_t)((mps << 7) | q.nlps);
    }
    do {
      na <<= 1;
      c <<= 1;
      if (--ct == 0) byte_out();
    } while (na < 0x8000);
    a = na;
  }

  inline void flush() {
    uint32_t temp = (a - 1 + c) & 0xFFFF0000u;
    c = temp < c ? temp + 0x8000 : temp;
    c <<= ct;
    if (c & 0xF8000000u) {
      if (buffer >= 0) emit((uint8_t)(buffer + 1));
      for (; sc > 0; --sc) emit(0x00);
    } else {
      if (buffer >= 0) emit((uint8_t)buffer);
      for (; sc > 0; --sc) emit(0xFF);
    }
    emit((uint8_t)((c >> 19) & 0xFF));
    emit((uint8_t)((c >> 11) & 0xFF));
  }

  inline void reset() {
    a = 0x10000;
    c = 0;
    ct = 11;
    buffer = -1;
    sc = 0;
  }
};

inline int16_t w16(int32_t v) {
  // Truncate like the C (JCOEF) cast in libjpeg; reachable only on
  // corrupt streams.
  return (int16_t)(((v + 0x8000) & 0xFFFF) - 0x8000);
}

// Decode one DC difference (F.2.4.1); ctx is the conditioning context
// base (0/4/8/12/16). Throws ArithError on overflow.
inline int32_t dc_decode(Decoder& dec, uint8_t* stats, int& ctx,
                         int low, int up) {
  if (dec.decode(stats, ctx) == 0) { ctx = 0; return 0; }
  int sign = dec.decode(stats, ctx + 1);
  int32_t m = dec.decode(stats, ctx + 2 + sign);
  int st;
  if (m) {
    st = 20;  // X1 (Table F.4)
    while (dec.decode(stats, st)) {
      m <<= 1;
      if (m == 0x8000) throw ArithError{};
      ++st;
    }
  } else {
    st = ctx + 2 + sign;
  }
  if (m < (1 << low) >> 1) ctx = 0;
  else if (m > (1 << up) >> 1) ctx = 12 + sign * 4;
  else ctx = 4 + sign * 4;
  int32_t v = m;
  st += 14;
  for (int32_t mm = m >> 1; mm; mm >>= 1)
    if (dec.decode(stats, st)) v |= mm;
  ++v;
  return sign ? -v : v;
}

inline void dc_encode(Encoder& enc, uint8_t* stats, int& ctx,
                      int low, int up, int32_t diff) {
  if (diff == 0) {
    enc.encode(stats, ctx, 0);
    ctx = 0;
    return;
  }
  enc.encode(stats, ctx, 1);
  int sign = diff < 0 ? 1 : 0;
  enc.encode(stats, ctx + 1, sign);
  int32_t sz = (sign ? -diff : diff) - 1;
  int32_t m;
  int st;
  if (sz) {
    enc.encode(stats, ctx + 2 + sign, 1);
    m = 1;
    st = 20;
    while (sz >= (m << 1)) {
      enc.encode(stats, st, 1);
      m <<= 1;
      if (m == 0x8000) throw ArithError{};
      ++st;
    }
    enc.encode(stats, st, 0);
  } else {
    enc.encode(stats, ctx + 2 + sign, 0);
    m = 0;
    st = ctx + 2 + sign;
  }
  if (m < (1 << low) >> 1) ctx = 0;
  else if (m > (1 << up) >> 1) ctx = 12 + sign * 4;
  else ctx = 4 + sign * 4;
  st += 14;
  for (int32_t mm = m >> 1; mm; mm >>= 1)
    enc.encode(stats, st, (sz & mm) ? 1 : 0);
}

// Decode AC coefficients k in [ss, se] (F.2.4.2; al != 0 is the
// progressive AC-first model, G.2.3).
inline void ac_decode_block(Decoder& dec, uint8_t* stats,
                            uint8_t* fixed, int kx, int16_t* block,
                            int ss, int se, int al) {
  int k = ss;
  while (k <= se) {
    if (dec.decode(stats, 3 * (k - 1))) return;  // SE: end of block
    while (dec.decode(stats, 3 * (k - 1) + 1) == 0) {
      ++k;
      if (k > se) throw ArithError{};
    }
    int sign = dec.decode(fixed, 0);
    int st = 3 * (k - 1) + 2;
    int32_t m = dec.decode(stats, st);
    if (m && dec.decode(stats, st)) {  // X2 shares X1's bin
      m = 2;
      st = k <= kx ? 189 : 217;
      while (dec.decode(stats, st)) {
        m <<= 1;
        if (m == 0x8000) throw ArithError{};
        ++st;
      }
    }
    int32_t v = m;
    st += 14;
    for (int32_t mm = m >> 1; mm; mm >>= 1)
      if (dec.decode(stats, st)) v |= mm;
    ++v;
    block[k] = w16((sign ? -v : v) << al);
    ++k;
  }
}

// Point transform (T.81 G.1.2.1): sign-magnitude shift.
inline int32_t pt(int32_t v, int al) {
  return v < 0 ? -((-v) >> al) : v >> al;
}

inline void ac_encode_block(Encoder& enc, uint8_t* stats,
                            uint8_t* fixed, int kx,
                            const int16_t* block, int ss, int se,
                            int al) {
  int k = ss;
  for (;;) {
    int nz = 0;
    for (int j = k; j <= se; ++j) {
      if (al ? pt(block[j], al) : block[j]) { nz = j; break; }
    }
    if (nz == 0) {
      if (k <= se) enc.encode(stats, 3 * (k - 1), 1);  // EOB
      return;
    }
    enc.encode(stats, 3 * (k - 1), 0);
    for (int j = k; j < nz; ++j)
      enc.encode(stats, 3 * (j - 1) + 1, 0);
    enc.encode(stats, 3 * (nz - 1) + 1, 1);
    int32_t v = al ? pt(block[nz], al) : (int32_t)block[nz];
    int sign = v < 0 ? 1 : 0;
    enc.encode(fixed, 0, sign);
    int32_t sz = (sign ? -v : v) - 1;
    int st = 3 * (nz - 1) + 2;
    int32_t m;
    if (sz == 0) {
      enc.encode(stats, st, 0);
      m = 0;
    } else if (sz == 1) {
      enc.encode(stats, st, 1);
      enc.encode(stats, st, 0);
      m = 1;
    } else {
      enc.encode(stats, st, 1);
      enc.encode(stats, st, 1);
      m = 2;
      st = nz <= kx ? 189 : 217;
      while (sz >= (m << 1)) {
        enc.encode(stats, st, 1);
        m <<= 1;
        if (m == 0x8000) throw ArithError{};
        ++st;
      }
      enc.encode(stats, st, 0);
    }
    st += 14;
    for (int32_t mm = m >> 1; mm; mm >>= 1)
      enc.encode(stats, st, (sz & mm) ? 1 : 0);
    k = nz + 1;
    if (k > se) return;
  }
}

// Find the next restart marker (D.2.8); returns the position after it
// and sets *idx, or returns -1 on error.
inline long resync(const Decoder& dec, int* idx) {
  if (dec.marker >= 0) {
    if (dec.marker >= 0xD0 && dec.marker <= 0xD7) {
      *idx = dec.marker & 7;
      return dec.pos + 1;
    }
    return -1;
  }
  const uint8_t* d = dec.data;
  for (long p = dec.pos; p + 1 < dec.end; ++p) {
    if (d[p] == 0xFF && d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7) {
      *idx = d[p + 1] & 7;
      return p + 2;
    }
  }
  return -1;
}

struct SeqState {
  uint8_t dc_stats[4][kDcBins];
  uint8_t ac_stats[4][kAcBins];
  uint8_t fixed[1];
  int32_t last_dc[4];
  int dc_ctx[4];

  void reset() {
    std::memset(dc_stats, 0, sizeof(dc_stats));
    std::memset(ac_stats, 0, sizeof(ac_stats));
    fixed[0] = kFixedState;
    std::memset(last_dc, 0, sizeof(last_dc));
    std::memset(dc_ctx, 0, sizeof(dc_ctx));
  }
};

}  // namespace

extern "C" {

// Sequential full scan (DC+AC). Conditioning is per table SLOT:
// dc_low/dc_up/ac_kx are uint8[4]; dc_sel/ac_sel map scan-component
// index -> slot. Returns 0, or a negative error.
long uhdr_arith_decode_seq(const uint8_t* data, long len, long nblocks,
                           const uint8_t* comp_ids, int ncomp,
                           const uint8_t* dc_sel, const uint8_t* ac_sel,
                           const uint8_t* dc_low, const uint8_t* dc_up,
                           const uint8_t* ac_kx, int restart,
                           int mcu_blocks, int16_t* blocks) {
  if (ncomp > 4) return kErrStream;
  SeqState s;
  s.reset();
  Decoder dec;
  dec.init(data, 0, len);
  long rst_idx = 0;
  long rst_blocks = (long)restart * mcu_blocks;
  try {
    for (long b = 0; b < nblocks; ++b) {
      if (restart && b && b % rst_blocks == 0) {
        int got;
        long pos = resync(dec, &got);
        if (pos < 0 || got != (int)(rst_idx & 7)) return kErrRestart;
        ++rst_idx;
        s.reset();
        dec.init(data, pos, len);
      }
      int si = comp_ids[b];
      if (si >= ncomp) return kErrStream;
      int ds = dc_sel[si] & 3, as = ac_sel[si] & 3;
      int32_t diff = dc_decode(dec, s.dc_stats[ds], s.dc_ctx[si],
                               dc_low[ds], dc_up[ds]);
      s.last_dc[si] += diff;
      int16_t* row = blocks + b * 64;
      row[0] = w16(s.last_dc[si]);
      ac_decode_block(dec, s.ac_stats[as], s.fixed, ac_kx[as], row,
                      1, 63, 0);
    }
  } catch (ArithError&) {
    return kErrStream;
  }
  return 0;
}

// Sequential encode; emits restart markers every `restart` MCUs.
// Returns bytes written, or -1 on overflow / error.
long uhdr_arith_encode_seq(const int16_t* blocks, long nblocks,
                           const uint8_t* comp_ids, int ncomp,
                           const uint8_t* dc_sel, const uint8_t* ac_sel,
                           const uint8_t* dc_low, const uint8_t* dc_up,
                           const uint8_t* ac_kx, int restart,
                           int mcu_blocks, uint8_t* out,
                           long out_capacity) {
  if (ncomp > 4) return -1;
  SeqState s;
  s.reset();
  Encoder enc;
  enc.out = out;
  enc.cap = out_capacity;
  long rst_idx = 0;
  long rst_blocks = (long)restart * mcu_blocks;
  try {
    for (long b = 0; b < nblocks; ++b) {
      if (restart && b && b % rst_blocks == 0) {
        enc.flush();
        if (enc.pos + 2 > enc.cap) return -1;
        enc.out[enc.pos++] = 0xFF;
        enc.out[enc.pos++] = (uint8_t)(0xD0 + (rst_idx & 7));
        ++rst_idx;
        s.reset();
        enc.reset();
      }
      int si = comp_ids[b];
      if (si >= ncomp) return -1;
      int ds = dc_sel[si] & 3, as = ac_sel[si] & 3;
      const int16_t* row = blocks + b * 64;
      int32_t diff = (int32_t)row[0] - s.last_dc[si];
      s.last_dc[si] = row[0];
      dc_encode(enc, s.dc_stats[ds], s.dc_ctx[si], dc_low[ds],
                dc_up[ds], diff);
      ac_encode_block(enc, s.ac_stats[as], s.fixed, ac_kx[as], row,
                      1, 63, 0);
      if (enc.overflow) return -1;
    }
    enc.flush();
  } catch (ArithError&) {
    return -1;
  }
  if (enc.overflow) return -1;
  return enc.pos;
}

// Progressive DC first scan (G.2.3), result scaled by 2^Al.
long uhdr_arith_prog_dc_first(const uint8_t* data, long len,
                              long nblocks, const uint8_t* comp_ids,
                              int ncomp, const uint8_t* dc_sel,
                              const uint8_t* dc_low,
                              const uint8_t* dc_up, int al,
                              int restart, int mcu_blocks,
                              int16_t* blocks) {
  if (ncomp > 4) return kErrStream;
  SeqState s;
  s.reset();
  Decoder dec;
  dec.init(data, 0, len);
  long rst_idx = 0;
  long rst_blocks = (long)restart * mcu_blocks;
  try {
    for (long b = 0; b < nblocks; ++b) {
      if (restart && b && b % rst_blocks == 0) {
        int got;
        long pos = resync(dec, &got);
        if (pos < 0 || got != (int)(rst_idx & 7)) return kErrRestart;
        ++rst_idx;
        s.reset();
        dec.init(data, pos, len);
      }
      int si = comp_ids[b];
      if (si >= ncomp) return kErrStream;
      int ds = dc_sel[si] & 3;
      int32_t diff = dc_decode(dec, s.dc_stats[ds], s.dc_ctx[si],
                               dc_low[ds], dc_up[ds]);
      s.last_dc[si] += diff;
      blocks[b * 64] = w16(s.last_dc[si] << al);
    }
  } catch (ArithError&) {
    return kErrStream;
  }
  return 0;
}

// Progressive DC refinement: one fixed-probability bit per block.
long uhdr_arith_prog_dc_refine(const uint8_t* data, long len,
                               long nblocks, int al, int restart,
                               int mcu_blocks, int16_t* blocks) {
  uint8_t fixed[1] = {kFixedState};
  Decoder dec;
  dec.init(data, 0, len);
  long rst_idx = 0;
  long rst_blocks = (long)restart * mcu_blocks;
  int32_t p1 = 1 << al;
  for (long b = 0; b < nblocks; ++b) {
    if (restart && b && b % rst_blocks == 0) {
      int got;
      long pos = resync(dec, &got);
      if (pos < 0 || got != (int)(rst_idx & 7)) return kErrRestart;
      ++rst_idx;
      fixed[0] = kFixedState;
      dec.init(data, pos, len);
    }
    if (dec.decode(fixed, 0))
      blocks[b * 64] = (int16_t)(blocks[b * 64] | p1);
  }
  return 0;
}

// Progressive AC first scan over one component's blocks; `restart`
// counts blocks here (single-component scan, MCU = one block).
long uhdr_arith_prog_ac_first(const uint8_t* data, long len,
                              long nblocks, int kx, int ss, int se,
                              int al, int restart, int16_t* blocks) {
  uint8_t ac_stats[kAcBins];
  uint8_t fixed[1];
  std::memset(ac_stats, 0, sizeof(ac_stats));
  fixed[0] = kFixedState;
  Decoder dec;
  dec.init(data, 0, len);
  long rst_idx = 0;
  try {
    for (long b = 0; b < nblocks; ++b) {
      if (restart && b && b % restart == 0) {
        int got;
        long pos = resync(dec, &got);
        if (pos < 0 || got != (int)(rst_idx & 7)) return kErrRestart;
        ++rst_idx;
        std::memset(ac_stats, 0, sizeof(ac_stats));
        fixed[0] = kFixedState;
        dec.init(data, pos, len);
      }
      ac_decode_block(dec, ac_stats, fixed, kx, blocks + b * 64,
                      ss, se, al);
    }
  } catch (ArithError&) {
    return kErrStream;
  }
  return 0;
}

// Progressive AC refinement (G.2.3 correction-bit model).
long uhdr_arith_prog_ac_refine(const uint8_t* data, long len,
                               long nblocks, int ss, int se, int al,
                               int restart, int16_t* blocks) {
  uint8_t ac_stats[kAcBins];
  uint8_t fixed[1];
  std::memset(ac_stats, 0, sizeof(ac_stats));
  fixed[0] = kFixedState;
  Decoder dec;
  dec.init(data, 0, len);
  long rst_idx = 0;
  int32_t p1 = 1 << al;
  int32_t m1 = -1 << al;
  for (long b = 0; b < nblocks; ++b) {
    if (restart && b && b % restart == 0) {
      int got;
      long pos = resync(dec, &got);
      if (pos < 0 || got != (int)(rst_idx & 7)) return kErrRestart;
      ++rst_idx;
      std::memset(ac_stats, 0, sizeof(ac_stats));
      fixed[0] = kFixedState;
      dec.init(data, pos, len);
    }
    int16_t* block = blocks + b * 64;
    int kex = 0;
    for (int j = se; j >= ss; --j) {
      if (block[j]) { kex = j; break; }
    }
    int k = ss;
    while (k <= se) {
      int st = 3 * (k - 1);
      if (k > kex && dec.decode(ac_stats, st)) break;  // EOB
      for (;;) {
        int32_t coef = block[k];
        if (coef) {
          if (dec.decode(ac_stats, st + 2))
            block[k] = (int16_t)(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (dec.decode(ac_stats, st + 1)) {
          block[k] = (int16_t)(dec.decode(fixed, 0) ? m1 : p1);
          break;
        }
        st += 3;
        ++k;
        if (k > se) return kErrStream;
      }
      ++k;
    }
  }
  return 0;
}

}  // extern "C"
