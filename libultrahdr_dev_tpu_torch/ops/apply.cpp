// Host-side gain-map application over the decode intermediates: the
// port's copy of libultrahdr_dev_tpu/jpeg/native/apply.cpp, unchanged
// below this header (built alone by jpeg/native.py, with the JAX
// package's compiler flags, so its output is bitwise the JAX one's).
//
// The serving loop's decode ships the integer (Y, U|V, gain map)
// composite (ops/gainmap.py planes_composite, kernel B18) to the host
// and reconstructs the RGBA frame here (ops/gainmap.py apply_gainmap,
// use_luts=False semantics). Float math mirrors the device kernel
// op-for-op in f32; transcendentals use ~1e-7-accurate polynomial
// log2/exp2, so outputs agree with the device kernel B6 to <= 1 F16
// ULP / <= 1 10-bit code (tests/test_torch_hostapply.py).
//
// The hot loops are branchless elementwise passes over per-row float
// buffers (L1-resident) so the compiler vectorizes them; the F16
// conversion rides F16C/AVX-512 directly.
//
// Reference roles: applyGainMap + applyRecMap worker loop (the
// reference's lib/src/ultrahdr.cpp:360-515), gainmapmath.cpp
// applyGain/sampleMap/ShepardsIDW (:543-720).
//
// The caller checks the composite's size against (h, w, gh, gw) before
// the call (parallel/link.py apply_planes_host): this function reads
// rows [0, h + ceil(h/2) + gh) of `stride` bytes each.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__F16C__) || defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

inline float bitsf(uint32_t b) {
  float f;
  std::memcpy(&f, &b, 4);
  return f;
}

inline uint32_t fbits(float f) {
  uint32_t b;
  std::memcpy(&b, &f, 4);
  return b;
}

// Branchless Cephes-grade log2 (x > 0 assumed; abs err ~1e-7).
inline float fast_log2f(float x) {
  const uint32_t b = fbits(x);
  int e = (int)((b >> 23) & 0xFF) - 127;
  float m = bitsf((b & 0x007FFFFFu) | 0x3F800000u);  // [1,2)
  const bool big = m > 1.41421356f;
  m = big ? m * 0.5f : m;
  e += big ? 1 : 0;
  const float z = m - 1.0f;
  const float z2 = z * z;
  float p = 7.0376836292e-2f;
  p = p * z - 1.1514610310e-1f;
  p = p * z + 1.1676998740e-1f;
  p = p * z - 1.2420140846e-1f;
  p = p * z + 1.4249322787e-1f;
  p = p * z - 1.6668057665e-1f;
  p = p * z + 2.0000714765e-1f;
  p = p * z - 2.4999993993e-1f;
  p = p * z + 3.3333331174e-1f;
  const float ln1z = z - 0.5f * z2 + z2 * z * p;
  return (float)e + ln1z * 1.44269504088896341f;
}

// Branchless exp2 (rel err ~2e-8), input clamped to [-126, 127].
inline float fast_exp2f(float x) {
  x = std::min(std::max(x, -126.0f), 127.0f);
  const float fi = std::floor(x);
  const float f = x - fi;  // [0,1)
  float p = 1.535336188319500e-4f;
  p = p * f + 1.339887440266574e-3f;
  p = p * f + 9.618437357674640e-3f;
  p = p * f + 5.550332471162809e-2f;
  p = p * f + 2.402264791363012e-1f;
  p = p * f + 6.931472028550421e-1f;
  p = p * f + 1.0f;
  return p * bitsf((uint32_t)(((int32_t)fi + 127) << 23));
}

inline float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

#if defined(__AVX512F__)
// Vector log2/exp2: the same polynomials as the scalar helpers, lane
// for lane (FMA contraction matches -ffp-contract=fast scalar code),
// so vector body and scalar tail produce identical results.
inline __m512 v_log2(__m512 x) {  // lanes > 0
  const __m512i b = _mm512_castps_si512(x);
  __m512i e = _mm512_sub_epi32(
      _mm512_and_si512(_mm512_srli_epi32(b, 23),
                       _mm512_set1_epi32(0xFF)),
      _mm512_set1_epi32(127));
  __m512 m = _mm512_castsi512_ps(_mm512_or_si512(
      _mm512_and_si512(b, _mm512_set1_epi32(0x007FFFFF)),
      _mm512_set1_epi32(0x3F800000)));
  const __mmask16 big =
      _mm512_cmp_ps_mask(m, _mm512_set1_ps(1.41421356f), _CMP_GT_OQ);
  m = _mm512_mask_mul_ps(m, big, m, _mm512_set1_ps(0.5f));
  e = _mm512_mask_add_epi32(e, big, e, _mm512_set1_epi32(1));
  const __m512 z = _mm512_sub_ps(m, _mm512_set1_ps(1.0f));
  const __m512 z2 = _mm512_mul_ps(z, z);
  __m512 p = _mm512_set1_ps(7.0376836292e-2f);
  p = _mm512_fmadd_ps(p, z, _mm512_set1_ps(-1.1514610310e-1f));
  p = _mm512_fmadd_ps(p, z, _mm512_set1_ps(1.1676998740e-1f));
  p = _mm512_fmadd_ps(p, z, _mm512_set1_ps(-1.2420140846e-1f));
  p = _mm512_fmadd_ps(p, z, _mm512_set1_ps(1.4249322787e-1f));
  p = _mm512_fmadd_ps(p, z, _mm512_set1_ps(-1.6668057665e-1f));
  p = _mm512_fmadd_ps(p, z, _mm512_set1_ps(2.0000714765e-1f));
  p = _mm512_fmadd_ps(p, z, _mm512_set1_ps(-2.4999993993e-1f));
  p = _mm512_fmadd_ps(p, z, _mm512_set1_ps(3.3333331174e-1f));
  __m512 ln1z = _mm512_fnmadd_ps(_mm512_set1_ps(0.5f), z2, z);
  ln1z = _mm512_fmadd_ps(_mm512_mul_ps(z2, z), p, ln1z);
  return _mm512_fmadd_ps(ln1z,
                         _mm512_set1_ps(1.44269504088896341f),
                         _mm512_cvtepi32_ps(e));
}

inline __m512 v_exp2(__m512 x) {
  x = _mm512_max_ps(x, _mm512_set1_ps(-126.0f));
  x = _mm512_min_ps(x, _mm512_set1_ps(127.0f));
  const __m512 fi = _mm512_roundscale_ps(
      x, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
  const __m512 f = _mm512_sub_ps(x, fi);
  __m512 p = _mm512_set1_ps(1.535336188319500e-4f);
  p = _mm512_fmadd_ps(p, f, _mm512_set1_ps(1.339887440266574e-3f));
  p = _mm512_fmadd_ps(p, f, _mm512_set1_ps(9.618437357674640e-3f));
  p = _mm512_fmadd_ps(p, f, _mm512_set1_ps(5.550332471162809e-2f));
  p = _mm512_fmadd_ps(p, f, _mm512_set1_ps(2.402264791363012e-1f));
  p = _mm512_fmadd_ps(p, f, _mm512_set1_ps(6.931472028550421e-1f));
  p = _mm512_fmadd_ps(p, f, _mm512_set1_ps(1.0f));
  const __m512i s = _mm512_slli_epi32(
      _mm512_add_epi32(_mm512_cvtps_epi32(fi),
                       _mm512_set1_epi32(127)),
      23);
  return _mm512_mul_ps(p, _mm512_castsi512_ps(s));
}
#endif  // __AVX512F__

// NOTE on scalar tails: the scalar helpers compile with
// -ffp-contract=fast into the same FMA chains as the vector bodies,
// so tail lanes match vector lanes bit for bit.

// sRGB gamma -> linear over a row (ops/color.py srgb_inv_oetf),
// branchless: both branches computed, blended by compare.
void srgb_inv_row(float* io, int64_t w) {
  int64_t x = 0;
#if defined(__AVX512F__)
  for (; x + 16 <= w; x += 16) {
    const __m512 e = _mm512_loadu_ps(io + x);
    const __m512 lin =
        _mm512_mul_ps(e, _mm512_set1_ps(1.0f / 12.92f));
    const __m512 t = _mm512_mul_ps(
        _mm512_add_ps(e, _mm512_set1_ps(0.055f)),
        _mm512_set1_ps(1.0f / 1.055f));
    const __m512 pw =
        v_exp2(_mm512_mul_ps(_mm512_set1_ps(2.4f), v_log2(t)));
    const __mmask16 uselin = _mm512_cmp_ps_mask(
        e, _mm512_set1_ps(0.04045f), _CMP_LE_OQ);
    _mm512_storeu_ps(io + x, _mm512_mask_blend_ps(uselin, pw, lin));
  }
#endif
  for (; x < w; ++x) {
    const float e = io[x];
    const float lin = e * (1.0f / 12.92f);
    const float t = (e + 0.055f) * (1.0f / 1.055f);  // always > 0
    const float pw = fast_exp2f(2.4f * fast_log2f(t));
    io[x] = e <= 0.04045f ? lin : pw;
  }
}

// HLG OETF over a row (ops/color.py hlg_oetf, BT.2100-2 Table 5).
void hlg_oetf_row(float* io, int64_t w) {
  constexpr float A = 0.17883277f, B = 0.28466892f, C = 0.55991073f;
  constexpr float LN2 = 0.6931471805599453f;
  int64_t x = 0;
#if defined(__AVX512F__)
  for (; x + 16 <= w; x += 16) {
    const __m512 e = _mm512_loadu_ps(io + x);
    const __m512 lo = _mm512_sqrt_ps(_mm512_max_ps(
        _mm512_mul_ps(_mm512_set1_ps(3.0f), e),
        _mm512_setzero_ps()));
    const __m512 t = _mm512_max_ps(
        _mm512_fmsub_ps(_mm512_set1_ps(12.0f), e,
                        _mm512_set1_ps(B)),
        _mm512_set1_ps(1e-12f));
    const __m512 hi = _mm512_fmadd_ps(
        _mm512_set1_ps(A),
        _mm512_mul_ps(v_log2(t), _mm512_set1_ps(LN2)),
        _mm512_set1_ps(C));
    const __mmask16 uselo = _mm512_cmp_ps_mask(
        e, _mm512_set1_ps(1.0f / 12.0f), _CMP_LE_OQ);
    _mm512_storeu_ps(io + x, _mm512_mask_blend_ps(uselo, hi, lo));
  }
#endif
  for (; x < w; ++x) {
    const float e = io[x];
    const float lo = std::sqrt(std::max(3.0f * e, 0.0f));
    const float t = std::max(12.0f * e - B, 1e-12f);
    const float hi = A * (fast_log2f(t) * LN2) + C;
    io[x] = e <= 1.0f / 12.0f ? lo : hi;
  }
}

// PQ OETF over a row (ops/color.py pq_oetf, BT.2100-2 Table 4).
void pq_oetf_row(float* io, int64_t w) {
  constexpr float M1 = 2610.0f / 16384.0f;
  constexpr float M2 = 2523.0f / 4096.0f * 128.0f;
  constexpr float C1 = 3424.0f / 4096.0f;
  constexpr float C2 = 2413.0f / 4096.0f * 32.0f;
  constexpr float C3 = 2392.0f / 4096.0f * 32.0f;
  int64_t x = 0;
#if defined(__AVX512F__)
  for (; x + 16 <= w; x += 16) {
    const __m512 e = _mm512_loadu_ps(io + x);
    const __m512 ep = v_exp2(_mm512_mul_ps(
        _mm512_set1_ps(M1),
        v_log2(_mm512_max_ps(e, _mm512_set1_ps(1e-30f)))));
    const __m512 num =
        _mm512_fmadd_ps(_mm512_set1_ps(C2), ep, _mm512_set1_ps(C1));
    const __m512 den =
        _mm512_fmadd_ps(_mm512_set1_ps(C3), ep, _mm512_set1_ps(1.0f));
    const __m512 out = v_exp2(_mm512_mul_ps(
        _mm512_set1_ps(M2), v_log2(_mm512_div_ps(num, den))));
    const __mmask16 zero = _mm512_cmp_ps_mask(
        e, _mm512_setzero_ps(), _CMP_LE_OQ);
    _mm512_storeu_ps(
        io + x,
        _mm512_mask_blend_ps(zero, out, _mm512_setzero_ps()));
  }
#endif
  for (; x < w; ++x) {
    const float e = io[x];
    const float ep =
        fast_exp2f(M1 * fast_log2f(std::max(e, 1e-30f)));
    const float out =
        fast_exp2f(M2 * fast_log2f((C1 + C2 * ep) / (1.0f + C3 * ep)));
    io[x] = e <= 0.0f ? 0.0f : out;
  }
}

// f32 row -> f16 row, RTNE (matches the device's hardware cast).
void f16_row(const float* in, uint16_t* out, int64_t w) {
  int64_t x = 0;
#if defined(__AVX512F__)
  for (; x + 16 <= w; x += 16) {
    const __m512 v = _mm512_loadu_ps(in + x);
    _mm256_storeu_si256(
        (__m256i*)(out + x),
        _mm512_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT));
  }
#elif defined(__F16C__)
  for (; x + 8 <= w; x += 8) {
    const __m256 v = _mm256_loadu_ps(in + x);
    _mm_storeu_si128((__m128i*)(out + x),
                     _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT));
  }
#endif
  for (; x < w; ++x) {
#if defined(__F16C__)
    out[x] = (uint16_t)_cvtss_sh(in[x], _MM_FROUND_TO_NEAREST_INT);
#else
    // Software RTNE fallback.
    const uint32_t b = fbits(in[x]);
    const uint32_t sign = (b >> 16) & 0x8000u;
    const int32_t e = (int32_t)((b >> 23) & 0xFF) - 127 + 15;
    uint32_t m = b & 0x007FFFFFu;
    uint16_t r;
    if (e >= 31) {
      r = 0x7C00u;
    } else if (e <= 0) {
      if (e < -10) {
        r = 0;
      } else {
        m |= 0x00800000u;
        const int shift = 14 - e;
        const uint32_t q = m >> shift;
        const uint32_t rem = m & ((1u << shift) - 1);
        const uint32_t half = 1u << (shift - 1);
        r = (uint16_t)(q + (rem > half || (rem == half && (q & 1))));
      }
    } else {
      const uint32_t q = m >> 13;
      const uint32_t rem = m & 0x1FFFu;
      uint32_t v = ((uint32_t)e << 10) | q;
      v += (rem > 0x1000u || (rem == 0x1000u && (v & 1)));
      r = (uint16_t)v;
    }
    out[x] = (uint16_t)(sign | r);
#endif
  }
}

// Shepard IDW weights for one (py, px, incR, incB) config, computed
// with the exact f32 expressions of ops/gainmap.py _idw_upsample.
struct IdwW {
  float w1, w2, w3, w4, total;
};

void fill_wtab(std::vector<IdwW>& tab, int scale) {
  tab.resize(4 * scale * scale);
  for (int cfg = 0; cfg < 4; ++cfg) {
    const float incR = (cfg & 1) ? 1.0f : 0.0f;
    const float incB = (cfg & 2) ? 1.0f : 0.0f;
    for (int pyi = 0; pyi < scale; ++pyi) {
      for (int pxi = 0; pxi < scale; ++pxi) {
        const float px = (float)pxi / (float)scale;
        const float py = (float)pyi / (float)scale;
        const float d1 = std::sqrt(px * px + py * py);
        const float d2 =
            std::sqrt(px * px + (py - incB) * (py - incB));
        const float d3 =
            std::sqrt((px - incR) * (px - incR) + py * py);
        const float d4 = std::sqrt((px - incR) * (px - incR) +
                                   (py - incB) * (py - incB));
        constexpr float eps = 1e-12f;
        IdwW w;
        w.w1 = 1.0f / std::max(d1, eps);
        w.w2 = 1.0f / std::max(d2, eps);
        w.w3 = 1.0f / std::max(d3, eps);
        w.w4 = 1.0f / std::max(d4, eps);
        w.total = w.w1 + w.w2 + w.w3 + w.w4;
        tab[(cfg * scale + pyi) * scale + pxi] = w;
      }
    }
  }
}

// BT.601 full-range YUV -> RGB constants (ops/color.py _YUV_PARAMS
// "bt601": kr=.299 kg=.587 kb=.114, cb=1.772, cr=1.402 — the decoded
// JPEG base is always BT.601/sRGB, ultrahdr.cpp:437-445).
constexpr float kCr = 1.402f;
constexpr float kCb = 1.772f;
constexpr float kGcb = (float)(0.114 * 1.772 / 0.587);
constexpr float kGcr = (float)(0.299 * 1.402 / 0.587);

struct ApplyArgs {
  const uint8_t* comp;  // composite base (frame)
  int64_t stride;       // composite row stride (bytes)
  int64_t h, w, ch, cw, gh, gw, scale;
  float log2_min, log2_max, boost_factor, display_boost;
  int mode;  // 0 = F16 linear, 1 = HLG 1010102, 2 = PQ 1010102
  void* out;
  const IdwW* wtab;
};

struct RowBufs {
  std::vector<float> r, g, b, gain, uf, vf;
  std::vector<float> e1, e2, e3, e4;  // expanded map rows
  // Full-width weight tiles per py phase (5 planes each: w1..w4,
  // total), built once per thread — they depend only on (pyi, the
  // right-edge band), not on y.
  std::vector<float> wtiles;
  std::vector<uint16_t> h16;  // f16 scratch (3 rows)
  void init(int64_t w_, int s) {
    r.resize(w_);
    g.resize(w_);
    b.resize(w_);
    gain.resize(w_);
    uf.resize(w_);
    vf.resize(w_);
    e1.resize(w_);
    e2.resize(w_);
    e3.resize(w_);
    e4.resize(w_);
    wtiles.resize((size_t)2 * s * 5 * w_);
    h16.resize(3 * w_);
  }
  // Tile layout: [cfgB2][pyi][plane][x] with cfgB2 0 = interior row
  // band, 1 = bottom map row band.
  float* tile(int cfgB2, int pyi, int plane, int s, int64_t w_) {
    return wtiles.data() +
           ((((size_t)cfgB2 * s + pyi) * 5 + plane) * w_);
  }
};

void build_wtiles(RowBufs& bufs, const IdwW* wtab, int s, int64_t w,
                  int64_t gw) {
  const int64_t xedge = std::max<int64_t>((gw - 1) * s, 0);
  for (int cfgB2 = 0; cfgB2 < 2; ++cfgB2) {
    const int cfgB = cfgB2 ? 0 : 2;  // interior rows have incB=1
    for (int pyi = 0; pyi < s; ++pyi) {
      const IdwW* wi = wtab + ((cfgB | 1) * s + pyi) * s;
      const IdwW* we = wtab + ((cfgB | 0) * s + pyi) * s;
      float* t[5];
      for (int pl = 0; pl < 5; ++pl)
        t[pl] = bufs.tile(cfgB2, pyi, pl, s, w);
      int p = 0;
      for (int64_t x = 0; x < w; ++x) {
        const IdwW& ww = (x >= xedge) ? we[p] : wi[p];
        t[0][x] = ww.w1;
        t[1][x] = ww.w2;
        t[2][x] = ww.w3;
        t[3][x] = ww.w4;
        t[4][x] = ww.total;
        if (++p == s) p = 0;
      }
    }
  }
}

void apply_rows(const ApplyArgs& a, int64_t y0, int64_t y1) {
  const int64_t w = a.w;
  const int s = (int)a.scale;
  RowBufs bufs;
  bufs.init(w, s);
  build_wtiles(bufs, a.wtab, s, w, a.gw);
  float* rb = bufs.r.data();
  float* gb = bufs.g.data();
  float* bb = bufs.b.data();
  float* gain = bufs.gain.data();
  const float inv255 = 1.0f / 255.0f;
  const int64_t gxmax = std::min((a.w - 1) / s, a.gw - 1);

  for (int64_t y = y0; y < y1; ++y) {
    const uint8_t* yrow = a.comp + y * a.stride;
    const uint8_t* urow = a.comp + (a.h + (y >> 1)) * a.stride;
    const uint8_t* vrow = urow + a.cw;

    // --- chroma expand (x>>1) then SDR pixel -> linear RGB ---
    for (int64_t x = 0; x < w; ++x) {
      bufs.uf[x] = ((float)urow[x >> 1] - 128.0f) * inv255;
      bufs.vf[x] = ((float)vrow[x >> 1] - 128.0f) * inv255;
    }
    for (int64_t x = 0; x < w; ++x) {
      const float yf = (float)yrow[x] * inv255;
      const float uf = bufs.uf[x];
      const float vf = bufs.vf[x];
      rb[x] = clamp01(yf + kCr * vf);
      gb[x] = clamp01(yf - kGcb * uf - kGcr * vf);
      bb[x] = clamp01(yf + kCb * uf);
    }
    srgb_inv_row(rb, w);
    srgb_inv_row(gb, w);
    srgb_inv_row(bb, w);

    // --- IDW-upsampled gain map -> per-pixel gain factor ---
    const int64_t gy = std::min(y / s, a.gh - 1);
    const int64_t gyn =
        std::min(std::min(gy + 1, (a.h - 1) / s), a.gh - 1);
    const uint8_t* gm0 = a.comp + (a.h + a.ch + gy) * a.stride;
    const uint8_t* gm1 = a.comp + (a.h + a.ch + gyn) * a.stride;
    const int pyi = (int)(y % s);
    // inc_b is 1 in the interior, 0 on the bottom map row
    // (ops/gainmap.py _idw_upsample inc_r/inc_b).
    const int cfgB = (y / s >= a.gh - 1) ? 0 : 2;
    // Expand the 4 corner-sample rows to full width (cell-constant).
    for (int64_t gx = 0; gx <= gxmax; ++gx) {
      const int64_t gxn = std::min(gx + 1, gxmax);
      const float v1 = (float)gm0[gx] * inv255;
      const float v2 = (float)gm1[gx] * inv255;
      const float v3 = (float)gm0[gxn] * inv255;
      const float v4 = (float)gm1[gxn] * inv255;
      const int64_t x0 = gx * s;
      const int64_t x1 = std::min(x0 + s, w);
      for (int64_t x = x0; x < x1; ++x) {
        bufs.e1[x] = v1;
        bufs.e2[x] = v2;
        bufs.e3[x] = v3;
        bufs.e4[x] = v4;
      }
    }
    for (int64_t x = (gxmax + 1) * s; x < w; ++x) {  // x past map
      bufs.e1[x] = bufs.e1[x - 1];
      bufs.e2[x] = bufs.e2[x - 1];
      bufs.e3[x] = bufs.e3[x - 1];
      bufs.e4[x] = bufs.e4[x - 1];
    }
    const int cfgB2 = cfgB ? 0 : 1;
    const float* w1 = bufs.tile(cfgB2, pyi, 0, s, w);
    const float* w2 = bufs.tile(cfgB2, pyi, 1, s, w);
    const float* w3 = bufs.tile(cfgB2, pyi, 2, s, w);
    const float* w4 = bufs.tile(cfgB2, pyi, 3, s, w);
    const float* tt = bufs.tile(cfgB2, pyi, 4, s, w);
    const float* e1 = bufs.e1.data();
    const float* e2 = bufs.e2.data();
    const float* e3 = bufs.e3.data();
    const float* e4 = bufs.e4.data();
    for (int64_t x = 0; x < w; ++x)
      gain[x] = (e1[x] * w1[x] + e2[x] * w2[x] + e3[x] * w3[x] +
                 e4[x] * w4[x]) /
                tt[x];
    // d1 == 0 (both phases 0): exact sample, matching the device's
    // `where(exact, e1, blended)`.
    if (pyi == 0)
      for (int64_t x = 0; x < w; x += s) gain[x] = e1[x];
    const float lmin = a.log2_min, lmax = a.log2_max;
    const float bf = a.boost_factor, db = a.display_boost;
    {
      int64_t x = 0;
#if defined(__AVX512F__)
      const __m512 vmin = _mm512_set1_ps(lmin);
      const __m512 vbf = _mm512_set1_ps(bf);
      const __m512 vdb = _mm512_set1_ps(db);
      const __m512 vone = _mm512_set1_ps(1.0f);
      const __m512 vmax = _mm512_set1_ps(lmax);
      for (; x + 16 <= w; x += 16) {
        const __m512 g01 = _mm512_loadu_ps(gain + x);
        // lmin*(1-g) + lmax*g, same op order as the scalar tail.
        const __m512 lb = _mm512_add_ps(
            _mm512_mul_ps(vmin, _mm512_sub_ps(vone, g01)),
            _mm512_mul_ps(vmax, g01));
        _mm512_storeu_ps(
            gain + x,
            _mm512_div_ps(v_exp2(_mm512_mul_ps(lb, vbf)), vdb));
      }
#endif
      for (; x < w; ++x) {
        const float g01 = gain[x];
        const float lb = lmin * (1.0f - g01) + lmax * g01;
        gain[x] = fast_exp2f(lb * bf) / db;
      }
    }
    for (int64_t x = 0; x < w; ++x) {
      rb[x] *= gain[x];
      gb[x] *= gain[x];
      bb[x] *= gain[x];
    }

    // --- pack ---
    if (a.mode == 0) {
      uint16_t* hr = bufs.h16.data();
      uint16_t* hg = hr + w;
      uint16_t* hb = hg + w;
      f16_row(rb, hr, w);
      f16_row(gb, hg, w);
      f16_row(bb, hb, w);
      uint64_t* o = (uint64_t*)a.out + y * w;
      for (int64_t x = 0; x < w; ++x)
        o[x] = (uint64_t)hr[x] | ((uint64_t)hg[x] << 16) |
               ((uint64_t)hb[x] << 32) | (0x3C00ULL << 48);
    } else {
      if (a.mode == 1) {
        hlg_oetf_row(rb, w);
        hlg_oetf_row(gb, w);
        hlg_oetf_row(bb, w);
      } else {
        pq_oetf_row(rb, w);
        pq_oetf_row(gb, w);
        pq_oetf_row(bb, w);
      }
      uint32_t* o = (uint32_t*)a.out + y * w;
      for (int64_t x = 0; x < w; ++x) {
        const uint32_t ri =
            (uint32_t)(clamp01(rb[x]) * 1023.0f) & 0x3FF;
        const uint32_t gi =
            (uint32_t)(clamp01(gb[x]) * 1023.0f) & 0x3FF;
        const uint32_t bi =
            (uint32_t)(clamp01(bb[x]) * 1023.0f) & 0x3FF;
        o[x] = ri | (gi << 10) | (bi << 20) | 0xC0000000u;
      }
    }
  }
}

}  // namespace

extern "C" {

// Apply the gain map to one frame of decode intermediates laid out
// as the planes-readback composite: rows [0,h) Y (w wide), rows
// [h, h+ch) U|V (cw each), rows [h+ch, h+ch+gh) gain map (gw wide);
// stride is the composite row pitch. mode 0 writes (h, w, 4) u16
// RGBA halves, modes 1 (HLG) / 2 (PQ) write (h, w) u32 RGBA1010102.
// Returns 0, or negative on bad arguments.
long uhdr_apply_gainmap(const uint8_t* comp, int64_t stride,
                        int64_t h, int64_t w, int64_t ch, int64_t cw,
                        int64_t gh, int64_t gw, int64_t scale,
                        float log2_min, float log2_max,
                        float boost_factor, float display_boost,
                        int mode, void* out, long nthreads) {
  if (h <= 0 || w <= 0 || ch <= 0 || cw <= 0 || gh <= 0 || gw <= 0)
    return -1;
  if (scale <= 0 || scale > 256 || mode < 0 || mode > 2) return -2;
  if (stride < w || stride < 2 * cw || stride < gw) return -3;
  if (display_boost <= 0.0f) return -4;

  std::vector<IdwW> wtab;
  fill_wtab(wtab, (int)scale);
  ApplyArgs a{comp,     stride,   h,  w,  ch,  cw, gh, gw, scale,
              log2_min, log2_max, boost_factor, display_boost,
              mode,     out,      wtab.data()};

  long T = nthreads;
  if (T > 8) T = 8;
  if (T <= 1 || h < 4 * T) {
    apply_rows(a, 0, h);
    return 0;
  }
  std::vector<std::thread> ts;
  const int64_t band = ((h + T - 1) / T + 1) & ~1LL;
  for (long t = 0; t < T; ++t) {
    const int64_t y0 = t * band;
    const int64_t y1 = std::min(y0 + band, h);
    if (y0 >= y1) break;
    ts.emplace_back(apply_rows, std::cref(a), y0, y1);
  }
  for (auto& th : ts) th.join();
  return 0;
}

}  // extern "C"
