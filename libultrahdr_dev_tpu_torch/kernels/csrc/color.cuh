// Device copies of the transfer functions in ops/color.py, rounding the
// same way. The build passes -fmad=false, so a multiply and an add fuse
// only where fmaf() says so: exactly where ops/color.py:fma fuses them,
// following the JAX reference as XLA compiles it. A division by a
// constant is a multiplication by the constant's float32 reciprocal,
// and pow() is evaluated in double, as in ops/color.py (pow_rn); every
// pow of the kernels is pow_exact, which gives pow_rn's bits at less
// cost: B6 and B11 (apply.cu: the sRGB inverse OETF's green, the PQ
// OETF) and B1, B9 and B10b (encode_front.cu: the sRGB inverse OETF and
// the PQ inverse OETF of the computed arm). Shared by encode_front.cu
// (B1, B9, B10a-c), apply.cu (B6, B11) and sdr_out.cu (B7).
// Constants are written (float)<double> so that they round the way the
// Python constants do (decimal -> double -> float32).
#pragma once

#include <cstdint>

namespace uhdr {

constexpr float kHlgA = (float)0.17883277;
constexpr float kHlgB = (float)0.28466892;
constexpr float kHlgC = (float)0.55991073;

constexpr float kPqM1 = (float)(2610.0 / 16384.0);
constexpr float kPqM2 = (float)(2523.0 / 4096.0 * 128.0);
constexpr float kPqC1 = (float)(3424.0 / 4096.0);
constexpr float kPqC2 = (float)(2413.0 / 4096.0 * 32.0);
constexpr float kPqC3 = (float)(2392.0 / 4096.0 * 32.0);

constexpr float kPqInvA = 128.0f;
constexpr float kPqInvB = 107.0f;
constexpr float kPqInvC = 2413.0f;
constexpr float kPqInvD = 2392.0f;
constexpr float kPqInvE = (float)6.2773946361;
constexpr float kPqInvF = (float)0.0126833;

// float32 reciprocals of constant divisors (ops/color.py:recip).
constexpr float kRcp1292 = 1.0f / (float)12.92;
constexpr float kRcp1055 = 1.0f / (float)1.055;
constexpr float kRcp3 = 1.0f / 3.0f;
constexpr float kRcp12 = 1.0f / 12.0f;
constexpr float kRcpHlgA = 1.0f / kHlgA;

// Transfer function ids, as ops/gainmap.py numbers them.
enum Tf : int { kLinear = 0, kHlg = 1, kPq = 2 };

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float pow_rn(float x, float p) {
  return (float)pow((double)x, (double)p);
}

// Tables of pow_exact: cl[i] = {c, lt}: c = n_i / 1024 with n_i =
// round(1024 / (1 + (i + 0.5) / 128)), exact in double, and lt =
// -log2(c); e2[j] = 2^(j / 64); lt and e2 rounded to double from a
// 60-digit evaluation.
struct PowTables {
  double2 cl[128];
  double e2[64];
};

__device__ const PowTables kPowTables = {
    {
     {0x1.fe00000000000p-1, 0x1.720d9c06a835fp-8},
     {0x1.fa00000000000p-1, 0x1.16a21e20a0a45p-6},
     {0x1.f600000000000p-1, 0x1.d23afc49139f9p-6},
     {0x1.f280000000000p-1, 0x1.3bcdd9b9f00f3p-5},
     {0x1.ee80000000000p-1, 0x1.9b05038d84095p-5},
     {0x1.eb00000000000p-1, 0x1.eef792508b69dp-5},
     {0x1.e780000000000p-1, 0x1.21c1ef55f06c2p-4},
     {0x1.e380000000000p-1, 0x1.5271a78622a0fp-4},
     {0x1.e000000000000p-1, 0x1.7d60496cfbb4cp-4},
     {0x1.dc80000000000p-1, 0x1.a89f5a6dc9accp-4},
     {0x1.d900000000000p-1, 0x1.d4300a2524d41p-4},
     {0x1.d600000000000p-1, 0x1.f9c95dc1d1165p-4},
     {0x1.d280000000000p-1, 0x1.12fa6f550f896p-3},
     {0x1.cf00000000000p-1, 0x1.293ac3dc1a668p-3},
     {0x1.cc00000000000p-1, 0x1.3c6fb650cde51p-3},
     {0x1.c880000000000p-1, 0x1.5300d796df33ap-3},
     {0x1.c580000000000p-1, 0x1.667c08270b905p-3},
     {0x1.c280000000000p-1, 0x1.7a18529635926p-3},
     {0x1.bf80000000000p-1, 0x1.8dd62821404a9p-3},
     {0x1.bc80000000000p-1, 0x1.a1b5fc4e0b465p-3},
     {0x1.b980000000000p-1, 0x1.b5b844fb4b3efp-3},
     {0x1.b680000000000p-1, 0x1.c9dd7a70ed160p-3},
     {0x1.b380000000000p-1, 0x1.de26177108d03p-3},
     {0x1.b080000000000p-1, 0x1.f29299496a889p-3},
     {0x1.ad80000000000p-1, 0x1.0391bff2dbcf3p-2},
     {0x1.ab00000000000p-1, 0x1.0c318aedff3c0p-2},
     {0x1.a800000000000p-1, 0x1.169c05363f158p-2},
     {0x1.a580000000000p-1, 0x1.1f588973c8747p-2},
     {0x1.a300000000000p-1, 0x1.28225bb5e64a4p-2},
     {0x1.a000000000000p-1, 0x1.32bfee370ee68p-2},
     {0x1.9d80000000000p-1, 0x1.3ba7963fc1f8fp-2},
     {0x1.9b00000000000p-1, 0x1.449d115ef7d87p-2},
     {0x1.9880000000000p-1, 0x1.4da08ac46495ap-2},
     {0x1.9600000000000p-1, 0x1.56b22e6b578e5p-2},
     {0x1.9380000000000p-1, 0x1.5fd2291fc33cfp-2},
     {0x1.9100000000000p-1, 0x1.6900a8836d0d5p-2},
     {0x1.8e80000000000p-1, 0x1.723ddb1346b65p-2},
     {0x1.8c00000000000p-1, 0x1.7b89f02cf2aadp-2},
     {0x1.8980000000000p-1, 0x1.84e5181475449p-2},
     {0x1.8780000000000p-1, 0x1.8c6c335d8b966p-2},
     {0x1.8500000000000p-1, 0x1.95e2f9b51f04ep-2},
     {0x1.8280000000000p-1, 0x1.9f695efbbd0efp-2},
     {0x1.8080000000000p-1, 0x1.a713787ad97a5p-2},
     {0x1.7e00000000000p-1, 0x1.b0b67f4f46810p-2},
     {0x1.7c00000000000p-1, 0x1.b877c57b1b070p-2},
     {0x1.7980000000000p-1, 0x1.c2381c08baf4fp-2},
     {0x1.7780000000000p-1, 0x1.ca111cb2aa5c5p-2},
     {0x1.7580000000000p-1, 0x1.d1f4d7febf868p-2},
     {0x1.7380000000000p-1, 0x1.d9e36b6b825b1p-2},
     {0x1.7100000000000p-1, 0x1.e3dd1156507dep-2},
     {0x1.6f00000000000p-1, 0x1.ebe47960e3c08p-2},
     {0x1.6d00000000000p-1, 0x1.f3f71cc1b629cp-2},
     {0x1.6b00000000000p-1, 0x1.fc151b11b3640p-2},
     {0x1.6900000000000p-1, 0x1.021f4a37ecbfbp-1},
     {0x1.6700000000000p-1, 0x1.0639d4c219d60p-1},
     {0x1.6500000000000p-1, 0x1.0a5a3dc175219p-1},
     {0x1.6300000000000p-1, 0x1.0e809617b46b4p-1},
     {0x1.6180000000000p-1, 0x1.11a147ba74654p-1},
     {0x1.5f80000000000p-1, 0x1.15d22c6522ad8p-1},
     {0x1.5d80000000000p-1, 0x1.1a09305223bcbp-1},
     {0x1.5b80000000000p-1, 0x1.1e46657e97d84p-1},
     {0x1.5a00000000000p-1, 0x1.217868b0c37e8p-1},
     {0x1.5800000000000p-1, 0x1.25c0a0463beb0p-1},
     {0x1.5600000000000p-1, 0x1.2a0f3c340705cp-1},
     {0x1.5480000000000p-1, 0x1.2d4e6e8916467p-1},
     {0x1.5280000000000p-1, 0x1.31a86875b382ep-1},
     {0x1.5100000000000p-1, 0x1.34f037d6c5fb2p-1},
     {0x1.4f00000000000p-1, 0x1.3955cc6251e47p-1},
     {0x1.4d80000000000p-1, 0x1.3ca666fd4927fp-1},
     {0x1.4c00000000000p-1, 0x1.3ffad4e74f1d6p-1},
     {0x1.4a00000000000p-1, 0x1.44716a2c08262p-1},
     {0x1.4880000000000p-1, 0x1.47cee7d754971p-1},
     {0x1.4700000000000p-1, 0x1.4b3056db995a4p-1},
     {0x1.4500000000000p-1, 0x1.4fb8725eb5ba9p-1},
     {0x1.4380000000000p-1, 0x1.532338d90ec72p-1},
     {0x1.4200000000000p-1, 0x1.5692101d9b4a6p-1},
     {0x1.4080000000000p-1, 0x1.5a0501e48bd44p-1},
     {0x1.3f00000000000p-1, 0x1.5d7c18091581ep-1},
     {0x1.3d80000000000p-1, 0x1.60f75c8a1b007p-1},
     {0x1.3c00000000000p-1, 0x1.6476d98ad990ap-1},
     {0x1.3a80000000000p-1, 0x1.67fa99539a278p-1},
     {0x1.3900000000000p-1, 0x1.6b82a65266cbep-1},
     {0x1.3780000000000p-1, 0x1.6f0f0b1bc44e4p-1},
     {0x1.3600000000000p-1, 0x1.729fd26b707c8p-1},
     {0x1.3480000000000p-1, 0x1.7635072524f2dp-1},
     {0x1.3300000000000p-1, 0x1.79ceb4555eab9p-1},
     {0x1.3180000000000p-1, 0x1.7d6ce5322a726p-1},
     {0x1.3000000000000p-1, 0x1.810fa51bf65fdp-1},
     {0x1.2e80000000000p-1, 0x1.84b6ff9e6882cp-1},
     {0x1.2d80000000000p-1, 0x1.872925d8cb66bp-1},
     {0x1.2c00000000000p-1, 0x1.8ad846cf369a4p-1},
     {0x1.2a80000000000p-1, 0x1.8e8c2201e7df6p-1},
     {0x1.2900000000000p-1, 0x1.9244c3a281a86p-1},
     {0x1.2800000000000p-1, 0x1.94c287492c4dbp-1},
     {0x1.2680000000000p-1, 0x1.988339e5cfb8bp-1},
     {0x1.2500000000000p-1, 0x1.9c48d45f2b525p-1},
     {0x1.2400000000000p-1, 0x1.9ecf50bf43f13p-1},
     {0x1.2280000000000p-1, 0x1.a29d35124e123p-1},
     {0x1.2180000000000p-1, 0x1.a529442d54609p-1},
     {0x1.2000000000000p-1, 0x1.a8ff971810a5ep-1},
     {0x1.1f00000000000p-1, 0x1.ab9151be168ddp-1},
     {0x1.1d80000000000p-1, 0x1.af7038f4fb457p-1},
     {0x1.1c80000000000p-1, 0x1.b207b89d3bc1ep-1},
     {0x1.1b00000000000p-1, 0x1.b5ef5ad3e1670p-1},
     {0x1.1a00000000000p-1, 0x1.b88cb9a2ab521p-1},
     {0x1.1880000000000p-1, 0x1.bc7d3e94dedc5p-1},
     {0x1.1780000000000p-1, 0x1.bf209761c35e4p-1},
     {0x1.1680000000000p-1, 0x1.c1c65bdb503cfp-1},
     {0x1.1500000000000p-1, 0x1.c5c3963948fa5p-1},
     {0x1.1400000000000p-1, 0x1.c86f7b7ea4a89p-1},
     {0x1.1300000000000p-1, 0x1.cb1ddc4196f6ep-1},
     {0x1.1180000000000p-1, 0x1.cf281f15f0be7p-1},
     {0x1.1080000000000p-1, 0x1.d1dcc8f1282afp-1},
     {0x1.0f80000000000p-1, 0x1.d493feb7e8562p-1},
     {0x1.0e80000000000p-1, 0x1.d74dc539de4f5p-1},
     {0x1.0d00000000000p-1, 0x1.db694903d94b8p-1},
     {0x1.0c00000000000p-1, 0x1.de298ec0bac0dp-1},
     {0x1.0b00000000000p-1, 0x1.e0ec767ccdac6p-1},
     {0x1.0a00000000000p-1, 0x1.e3b20546f554ap-1},
     {0x1.0900000000000p-1, 0x1.e67a403cb6ae7p-1},
     {0x1.0780000000000p-1, 0x1.eaaba6d44732bp-1},
     {0x1.0680000000000p-1, 0x1.ed7aa6fa358f1p-1},
     {0x1.0580000000000p-1, 0x1.f04c65a983cb5p-1},
     {0x1.0480000000000p-1, 0x1.f320e8445b29ap-1},
     {0x1.0380000000000p-1, 0x1.f5f8343ccbd17p-1},
     {0x1.0280000000000p-1, 0x1.f8d24f150baebp-1},
     {0x1.0180000000000p-1, 0x1.fbaf3e5fb688cp-1},
     {0x1.0080000000000p-1, 0x1.fe8f07c00f58bp-1},
    },
    {
     0x1.0000000000000p+0, 0x1.02c9a3e778061p+0, 0x1.059b0d3158574p+0,
     0x1.0874518759bc8p+0, 0x1.0b5586cf9890fp+0, 0x1.0e3ec32d3d1a2p+0,
     0x1.11301d0125b51p+0, 0x1.1429aaea92de0p+0, 0x1.172b83c7d517bp+0,
     0x1.1a35beb6fcb75p+0, 0x1.1d4873168b9aap+0, 0x1.2063b88628cd6p+0,
     0x1.2387a6e756238p+0, 0x1.26b4565e27cddp+0, 0x1.29e9df51fdee1p+0,
     0x1.2d285a6e4030bp+0, 0x1.306fe0a31b715p+0, 0x1.33c08b26416ffp+0,
     0x1.371a7373aa9cbp+0, 0x1.3a7db34e59ff7p+0, 0x1.3dea64c123422p+0,
     0x1.4160a21f72e2ap+0, 0x1.44e086061892dp+0, 0x1.486a2b5c13cd0p+0,
     0x1.4bfdad5362a27p+0, 0x1.4f9b2769d2ca7p+0, 0x1.5342b569d4f82p+0,
     0x1.56f4736b527dap+0, 0x1.5ab07dd485429p+0, 0x1.5e76f15ad2148p+0,
     0x1.6247eb03a5585p+0, 0x1.6623882552225p+0, 0x1.6a09e667f3bcdp+0,
     0x1.6dfb23c651a2fp+0, 0x1.71f75e8ec5f74p+0, 0x1.75feb564267c9p+0,
     0x1.7a11473eb0187p+0, 0x1.7e2f336cf4e62p+0, 0x1.82589994cce13p+0,
     0x1.868d99b4492edp+0, 0x1.8ace5422aa0dbp+0, 0x1.8f1ae99157736p+0,
     0x1.93737b0cdc5e5p+0, 0x1.97d829fde4e50p+0, 0x1.9c49182a3f090p+0,
     0x1.a0c667b5de565p+0, 0x1.a5503b23e255dp+0, 0x1.a9e6b5579fdbfp+0,
     0x1.ae89f995ad3adp+0, 0x1.b33a2b84f15fbp+0, 0x1.b7f76f2fb5e47p+0,
     0x1.bcc1e904bc1d2p+0, 0x1.c199bdd85529cp+0, 0x1.c67f12e57d14bp+0,
     0x1.cb720dcef9069p+0, 0x1.d072d4a07897cp+0, 0x1.d5818dcfba487p+0,
     0x1.da9e603db3285p+0, 0x1.dfc97337b9b5fp+0, 0x1.e502ee78b3ff6p+0,
     0x1.ea4afa2a490dap+0, 0x1.efa1bee615a27p+0, 0x1.f50765b6e4540p+0,
     0x1.fa7c1819e90d8p+0,
    }};

// pow_rn(x, p) bit for bit at a fraction of its cost, for the float
// exponents of the transfer functions. x^p = 2^(p log2 x) in double
// from short tables: log2 x = e + lt + log2(1 + r), r = m c - 1
// exact (|r| < 2^-7.6, a degree-6 series), then 2^t = 2^(k/64) 2^f
// with |f| <= 2^-7 (e2[k mod 64] and a degree-5 series). The result's
// relative error is below 2^-44, far inside kPowTol (2^-37). Its
// rounding to float is taken when no float rounding boundary (a
// midpoint, low 29 bits of the double's mantissa 2^28) lies within
// kPowTol of it: then the true x^p and pow()'s double (within 2^-51 of
// it) round to the same float. Otherwise, and for x or x^p outside the
// normal floats, the thread evaluates pow_rn itself (Ziv's test). The
// build's -fmad=false leaves every fma() below as written.
constexpr int kPowTol = 1 << 16;  // double ulps of the mantissa: 2^-37

__device__ __forceinline__ float pow_exact(float x, float p,
                                           const PowTables& t,
                                           bool* slow = nullptr) {
  unsigned xb = __float_as_uint(x);
  if (xb - 0x00800000u < 0x7F000000u) {  // x positive, normal, finite
    unsigned i = (xb >> 16) & 127u;
    // m = 1.mantissa in [1, 2) and e + 1024 + 2^52, both built exactly.
    double m = __hiloint2double(0x3FF00000 | ((xb & 0x7FFFFFu) >> 3),
                                xb << 29);
    double e = __hiloint2double(0x43300000, (xb >> 23) + (1024 - 127)) -
               0x1.00000000004p52;
    const double2 cl = t.cl[i];
    double r = fma(m, cl.x, -1.0);
    double s = fma(r, -1.0 / 6.0, 0.2);
    s = fma(r, s, -0.25);
    s = fma(r, s, 1.0 / 3.0);
    s = fma(r, s, -0.5);
    double ln1p = fma(r * r, s, r);
    double tt = (e + fma(ln1p, 0x1.71547652b82fep0, cl.y)) * (double)p;
    double kd = fma(tt, 64.0, 0x1.8p52);  // rint(64 t) in the low word
    int k = __double2loint(kd);
    double u = fma(kd - 0x1.8p52, -1.0 / 64.0, tt) * 0x1.62e42fefa39efp-1;
    double q = fma(u, 1.0 / 120.0, 1.0 / 24.0);
    q = fma(u, q, 1.0 / 6.0);
    q = fma(u, q, 0.5);
    q = fma(u, q, 1.0);
    q = fma(u, q, 1.0);
    double y = t.e2[k & 63] * q;
    if (k >= -125 * 64 && k < 127 * 64) {  // x^p a normal float
      y = __hiloint2double(__double2hiint(y) + ((k >> 6) << 20),
                           __double2loint(y));
      int mid = (int)(__double2loint(y) & 0x1FFFFFFFu) - (1 << 28);
      if (mid > kPowTol || mid < -kPowTol) return (float)y;
    }
  }
  if (slow) *slow = true;
  return pow_rn(x, p);
}

// Fills a CTA's copy of pow_exact's tables (2.5 KB; the caller
// synchronizes before the first pow_exact).
__device__ __forceinline__ void load_pow_tables(PowTables* dst) {
  const double* src = reinterpret_cast<const double*>(&kPowTables);
  double* d = reinterpret_cast<double*>(dst);
  for (int i = threadIdx.x; i < (int)(sizeof(PowTables) / 8);
       i += blockDim.x)
    d[i] = src[i];
}

__device__ __forceinline__ float srgb_inv_oetf_exact(float e,
                                                     const PowTables& t) {
  if (e <= (float)0.04045) return e * kRcp1292;
  return pow_exact((e + (float)0.055) * kRcp1055, (float)2.4, t);
}

__device__ __forceinline__ float hlg_oetf(float e) {
  if (e <= (float)(1.0 / 12.0)) return sqrtf(fmaxf(3.0f * e, 0.0f));
  return fmaf(kHlgA, logf(fmaxf(fmaf(12.0f, e, -kHlgB), (float)1e-12)),
              kHlgC);
}

__device__ __forceinline__ float hlg_inv_oetf(float e) {
  if (e <= 0.5f) return (e * e) * kRcp3;
  return (expf((e - kHlgC) * kRcpHlgA) + kHlgB) * kRcp12;
}

// The PQ OETF, its powers by pow_exact (ops/color.py:pq_oetf's results).
__device__ __forceinline__ float pq_oetf(float e, const PowTables& t) {
  if (e <= 0.0f) return 0.0f;
  float ep = pow_exact(fmaxf(e, 0.0f), kPqM1, t);
  return pow_exact(fmaf(kPqC2, ep, kPqC1) / fmaf(kPqC3, ep, 1.0f), kPqM2, t);
}

// The PQ inverse OETF (ops/color.py:pq_inv_oetf), its powers by
// pow_exact: for e in [0, 1] (the callers clamp) both bases lie in
// [0, 1], where chip_smoke.py's pow_phase holds pow_exact to pow_rn on
// every float32 for both exponents.
__device__ __forceinline__ float pq_inv_oetf(float e, const PowTables& t) {
  if (e <= (float)0.0001) return 0.0f;
  float ef = pow_exact(fmaxf(e, (float)1e-5), kPqInvF, t);
  float num = fmaf(kPqInvA, ef, -kPqInvB);
  float den = fmaf(-kPqInvD, ef, kPqInvC);
  return pow_exact(fmaxf(num / den, 0.0f), kPqInvE, t);
}

__device__ __forceinline__ float hdr_inv_oetf(float e, int tf,
                                              const PowTables& t) {
  return tf == kHlg ? hlg_inv_oetf(e) : tf == kPq ? pq_inv_oetf(e, t) : e;
}

// YUV -> RGB with the reference's clamping; cr, cb and the green
// weights gcb = kb*cb/kg, gcr = kr*cr/kg come from ops/color.py.
struct YuvToRgb {
  float cr, cb, gcb, gcr;
  __device__ __forceinline__ void operator()(float y, float u, float v,
                                             float* r, float* g,
                                             float* b) const {
    *r = clamp01(fmaf(cr, v, y));
    *g = clamp01(fmaf(-gcr, v, fmaf(-gcb, u, y)));
    *b = clamp01(fmaf(cb, u, y));
  }
};

// m0*x0 + m1*x1 as ops/color.py:dot2 rounds it: XLA on the CPU fuses
// the first product of the sum into the add, unless m0 < 0 <= m1, where
// it rewrites the sum as a difference led by the second term.
__device__ __forceinline__ float dot2(float m0, float x0, float m1,
                                      float x1) {
  if (m0 < 0.0f && m1 >= 0.0f) return fmaf(m1, x1, m0 * x0);
  return fmaf(m0, x0, m1 * x1);
}

// m0*x0 + m1*x1 + m2*x2 (ops/color.py:dot3).
__device__ __forceinline__ float dot3(const float* m, float x0, float x1,
                                      float x2) {
  return fmaf(m[2], x2, dot2(m[0], x0, m[1], x1));
}

// kr*r + kg*g + kb*b, fused as ops/color.py:luminance fuses it.
__device__ __forceinline__ float luminance(float kr, float kg, float kb,
                                           float r, float g, float b) {
  return fmaf(kb, b, fmaf(kr, r, kg * g));
}

// Index of x in an n-entry transfer table (ops/color.py:lut_index):
// trunc(x * (n - 1) + 0.5) with the multiply-add fused, clamped.
__device__ __forceinline__ int lut_index(float x, int n) {
  int i = (int)fmaf(x, (float)(n - 1), 0.5f);
  return min(max(i, 0), n - 1);
}

// A u8 plane of a batch with its own (batch, row) strides in bytes and
// unit column stride: B5's crops of padded IDCT output, read in place.
struct Plane {
  const uint8_t* p;
  long long batch_stride, row_stride;
  __device__ __forceinline__ const uint8_t* row(int b, int y) const {
    return p + b * batch_stride + y * row_stride;
  }
};

}  // namespace uhdr
