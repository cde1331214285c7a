// Fused readout-window resolver for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_processor_tpu/ops/resolve_pallas.py
// ::_kernel (launched per sample chunk by _resolve_call).  For every
// (shot, core) readout window it computes what that kernel computes:
// envelope playback with hold-last-sample overrun, the phase-coherent
// carrier e^{iA} * basis[f](s), the window mask s < nsamp, the amplitude,
// the state-dependent channel w(s) * g_s * y (ring-up
// w(s) = 1 - exp(-(s+1) / ring_tau) when `ring` is set), additive ADC
// noise, and the matched-filter sums
//   acc_i = sum(r_i y_i + r_q y_q), acc_q = sum(r_q y_i - r_i y_q),
//   energy = sum(y_i^2 + y_q^2).
//
// Rows mode (a static row list: the main path).  Write the window as
// y(s) = a e^{iA} z(s), z(s) = env(base + s / interp) * basis_f(s).  Then,
// exactly in real arithmetic, with n = min(nsamp, W) and g = gs_i + i gs_q,
//   acc_i + i acc_q = g a^2 |e^{iA}|^2 Pw[n] + a e^{-iA} sum_{s<n} nz(s) z*(s)
//   energy          =   a^2 |e^{iA}|^2 P1[n]
// where P1 and Pw (ring-weighted) are prefix sums of |z|^2 over the
// window.  They depend only on (core, row, frequency, n), so the wrapper
// builds them once per run (ops/resolve.py build_prefix_tables, float64
// sums stored as float32) and the deterministic part is one read per
// window.  The row is picked by address equality (the TPU kernel's row
// select, default row 0).
//
// Design.  Without noise (sigma = 0, nothing streamed) one thread owns
// one window: O(1) work, bound by the bytes of the window scalars.  With
// noise, only the projection sum_{s<n} nz(s) z*(s) is left per sample, and
// one warp owns one window: lane l takes the sample pairs p = l, l + 32,
// ..., so every lane of a warp has the same trip count to within one,
// and a warp-shuffle reduce of two floats ends the window.  A block's
// warps share its core (blockIdx.y) and walk its windows grid-stride; the
// core's z rows (R * F * W * 8 bytes, 8 KB at the headline) sit in shared
// memory, copied once per block, as float4 pairs (z(2p), z(2p+1)).  All
// lanes of a warp read one row, 16 consecutive bytes each, so the warp's
// read is conflict-free without padding (padding would break the 16-byte
// alignment of the pairs).  Rows too large for shared memory are read
// from global memory (L1/L2).  No integer division per sample.
//
// Noise.  By default Philox4x32-10 in the kernel: key = the 64-bit seed
// (its ten round keys hoisted out of the sample loop), counter =
// (sample pair, shot, core, epoch); each call feeds the two samples of a
// pair, one Box-Muller pair each, on the special-function unit: u1 =
// 2 - 1.m in [2^-23, 1] and u2 = 1.m - 1.5 in [-1/2, 1/2), 1.m the float
// with 23 random mantissa bits (no integer-to-float conversion), radius
// sqrt(-2 ln u1) by lg2.approx and sqrt.approx, angle 2 pi u2 centred at
// 0 by __sincosf.  The normals are the same in law as the full-table
// kernel's (24-bit uniforms, accurate functions), not the same numbers.
// The noise never touches device memory.  With `noise` given
// it is read from a streamed [2, C, B, W] float32 array instead (already
// scaled by sigma), so the kernel and the plain torch version can see
// identical noise.
//
// Full-table mode (no static rows: a register-sourced envelope word, or
// more than 8 static addresses; not on the main path) keeps the per-sample
// chain, one thread per window, with accurate log, sqrt and sincospi on
// 24-bit uniforms, as the port first wrote it: it serves as the same-call
// comparison with the rows-mode design.
//
// AR(1) ADC noise (rho > 0; the colored branch of the TPU package's
// physics._resolve).  Per window and per I/Q stream the noise is
//   n_t = rho n_{t-1} + c w_t,  c = sqrt(1 - rho^2),  n_{-1} ~ N(0, 1),
// w_t the unit whites above (scaled by sigma like them), so the stream is
// stationary with unit variance; the matched filter then projects n as
// it projects white noise.  The TPU formulation, a triangular [chunk,
// chunk] product per chunk with one sample carried across chunks, stays
// the plain version (ops/resolve.py).  Here the recursion is a warp scan:
// a warp walks its window 64 samples per iteration, lane l holding
// samples 2l and 2l + 1, whose two steps compose into one affine map
// n -> rho^2 n + c (rho w_{2l} + w_{2l+1}); an inclusive Hillis-Steele
// scan of the maps (5 shuffle steps; the slopes are powers of rho known
// in advance, so only the intercepts are shuffled) gives every lane's
// odd sample from the iteration's carry, one more shuffle the even one,
// and lane 31's odd sample is the next carry.  n_{-1} is one extra
// Philox call per window (counter pair index 0xffffffff).  The
// full-table kernel, one thread per window, runs the recursion as it is.
// With `noise` streamed, it holds the whites and `noise0` [2, C, B] the
// initial states (both scaled by sigma), so the kernel and the plain
// version color the same numbers.  The white-noise kernels are other
// instantiations of the same templates (AR1 = false) and unchanged.
//
// Bound on this card.  Device memory sees ~10 scalars in and 3 out per
// window (0.09 GB per epoch at B = 262144, C = 8: 0.03 ms at 3.35 TB/s);
// that bounds the kernel at sigma = 0.  With noise, per noisy sample: 4
// special-function operations (log, sqrt, sin, cos; 16 per clock per SM),
// half a Philox call (10 32x32->64-bit multiplies at 64 per clock per SM,
// 10 three-way xors) and ~18 more instructions (uniforms, Box-Muller
// products, the 4-FMA projection), at 128 per clock per SM: at W = 1024,
// 2.1e9 noisy samples per epoch, ~2.4 ms of instruction issue on 132 SMs
// at 1.98 GHz.  The design does nothing per sample that the noise does
// not need; what the compiled loop issues beyond that (round keys, loop
// control, the odd-tail select) and the multiply and special-function
// pipes' latencies keep it above.  AR(1) adds, per sample and stream,
// about 2 FMAs (the lane's map and its even sample) and, per 64 samples,
// 5 compose steps of a shuffle and an FMA per stream, the even sample's
// shuffle and the carry broadcast: chip_smoke.py restates the bound with
// these counts (the shuffles issue at a quarter of the FMA rate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
// largest z table (per core) kept in shared memory
constexpr size_t MAX_SMEM_Z = 96 * 1024;
constexpr uint32_t PH_M0 = 0xD2511F53u, PH_M1 = 0xCD9E8D57u;
constexpr uint32_t PH_W0 = 0x9E3779B9u, PH_W1 = 0xBB67AE85u;

struct Lanes {
  const float *amp, *cosa, *sina, *gs_i, *gs_q;
  const int *f_idx, *addr, *nsamp;
};

struct Outs {
  float *acc_i, *acc_q, *energy;
};

// the ten round keys of one Philox4x32-10 key
struct PhiloxKey {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKey philox_key(uint32_t k0, uint32_t k1) {
  PhiloxKey k;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    k.k0[i] = k0 + (uint32_t)i * PH_W0;
    k.k1[i] = k1 + (uint32_t)i * PH_W1;
  }
  return k;
}

__device__ __forceinline__ uint4 philox(uint4 ctr, const PhiloxKey& k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(PH_M0, ctr.x), lo0 = PH_M0 * ctr.x;
    const uint32_t hi1 = __umulhi(PH_M1, ctr.z), lo1 = PH_M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k.k0[i], lo1, hi0 ^ ctr.w ^ k.k1[i], lo0);
  }
  return ctr;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// one unit-variance Box-Muller I/Q pair from two uniform words, on the
// special-function unit: u1 in [2^-23, 1] is never denormal, so the log
// needs no range fix-up; the angle is 2 pi (1.m - 1.5) in one FMA
__device__ __forceinline__ float2 box_muller_fast(uint32_t a, uint32_t b) {
  const float u1 = 2.0f - __uint_as_float(0x3f800000u | (a >> 9));
  const float r = sqrt_approx(-1.3862943611198906f * lg2_approx(u1));
  const float t = fmaf(6.2831853071795865f,
                       __uint_as_float(0x3f800000u | (b >> 9)),
                       -9.4247779607693797f);
  float sn, cs;
  __sincosf(t, &sn, &cs);
  return make_float2(r * cs, r * sn);
}

// one N(0, sigma^2) I/Q pair, accurate functions (full-table kernel)
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b,
                                           float sigma, float* nz_i,
                                           float* nz_q) {
  const float u1 = (float)((a >> 8) + 1u) * 5.9604644775390625e-8f;
  const float u2 = (float)(b >> 8) * 5.9604644775390625e-8f;
  const float r = sigma * sqrtf(-2.0f * logf(u1));
  float sn, cs;
  sincospif(2.0f * u2, &sn, &cs);
  *nz_i = r * cs;
  *nz_q = r * sn;
}

// index of the static row whose address equals `ad` (row 0 when none
// does; the last when several do)
__device__ __forceinline__ int row_of(int ad, const int* __restrict__ rows,
                                      int n_rows) {
  int r0 = 0;
  for (int r = 1; r < n_rows; ++r)
    if (ad == rows[r]) r0 = r;
  return r0;
}

// one window: its scalars, sample count n, (core, row, frequency) table
// row zrow, and its deterministic sums read from the prefix tables
struct Window {
  float a, ca, sa, det_i, det_q, energy;
  int n, zrow;
};

__device__ __forceinline__ Window window_of(
    const Lanes& in, size_t lane, int c, const int* __restrict__ rows,
    int n_rows, const float* __restrict__ p1, const float* __restrict__ pw,
    int W, int F) {
  Window w;
  w.a = in.amp[lane];
  w.ca = in.cosa[lane];
  w.sa = in.sina[lane];
  w.n = min(max(in.nsamp[lane], 0), W);
  const int r = row_of(in.addr[lane], rows, n_rows);
  w.zrow = (c * n_rows + r) * F + in.f_idx[lane];
  const size_t off = (size_t)w.zrow * (W + 1) + w.n;
  const float k = w.a * w.a * (w.ca * w.ca + w.sa * w.sa);
  const float kw = k * pw[off];
  w.energy = k * p1[off];
  w.det_i = in.gs_i[lane] * kw;
  w.det_q = in.gs_q[lane] * kw;
  return w;
}

// rows mode without noise: one thread per window, lanes flattened so
// that neighbouring threads read neighbouring words
__global__ void resolve_rows_clean(Lanes in, const int* __restrict__ rows,
                                   int n_rows, const float* __restrict__ p1,
                                   const float* __restrict__ pw, long long BC,
                                   int C, int W, int F, Outs out) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= BC) return;
  const Window w =
      window_of(in, lane, (int)(lane % C), rows, n_rows, p1, pw, W, F);
  out.acc_i[lane] = w.det_i;
  out.acc_q[lane] = w.det_q;
  out.energy[lane] = w.energy;
}

// the counter pair index of a window's AR(1) initial state
constexpr uint32_t AR1_INIT_PAIR = 0xffffffffu;

// one sample pair of a window's z row, (z(2p), z(2p+1)), zero past the
// pairs of the window
template <bool SMEM_Z>
__device__ __forceinline__ float4 z_pair(const Window& w, int c, int p,
                                         int n_pairs, int wh, int n_zrows,
                                         int W, const float4* zs,
                                         const float2* __restrict__ z) {
  if (p >= n_pairs) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (SMEM_Z) return zs[(size_t)(w.zrow - c * n_zrows) * wh + p];
  const float2* zr = z + (size_t)w.zrow * W;
  const float2 z0 = zr[2 * p];
  const float2 z1 = 2 * p + 1 < w.n ? zr[2 * p + 1] : make_float2(0.f, 0.f);
  return make_float4(z0.x, z0.y, z1.x, z1.y);
}

// the AR(1) projection sum_{s<n} n(s) conj(z(s)) of one window, this
// lane's share in (x, y): the warp walks 64 samples per iteration and
// scans the lanes' affine maps (see the header); every lane of the warp
// runs every iteration (the window's n is warp-uniform)
template <bool STREAM, bool SMEM_Z>
__device__ __forceinline__ void ar1_window(
    const Window& w, int c, int b, int B, int C, int W, int wh, int n_zrows,
    int n_pairs, int lane_id, const float4* zs, const float2* __restrict__ z,
    const float* n_i, const float* n_q, const float* __restrict__ noise0,
    float rho, const PhiloxKey& key, uint32_t epoch, float* x, float* y) {
  const unsigned full = 0xffffffffu;
  const float cr = sqrtf(fmaxf(1.0f - rho * rho, 0.0f));
  // every lane's map has the slope rho^2, so after the scan step of
  // offset o a lane l >= o composes with the slope rho^(2o) of a full
  // segment: pw[k] = rho^(2 * 2^k), and the lane's whole prefix has the
  // slope rho^(2(l + 1)); only the intercepts need shuffles
  float pw[6];
  pw[0] = rho * rho;
#pragma unroll
  for (int k = 1; k < 6; ++k) pw[k] = pw[k - 1] * pw[k - 1];
  float a = 1.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    if (((lane_id + 1) >> k) & 1) a *= pw[k];
  float car_i, car_q;        // n at the sample before the iteration's first
  if (STREAM) {
    car_i = noise0[(size_t)c * B + b];
    car_q = noise0[(size_t)(C + c) * B + b];
  } else {
    const uint4 bits = philox(
        make_uint4(AR1_INIT_PAIR, (uint32_t)b, (uint32_t)c, epoch), key);
    const float2 n = box_muller_fast(bits.x, bits.y);
    car_i = n.x;
    car_q = n.y;
  }
  for (int p0 = 0; p0 < n_pairs; p0 += 32) {
    const int p = p0 + lane_id;
    const int s = 2 * p;
    const bool first = s < w.n, second = s + 1 < w.n;
    float2 w0, w1;           // this lane's two whites
    if (STREAM) {
      w0 = first ? make_float2(n_i[s], n_q[s]) : make_float2(0.f, 0.f);
      w1 = second ? make_float2(n_i[s + 1], n_q[s + 1])
                  : make_float2(0.f, 0.f);
    } else {
      const uint4 bits = philox(
          make_uint4((uint32_t)p, (uint32_t)b, (uint32_t)c, epoch), key);
      w0 = box_muller_fast(bits.x, bits.y);
      w1 = box_muller_fast(bits.z, bits.w);
    }
    // the pair's map n_{s-1} -> n_{s+1}, then its inclusive scan
    float bi = cr * fmaf(rho, w0.x, w1.x);
    float bq = cr * fmaf(rho, w0.y, w1.y);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int o = 1 << k;
      const float bip = __shfl_up_sync(full, bi, o);
      const float bqp = __shfl_up_sync(full, bq, o);
      if (lane_id >= o) {
        bi = fmaf(pw[k], bip, bi);
        bq = fmaf(pw[k], bqp, bq);
      }
    }
    const float n1i = fmaf(a, car_i, bi), n1q = fmaf(a, car_q, bq);
    float qi = __shfl_up_sync(full, n1i, 1), qq = __shfl_up_sync(full, n1q, 1);
    if (lane_id == 0) {
      qi = car_i;
      qq = car_q;
    }
    const float n0i = fmaf(rho, qi, cr * w0.x);
    const float n0q = fmaf(rho, qq, cr * w0.y);
    car_i = __shfl_sync(full, n1i, 31);
    car_q = __shfl_sync(full, n1q, 31);
    const float4 zz =
        z_pair<SMEM_Z>(w, c, p, n_pairs, wh, n_zrows, W, zs, z);
    const float2 n0 = first ? make_float2(n0i, n0q) : make_float2(0.f, 0.f);
    const float2 n1 = second ? make_float2(n1i, n1q) : make_float2(0.f, 0.f);
    *x = fmaf(n0.x, zz.x, *x);
    *x = fmaf(n0.y, zz.y, *x);
    *x = fmaf(n1.x, zz.z, *x);
    *x = fmaf(n1.y, zz.w, *x);
    *y = fmaf(n0.y, zz.x, *y);
    *y = fmaf(-n0.x, zz.y, *y);
    *y = fmaf(n1.y, zz.z, *y);
    *y = fmaf(-n1.x, zz.w, *y);
  }
}

// rows mode with noise: one warp per window, its lanes over sample pairs
template <bool STREAM, bool SMEM_Z, bool AR1>
__global__ void __launch_bounds__(THREADS) resolve_rows_noisy(
    Lanes in, const int* __restrict__ rows, int n_rows,
    const float* __restrict__ p1, const float* __restrict__ pw,
    const float2* __restrict__ z, const float* __restrict__ noise,
    const float* __restrict__ noise0, float rho, float sigma, uint32_t k0,
    uint32_t k1, uint32_t epoch, int B, int C, int W, int F, Outs out) {
  extern __shared__ float4 zs[];
  const int c = blockIdx.y;
  const int wh = (W + 1) >> 1;          // pairs per z row
  const int n_zrows = n_rows * F;
  if (SMEM_Z) {
    // this core's z rows as (z(2p), z(2p+1)) pairs, a zero past the end
    const float2* zc = z + (size_t)c * n_zrows * W;
    for (int i = threadIdx.x; i < n_zrows * wh; i += THREADS) {
      const int row = i / wh, s = 2 * (i - row * wh);
      const float2 z0 = zc[(size_t)row * W + s];
      const float2 z1 =
          s + 1 < W ? zc[(size_t)row * W + s + 1] : make_float2(0.f, 0.f);
      zs[i] = make_float4(z0.x, z0.y, z1.x, z1.y);
    }
    __syncthreads();
  }
  const PhiloxKey key = philox_key(k0, k1);
  const int lane_id = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int b = blockIdx.x * WARPS + (threadIdx.x >> 5); b < B; b += stride) {
    const size_t lane = (size_t)b * C + c;
    const Window w = window_of(in, lane, c, rows, n_rows, p1, pw, W, F);
    const int n_pairs = (w.n + 1) >> 1;
    const float* n_i = STREAM ? noise + ((size_t)c * B + b) * W : nullptr;
    const float* n_q = STREAM ? noise + ((size_t)(C + c) * B + b) * W
                              : nullptr;
    float x = 0.0f, y = 0.0f;   // sum nz(s) conj(z(s)), real and imaginary
    if (AR1) {
      ar1_window<STREAM, SMEM_Z>(w, c, b, B, C, W, wh, n_zrows, n_pairs,
                                 lane_id, zs, z, n_i, n_q, noise0, rho, key,
                                 epoch, &x, &y);
    } else {
      for (int p = lane_id; p < n_pairs; p += 32) {
        const int s = 2 * p;
        const bool second = s + 1 < w.n;
        float4 zz;
        if (SMEM_Z) {
          zz = zs[(size_t)(w.zrow - c * n_zrows) * wh + p];
        } else {
          const float2* zr = z + (size_t)w.zrow * W;
          const float2 z0 = zr[s];
          const float2 z1 = second ? zr[s + 1] : make_float2(0.f, 0.f);
          zz = make_float4(z0.x, z0.y, z1.x, z1.y);
        }
        float2 n0, n1;
        if (STREAM) {
          n0 = make_float2(n_i[s], n_q[s]);
          n1 = second ? make_float2(n_i[s + 1], n_q[s + 1])
                      : make_float2(0.f, 0.f);
        } else {
          const uint4 bits =
              philox(make_uint4((uint32_t)p, (uint32_t)b, (uint32_t)c, epoch),
                     key);
          n0 = box_muller_fast(bits.x, bits.y);
          n1 = box_muller_fast(bits.z, bits.w);
          if (!second) n1 = make_float2(0.f, 0.f);
        }
        x = fmaf(n0.x, zz.x, x);
        x = fmaf(n0.y, zz.y, x);
        x = fmaf(n1.x, zz.z, x);
        x = fmaf(n1.y, zz.w, x);
        y = fmaf(n0.y, zz.x, y);
        y = fmaf(-n0.x, zz.y, y);
        y = fmaf(n1.y, zz.z, y);
        y = fmaf(-n1.x, zz.w, y);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, o);
      y += __shfl_xor_sync(0xffffffffu, y, o);
    }
    if (lane_id == 0) {
      // a e^{-iA} (x + i y), the Philox normals scaled by sigma
      const float sc = STREAM ? w.a : w.a * sigma;
      out.acc_i[lane] = w.det_i + sc * (x * w.ca + y * w.sa);
      out.acc_q[lane] = w.det_q + sc * (y * w.ca - x * w.sa);
      out.energy[lane] = w.energy;
    }
  }
}

// full-table mode: the per-sample chain, one thread per window (with
// AR(1), the recursion on each sample's white)
template <bool AR1>
__global__ void resolve_full_table(
    Lanes in, const float* __restrict__ env, const float* __restrict__ bas,
    const int* __restrict__ interps, const float* __restrict__ noise,
    const float* __restrict__ noise0, float rho, float sigma,
    float inv_ring, int ring, uint32_t k0, uint32_t k1, uint32_t epoch,
    int B, int C, int W, int Lp, int F, Outs out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (b >= B) return;
  const size_t lane = (size_t)b * C + c;
  const float a = in.amp[lane], ca = in.cosa[lane], sa = in.sina[lane];
  const float gi = in.gs_i[lane], gq = in.gs_q[lane];
  const int f = in.f_idx[lane];
  const int ns = min(in.nsamp[lane], W);
  const int base = min(max(in.addr[lane], 0), Lp - 1);
  const int it = interps[c];
  const float* e_i = env + (size_t)(2 * c) * Lp;
  const float* e_q = e_i + Lp;
  const float* b_c = bas + ((size_t)(2 * c) * F + f) * W;
  const float* b_s = bas + ((size_t)(2 * c + 1) * F + f) * W;
  const float* n_i = noise ? noise + ((size_t)c * B + b) * W : nullptr;
  const float* n_q = noise ? noise + ((size_t)(C + c) * B + b) * W : nullptr;
  const bool draw = noise == nullptr && sigma != 0.0f;
  const PhiloxKey key = philox_key(k0, k1);

  float ai = 0.0f, aq = 0.0f, en = 0.0f;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
  const float cr = sqrtf(fmaxf(1.0f - rho * rho, 0.0f));
  float ar_i = 0.0f, ar_q = 0.0f;     // AR(1) state, scaled by sigma
  if (AR1) {
    if (noise != nullptr) {
      ar_i = noise0[(size_t)c * B + b];
      ar_q = noise0[(size_t)(C + c) * B + b];
    } else if (draw) {
      const uint4 b0 = philox(
          make_uint4(AR1_INIT_PAIR, (uint32_t)b, (uint32_t)c, epoch), key);
      box_muller(b0.x, b0.y, sigma, &ar_i, &ar_q);
    }
  }
  for (int s = 0; s < ns; ++s) {
    const int k = min(base + s / it, Lp - 1);
    const float ei = e_i[k], eq = e_q[k];
    const float bc = b_c[s], bs = b_s[s];
    const float cth = ca * bc - sa * bs;
    const float sth = sa * bc + ca * bs;
    const float yi = a * (ei * cth - eq * sth);
    const float yq = a * (ei * sth + eq * cth);
    const float w = ring ? 1.0f - expf(-(float)(s + 1) * inv_ring) : 1.0f;
    float nzi = 0.0f, nzq = 0.0f;
    if (n_i != nullptr) {
      nzi = n_i[s];
      nzq = n_q[s];
    } else if (draw) {
      if ((s & 1) == 0)
        bits = philox(
            make_uint4((uint32_t)(s >> 1), (uint32_t)b, (uint32_t)c, epoch),
            key);
      if ((s & 1) == 0)
        box_muller(bits.x, bits.y, sigma, &nzi, &nzq);
      else
        box_muller(bits.z, bits.w, sigma, &nzi, &nzq);
    }
    if (AR1) {
      ar_i = fmaf(rho, ar_i, cr * nzi);
      ar_q = fmaf(rho, ar_q, cr * nzq);
      nzi = ar_i;
      nzq = ar_q;
    }
    const float ri = w * (gi * yi - gq * yq) + nzi;
    const float rq = w * (gi * yq + gq * yi) + nzq;
    ai += ri * yi + rq * yq;
    aq += rq * yi - ri * yq;
    en += yi * yi + yq * yq;
  }
  out.acc_i[lane] = ai;
  out.acc_q[lane] = aq;
  out.energy[lane] = en;
}

template <bool STREAM, bool SMEM_Z, bool AR1>
cudaError_t launch_noisy(const Lanes& in, const int* rows, int n_rows,
                         const float* p1, const float* pw, const float2* z,
                         const float* noise, const float* noise0, float rho,
                         float sigma, uint32_t k0, uint32_t k1,
                         uint32_t epoch, int B, int C, int W, int F,
                         const Outs& out, cudaStream_t stream) {
  auto kernel = resolve_rows_noisy<STREAM, SMEM_Z, AR1>;
  const size_t smem =
      SMEM_Z ? (size_t)n_rows * F * ((W + 1) / 2) * sizeof(float4) : 0;
  cudaError_t rc = cudaSuccess;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  int dev = 0, sms = 0;
  rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  // 64 blocks per SM over all cores, some ten waves of resident blocks,
  // their warps walking the windows: with fewer, the last wave's tail
  // leaves SMs idle; with one block per 8 windows, each block's z copy
  // and start-up cost more than they save
  const int per_core = (B + WARPS - 1) / WARPS;
  const int want = (64 * sms + C - 1) / C;
  const dim3 grid(per_core < want ? per_core : want, C);
  kernel<<<grid, THREADS, smem, stream>>>(in, rows, n_rows, p1, pw, z, noise,
                                          noise0, rho, sigma, k0, k1, epoch,
                                          B, C, W, F, out);
  return cudaGetLastError();
}

template <bool AR1>
cudaError_t launch_rows_noisy(const Lanes& in, const int* rows, int n_rows,
                              const float* p1, const float* pw,
                              const float2* z, const float* noise,
                              const float* noise0, float rho, float sigma,
                              uint32_t k0, uint32_t k1, uint32_t epoch, int B,
                              int C, int W, int F, const Outs& out,
                              cudaStream_t st) {
  const bool smem =
      (size_t)n_rows * F * ((W + 1) / 2) * sizeof(float4) <= MAX_SMEM_Z;
  if (noise != nullptr)
    return smem ? launch_noisy<true, true, AR1>(
                      in, rows, n_rows, p1, pw, z, noise, noise0, rho, sigma,
                      k0, k1, epoch, B, C, W, F, out, st)
                : launch_noisy<true, false, AR1>(
                      in, rows, n_rows, p1, pw, z, noise, noise0, rho, sigma,
                      k0, k1, epoch, B, C, W, F, out, st);
  return smem ? launch_noisy<false, true, AR1>(
                    in, rows, n_rows, p1, pw, z, noise, noise0, rho, sigma,
                    k0, k1, epoch, B, C, W, F, out, st)
              : launch_noisy<false, false, AR1>(
                    in, rows, n_rows, p1, pw, z, noise, noise0, rho, sigma,
                    k0, k1, epoch, B, C, W, F, out, st);
}

}  // namespace

// Launch one epoch's resolve on `stream`.  Lane arrays are [B, C].  Rows
// mode (n_rows > 0): rows holds the n_rows static start addresses; p1/pw
// are [C, n_rows, F, W + 1] prefix sums and z is [C, n_rows, F, W, 2]
// (ops/resolve.py build_prefix_tables); env/bas/interps are not read.
// Full-table mode (n_rows = 0): env is [C, 2, Lp], bas [C, 2, F, W],
// interps [C]; p1/pw/z are not read.  noise is [2, C, B, W] or null.
// rho > 0 colors the noise AR(1); then a streamed noise holds the whites
// and noise0 [2, C, B] the initial states (both scaled by sigma).
// Returns the launch's cudaError as an int (0 = launched).
extern "C" int dp_resolve_windows(
    const float* amp, const float* cosa, const float* sina,
    const float* gs_i, const float* gs_q, const int* f_idx,
    const int* addr, const int* nsamp, const float* env, const float* bas,
    const int* rows, int n_rows, const int* interps, const float* p1,
    const float* pw, const float* z, const float* noise,
    const float* noise0, float rho, float sigma, float inv_ring, int ring,
    unsigned long long seed, int epoch, int B, int C, int W, int Lp, int F,
    float* acc_i, float* acc_q, float* energy, void* stream) {
  if ((long long)B * C == 0) return 0;
  const Lanes in = {amp, cosa, sina, gs_i, gs_q, f_idx, addr, nsamp};
  const Outs out = {acc_i, acc_q, energy};
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  const bool ar1 = rho != 0.0f;
  if (n_rows == 0) {
    const dim3 grid((B + THREADS - 1) / THREADS, C);
    if (ar1)
      resolve_full_table<true><<<grid, THREADS, 0, st>>>(
          in, env, bas, interps, noise, noise0, rho, sigma, inv_ring, ring,
          k0, k1, (uint32_t)epoch, B, C, W, Lp, F, out);
    else
      resolve_full_table<false><<<grid, THREADS, 0, st>>>(
          in, env, bas, interps, noise, noise0, rho, sigma, inv_ring, ring,
          k0, k1, (uint32_t)epoch, B, C, W, Lp, F, out);
    return (int)cudaGetLastError();
  }
  if (noise == nullptr && sigma == 0.0f) {
    const long long BC = (long long)B * C;
    resolve_rows_clean<<<(unsigned)((BC + THREADS - 1) / THREADS), THREADS,
                         0, st>>>(in, rows, n_rows, p1, pw, BC, C, W, F,
                                  out);
    return (int)cudaGetLastError();
  }
  const float2* z2 = reinterpret_cast<const float2*>(z);
  const uint32_t ep = (uint32_t)epoch;
  return (int)(ar1 ? launch_rows_noisy<true>(in, rows, n_rows, p1, pw, z2,
                                             noise, noise0, rho, sigma, k0,
                                             k1, ep, B, C, W, F, out, st)
                   : launch_rows_noisy<false>(in, rows, n_rows, p1, pw, z2,
                                              noise, noise0, rho, sigma, k0,
                                              k1, ep, B, C, W, F, out, st));
}
