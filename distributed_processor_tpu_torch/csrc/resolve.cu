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
// Design.  One thread owns one (shot, core) window and loops over its
// samples s < min(nsamp, W), so a whole epoch is ONE launch: the loop
// replaces the TPU's sequential grid over sample chunks, and samples past
// nsamp (exact zeros in the TPU kernel) are never visited.  Threads of a
// block share the core (blockIdx.y), so the per-core envelope and carrier
// basis rows they read are the same addresses across the warp (broadcast
// loads from L1).  The envelope sample is a direct read of the per-core
// plane at min(base + s / interp, Lp - 1): `base` is the window's start
// row, picked from the static row list by address equality (the TPU
// kernel's row select, default row 0) or, without a row list, the clipped
// address.  No one-hot product: a per-thread read is cheap on this card.
//
// Noise.  By default Philox4x32-10 in the kernel: key = the 64-bit seed,
// counter = (sample pair, shot, core, epoch); each call feeds two samples'
// Box-Muller pairs, u1 = ((bits >> 8) + 1) * 2^-24 in (0, 1] and
// u2 = (bits >> 8) * 2^-24 in [0, 1), shifts logical on uint32.  The noise
// never touches device memory.  With `noise` given, it is read from a
// streamed [2, C, B, W] float32 array instead (already scaled by sigma),
// so the kernel and the plain torch version can see identical noise.
//
// Bound on this card.  Device memory sees ~10 scalars in and 3 out per
// window, and the small per-core tables: ~0.1 GB per epoch at B = 262144,
// C = 8, tens of microseconds at 3.35 TB/s.  Per sample the kernel does
// ~36 float32 operations for the chain plus, with noise, a log, a sqrt, a
// sincos and ~10 more float32 operations, and half a Philox call (~25
// integer multiply/xor operations).  So it is bound by operations: at
// W = 1024 an epoch is 2.1e9 samples, about a millisecond and a half at
// the 67 TFLOP/s float32 peak.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0,
                                               uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return ctr;
}

// one N(0, sigma^2) I/Q pair from two uniform words (Box-Muller)
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

__global__ void resolve_kernel(
    const float* __restrict__ amp, const float* __restrict__ cosa,
    const float* __restrict__ sina, const float* __restrict__ gs_i,
    const float* __restrict__ gs_q, const int* __restrict__ f_idx,
    const int* __restrict__ addr, const int* __restrict__ nsamp,
    const float* __restrict__ env, const float* __restrict__ bas,
    const int* __restrict__ rows, int n_rows,
    const int* __restrict__ interps, const float* __restrict__ noise,
    float sigma, float inv_ring, int ring, uint32_t k0, uint32_t k1,
    uint32_t epoch, int B, int C, int W, int Lp, int F,
    float* __restrict__ acc_i, float* __restrict__ acc_q,
    float* __restrict__ energy) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (b >= B) return;
  const size_t lane = (size_t)b * C + c;
  const float a = amp[lane], ca = cosa[lane], sa = sina[lane];
  const float gi = gs_i[lane], gq = gs_q[lane];
  const int f = f_idx[lane];
  const int ns = min(nsamp[lane], W);
  int base;
  if (n_rows > 0) {
    const int ad = addr[lane];
    base = rows[0];
    for (int r = 1; r < n_rows; ++r)
      if (ad == rows[r]) base = rows[r];
  } else {
    base = min(max(addr[lane], 0), Lp - 1);
  }
  const int it = interps[c];
  const float* e_i = env + (size_t)(2 * c) * Lp;
  const float* e_q = e_i + Lp;
  const float* b_c = bas + ((size_t)(2 * c) * F + f) * W;
  const float* b_s = bas + ((size_t)(2 * c + 1) * F + f) * W;
  const float* n_i = noise ? noise + ((size_t)c * B + b) * W : nullptr;
  const float* n_q = noise ? noise + ((size_t)(C + c) * B + b) * W : nullptr;
  const bool draw = noise == nullptr && sigma != 0.0f;

  float ai = 0.0f, aq = 0.0f, en = 0.0f;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
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
        bits = philox4x32_10(
            make_uint4((uint32_t)(s >> 1), (uint32_t)b, (uint32_t)c, epoch),
            k0, k1);
      if ((s & 1) == 0)
        box_muller(bits.x, bits.y, sigma, &nzi, &nzq);
      else
        box_muller(bits.z, bits.w, sigma, &nzi, &nzq);
    }
    const float ri = w * (gi * yi - gq * yq) + nzi;
    const float rq = w * (gi * yq + gq * yi) + nzq;
    ai += ri * yi + rq * yq;
    aq += rq * yi - ri * yq;
    en += yi * yi + yq * yq;
  }
  acc_i[lane] = ai;
  acc_q[lane] = aq;
  energy[lane] = en;
}

}  // namespace

// Launch one epoch's resolve on `stream`.  Lane arrays are [B, C]; env is
// [C, 2, Lp]; bas is [C, 2, F, W]; rows holds n_rows start addresses (0 =
// full-table mode); noise is [2, C, B, W] or null.  Returns the launch's
// cudaGetLastError() as an int (0 = launched).
extern "C" int dp_resolve_windows(
    const float* amp, const float* cosa, const float* sina,
    const float* gs_i, const float* gs_q, const int* f_idx,
    const int* addr, const int* nsamp, const float* env, const float* bas,
    const int* rows, int n_rows, const int* interps, const float* noise,
    float sigma, float inv_ring, int ring, unsigned long long seed,
    int epoch, int B, int C, int W, int Lp, int F, float* acc_i,
    float* acc_q, float* energy, void* stream) {
  const int threads = 256;
  const dim3 grid((B + threads - 1) / threads, C);
  resolve_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      amp, cosa, sina, gs_i, gs_q, f_idx, addr, nsamp, env, bas, rows,
      n_rows, interps, noise, sigma, inv_ring, ring,
      (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
      (uint32_t)epoch, B, C, W, Lp, F, acc_i, acc_q, energy);
  return (int)cudaGetLastError();
}
