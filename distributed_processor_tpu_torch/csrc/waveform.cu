// Element waveform synthesis for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_processor_tpu/ops/waveform_pallas.py
// ::_kernel (launched by _synthesize_call, entry synthesize_element_pallas).
// For every output sample n of one element's trace [n_samples, 2] it
// computes what that kernel computes: the sum over the element's pulses p
// with start_p <= n < end_p of amp_p * env_p(n) * exp(i * theta_p(n)),
//   theta  = int32(inc_p * n + phase0_p) * 2 * pi / 2^32   (wrapping 32-bit
//            NCO accumulator: exact phase however long the trace),
//   amp    = amp_word / 65535,
//   env(n) = table[clamp(env_addr * interp + (n - start), 0,
//                        L * interp - 1) / interp]         (hold-last-sample
//            past the table's end), and for a continuous-wave pulse the
//            sample at env_addr throughout.
//
// Design.  One thread owns one output sample and loops over the element's
// pulse descriptors, staged through shared memory DESC_CHUNK at a time
// (seven int32 each: start, end, env_addr, inc, phase0, amp word, is_cw).
// The envelope is read straight from the raw [L, 2] table with a divide
// and a clamp per sample: a per-thread gather is cheap on this card, so
// the TPU kernel's interp-expanded table, its one-block padding on both
// sides, its block-long constant segment per CW pulse, its scalar-offset
// slice and the block-multiple trace length are not carried over — any
// n_samples is served.  Neighbouring threads hold neighbouring samples, so
// the window test is uniform across nearly every warp, the envelope reads
// of a warp fall in one or two sectors, and the float2 stores coalesce.
//
// Bound on this card.  Each sample is written once (8 bytes) and, inside
// a pulse, costs one NCO evaluation (a multiply-add, a convert, a sincos:
// ~40 float32 operations) — pulses on one element do not overlap.  At
// 1,048,576 samples that is 8.4 MB, 2.5 microseconds at 3.35 TB/s, and
// at most 0.6 microseconds of operations at 67 TFLOP/s: bytes bind, and
// both are below what a launch itself costs.  The descriptor loop adds
// P window tests per sample.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DESC_FIELDS = 7;
constexpr int DESC_CHUNK = 256;
constexpr int THREADS = 256;

__global__ void synthesize_kernel(const int* __restrict__ desc, int P,
                                  const float2* __restrict__ env, int L,
                                  int interp, int n_samples,
                                  float2* __restrict__ out) {
  __shared__ int sd[DESC_FIELDS][DESC_CHUNK];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const long long k_max = (long long)L * interp - 1;
  float acc_i = 0.0f, acc_q = 0.0f;
  for (int p0 = 0; p0 < P; p0 += DESC_CHUNK) {
    const int cnt = min(DESC_CHUNK, P - p0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < DESC_FIELDS * cnt; i += blockDim.x) {
      const int f = i / cnt, p = i - f * cnt;
      sd[f][p] = desc[(size_t)f * P + p0 + p];
    }
    __syncthreads();
    if (n >= n_samples) continue;
    for (int p = 0; p < cnt; ++p) {
      const int start = sd[0][p];
      if (n < start || n >= sd[1][p]) continue;
      long long k = (long long)sd[2][p] * interp;
      if (!sd[6][p]) k += n - start;
      k = min(max(k, 0ll), k_max);
      const float2 ev = env[k / interp];
      // the 32-bit accumulator wraps in uint32 (signed overflow is
      // undefined); its int32 reading spans [-pi, pi)
      const uint32_t pa =
          (uint32_t)sd[3][p] * (uint32_t)n + (uint32_t)sd[4][p];
      const float theta = (float)(int32_t)pa * 1.4629180792671596e-9f;
      float sn, cs;
      sincosf(theta, &sn, &cs);
      const float amp = (float)sd[5][p] / 65535.0f;
      acc_i += amp * (ev.x * cs - ev.y * sn);
      acc_q += amp * (ev.x * sn + ev.y * cs);
    }
  }
  if (n < n_samples) out[n] = make_float2(acc_i, acc_q);
}

}  // namespace

// Render one element's trace on `stream`.  desc is the int32 descriptor
// table [7, P] (rows: start, end, env_addr, inc, phase0, amp word, is_cw;
// inc and phase0 are uint32 bit patterns), env the [L, 2] float32 table
// with L >= 1, out [n_samples, 2] float32.  Returns the launch's
// cudaGetLastError() as an int (0 = launched).
extern "C" int dp_synthesize_element(const int* desc, int P, const float* env,
                                     int L, int interp, int n_samples,
                                     float* out, void* stream) {
  const int blocks = (n_samples + THREADS - 1) / THREADS;
  synthesize_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      desc, P, reinterpret_cast<const float2*>(env), L, interp, n_samples,
      reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}
