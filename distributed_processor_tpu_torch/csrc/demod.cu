// Matched-filter readout demodulation for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_processor_tpu/ops/demod.py
// ::_demod_kernel (launched by demod_iq_pallas).  It computes what that
// kernel computes: acc[s, j] = sum_n adc[s, n] * w[n, j] for adc [S, N]
// and w [N, J] (J = 2M: an I and a Q reference column per measurement),
// float32 with float32 accumulation.  The product is computed here, in
// this kernel's own body: no library routine is called.
//
// Design.  The product is tall and skinny (S ~ 1e5 rows, J ~ 8 columns):
// every adc element is used J times and read once, so device memory binds
// and the kernel is organised around streaming adc.
//   * The weights are staged in shared memory, column-major [JT][NT] (JT
//     columns per pass, NT samples per tile), zero-filled past N and J.
//     One tile holds TILE_FLOATS floats = 32 KB, under the 48 KB a block
//     may hold without opting in: NT = 1024 at JT = 8.  A problem with
//     N <= NT and J <= JT loads its weights once per block; a longer
//     window (N * min(J, 8) * 4 bytes > 32 KB, so N > 1024 at J = 8) is
//     tiled over N, and a wider one (J > 8) makes further passes over adc,
//     both inside this one launch.
//   * A warp owns ROWS shot rows at a time.  Each lane reads 16 bytes of
//     every row per step (float4, neighbouring lanes on neighbouring
//     addresses: 512 contiguous bytes per row), reads the matching float4
//     of each weight column from shared memory (conflict-free), and keeps
//     ROWS x JT partial sums in registers; the weights read from shared
//     memory serve all ROWS rows.  A shuffle reduction over the warp ends
//     the row group and lane 0 writes its J sums.
//   * Blocks are persistent: the grid is a few blocks per SM and each
//     block strides over the row groups, so the weights are staged once
//     per block, not once per row group.  The TPU kernel's row padding to
//     a multiple of the shot block is not carried over: the ragged last
//     group is masked.
// A row start that is not 16-byte aligned (N not a multiple of 4, or an
// unaligned base) takes the same code with scalar loads.
//
// Bound on this card.  Bytes: (S * N + N * J + S * J) * 4; at S = 262144,
// N = 1024, J = 8 that is 1.08 GB, 0.32 ms at 3.35 TB/s.  Operations:
// 2 * S * N * J = 4.3 GFLOP, 0.064 ms at 67 TFLOP/s.  Bytes bind.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_FLOATS = 8192;  // 32 KB of staged weights
constexpr int THREADS = 256;
constexpr int ROWS = 4;            // shot rows a warp carries together
constexpr int BLOCKS_PER_SM = 4;

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        int remaining) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (remaining > 0) v.x = __ldg(p);
  if (remaining > 1) v.y = __ldg(p + 1);
  if (remaining > 2) v.z = __ldg(p + 2);
  if (remaining > 3) v.w = __ldg(p + 3);
  return v;
}

// adc [S, N], w [N, J], out [S, J]; NT = samples per staged tile (a
// multiple of 128), ws = [JT][NT] floats of dynamic shared memory.
template <int JT, bool VEC>
__global__ void demod_kernel(const float* __restrict__ adc,
                             const float* __restrict__ w,
                             float* __restrict__ out, int S, int N, int J,
                             int NT) {
  extern __shared__ float4 ws4[];
  float* ws = reinterpret_cast<float*>(ws4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int n_tiles = (N + NT - 1) / NT;
  const long long groups = ((long long)S + ROWS - 1) / ROWS;
  const long long group_blocks = (groups + warps - 1) / warps;

  for (int j0 = 0; j0 < J; j0 += JT) {
    // every warp of a block makes the same trips, so the barriers below
    // are reached by all of them
    for (long long gb = blockIdx.x; gb < group_blocks; gb += gridDim.x) {
      const long long row0 = (gb * warps + warp) * ROWS;
      float acc[ROWS][JT];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < JT; ++j) acc[r][j] = 0.0f;

      for (int t = 0; t < n_tiles; ++t) {
        const int nbase = t * NT;
        if (n_tiles > 1 || gb == blockIdx.x) {
          __syncthreads();  // the previous tile's readers are done
          for (int i = threadIdx.x; i < JT * NT; i += blockDim.x) {
            const int j = i / NT, n = i - j * NT;
            ws[i] = (nbase + n < N && j0 + j < J)
                        ? __ldg(w + (size_t)(nbase + n) * J + j0 + j)
                        : 0.0f;
          }
          __syncthreads();
        }
        const int n_lim = min(NT, N - nbase);
        for (int n = lane * 4; n < n_lim; n += 128) {
          float4 a[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            a[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (row0 + r < S)
              a[r] = load4<VEC>(adc + (size_t)(row0 + r) * N + nbase + n,
                                n_lim - n);
          }
#pragma unroll
          for (int j = 0; j < JT; ++j) {
            const float4 wv = ws4[(j * NT + n) >> 2];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              acc[r][j] = fmaf(a[r].x, wv.x, acc[r][j]);
              acc[r][j] = fmaf(a[r].y, wv.y, acc[r][j]);
              acc[r][j] = fmaf(a[r].z, wv.z, acc[r][j]);
              acc[r][j] = fmaf(a[r].w, wv.w, acc[r][j]);
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          float v = acc[r][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          acc[r][j] = v;
        }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (row0 + r < S) {
#pragma unroll
            for (int j = 0; j < JT; ++j)
              if (j0 + j < J) out[(size_t)(row0 + r) * J + j0 + j] = acc[r][j];
          }
      }
    }
  }
}

template <int JT>
int launch(const float* adc, const float* w, float* out, int S, int N, int J,
           int sms, cudaStream_t stream) {
  // samples per staged tile: what 32 KB hold at JT columns, a multiple of
  // 128, and no more than the window needs
  int NT = TILE_FLOATS / JT;
  const int n_pad = (N + 127) / 128 * 128;
  if (n_pad < NT) NT = n_pad;
  const int warps = THREADS / 32;
  const long long groups = ((long long)S + ROWS - 1) / ROWS;
  const long long group_blocks = (groups + warps - 1) / warps;
  long long blocks = (long long)sms * BLOCKS_PER_SM;
  if (group_blocks < blocks) blocks = group_blocks;
  const size_t smem = (size_t)JT * NT * sizeof(float);
  const bool vec = (N % 4 == 0) && ((uintptr_t)adc % 16 == 0);
  if (vec)
    demod_kernel<JT, true><<<(int)blocks, THREADS, smem, stream>>>(
        adc, w, out, S, N, J, NT);
  else
    demod_kernel<JT, false><<<(int)blocks, THREADS, smem, stream>>>(
        adc, w, out, S, N, J, NT);
  return (int)cudaGetLastError();
}

}  // namespace

// acc = adc @ w on `stream`: adc [S, N], w [N, J], out [S, J], float32,
// contiguous, S, N, J >= 1.  One launch.  Returns the launch's
// cudaGetLastError() (or the error of the device query) as an int
// (0 = launched).
extern "C" int dp_demod_iq(const float* adc, const float* w, float* out,
                           int S, int N, int J, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (J <= 2) return launch<2>(adc, w, out, S, N, J, sms, st);
  if (J <= 4) return launch<4>(adc, w, out, S, N, J, sms, st);
  return launch<8>(adc, w, out, S, N, J, sms, st);
}
