// Waveform synthesis for Hopper (sm_90a): every (core, element) trace of
// one shot in one launch.
//
// Replaces the TPU kernel distributed_processor_tpu/ops/waveform_pallas.py
// ::_kernel (launched by _synthesize_call, entry synthesize_element_pallas),
// which renders one element per call from a host-built descriptor table.
// For every output sample n of a trace [n_samples, 2] it computes what that
// kernel computes: the sum over the element's pulses p with
// start_p <= n < end_p of amp_p * env_p(n) * exp(i * theta_p(n)),
//   theta  = int32(inc_p * n + phase0_p) * 2 * pi / 2^32   (wrapping 32-bit
//            NCO accumulator: exact phase however long the trace),
//   amp    = amp_word / 65535,
//   env(n) = table[clamp(env_addr * interp + (n - start), 0,
//                        L * interp - 1) / interp]         (hold-last-sample
//            past the table's end), and for a continuous-wave pulse the
//            sample at env_addr throughout.
//
// Design.  The grid is (sample tiles, traces): a block renders TILE
// consecutive samples of one trace, whose geometry, envelope and NCO
// words it reads from the per-program render table (rows of
// TRACE_FIELDS); the trace's output begins n_clks * out_spc samples into
// the one output buffer.  The block reads its core's pulse records for
// the shot straight from the run's record tensors (one int32 row per
// field, `rows` apart per core) and derives the pulse descriptors there:
// start = gtime * spc and the end in 64 bits, wrapped to 32 as the host
// reference does; a continuous-wave pulse ends at the next start on the
// element in stable start order (a warp scans the rows for it).  It keeps
// only the element's pulses that reach its tile, at most CAP at a time in
// shared memory, sorts them by start and takes the running maximum of
// their ends.  Each pass of THREADS samples then visits only the pulses
// [lo, hi) that can reach it: hi counts the starts before the pass's end,
// lo skips the pulses whose running end lies before its start.  Pulses of
// one element do not overlap, so that is about one per pass.  Every
// thread holds PER_THREAD samples THREADS apart, so stores are coalesced
// float2 and the per-pass pulse range is uniform across the block.  Index
// arithmetic is 32-bit: the envelope index is addr + (n - start) / interp,
// a shift for the power-of-two ratios the channel maps configure, clamped
// to L - 1 without forming the 64-bit product.
//
// Bound on this card.  Each sample is written once (8 bytes); each pulse
// record field is read once per block that needs it (from L2 after the
// first); inside a pulse a sample costs one NCO evaluation (a multiply-add,
// a convert, a sincos, the complex product: ~40 float32 operations).  A
// headline render (24 traces, ~250k samples) moves ~2 MB: under a
// microsecond at 3.35 TB/s, below what a launch costs.  At 1,048,576
// samples bytes bind: 8.4 MB, 2.5 microseconds.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;   // ops/waveform.py RENDER_TILE
constexpr int CAP = 256;                     // pulses staged at once, >= THREADS
constexpr unsigned FULL = 0xffffffffu;

// columns of a render-table row (ops/waveform.py _TRACE_FIELDS)
enum { T_CORE, T_ELEM, T_SPC, T_INTERP, T_SHIFT, T_ENV_OFF, T_ENV_LEN,
       T_INC_OFF, T_N_INC, T_OUT_SPC, TRACE_FIELDS };

constexpr int ENV_CW_SENTINEL = 0xfff;

struct Records {
  const int* gtime;
  const int* env;
  const int* phase;
  const int* amp;
  const int* elem;
  const int* freq;
  const int* n_pulses;
  int rows;
};

// The staged pulses of one pass: appended unsorted, then scattered into
// start order (q_*), with the running maximum of their ends.
struct Stage {
  int cnt;
  int start[CAP], end[CAP], addr[CAP], row[CAP];
  unsigned inc[CAP], ph0[CAP];
  float amp[CAP];
  int cw[CAP];
  int q_start[CAP], q_end[CAP], q_pmax[CAP], q_addr[CAP], q_cw[CAP];
  unsigned q_inc[CAP], q_ph0[CAP];
  float q_amp[CAP];
};

__device__ __forceinline__ int wrap32(long long x) {
  return (int)(unsigned)(unsigned long long)x;
}

// Render the staged pulses into the block's accumulators and empty the
// stage.  Called by every thread of the block; inlined, so that the
// accumulators stay in registers.
__device__ __forceinline__ void flush(Stage& s, const Records& rec, int core,
                                      int elem, int spc, int interp,
                                      int shift, int n_valid, int n_t,
                                      const float2* __restrict__ env, int L,
                                      int lo_tile, float* acc_i,
                                      float* acc_q) {
  __syncthreads();
  const int k = s.cnt;
  if (k == 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* gtime = rec.gtime + (size_t)core * rec.rows;
  const int* relem = rec.elem + (size_t)core * rec.rows;
  // continuous-wave ends: the least start after this pulse's in (start,
  // row) order among the element's valid pulses, else the trace's end
  for (int i = warp; i < k; i += WARPS) {
    if (!s.cw[i]) continue;
    const int p = s.row[i];
    const long long sp = (long long)gtime[p] * spc;
    long long best = n_t;
    for (int q = lane; q < n_valid; q += 32) {
      if (relem[q] != elem) continue;
      const long long sq = (long long)gtime[q] * spc;
      if (sq > sp || (sq == sp && q > p)) best = min(best, sq);
    }
    for (int o = 16; o > 0; o >>= 1)
      best = min(best, __shfl_xor_sync(FULL, best, o));
    if (lane == 0) s.end[i] = wrap32(best);
  }
  __syncthreads();
  // sort by (start, row): each pulse's rank is the number of keys below it
  for (int i = tid; i < k; i += THREADS) {
    const int si = s.start[i], ri = s.row[i];
    int r = 0;
    for (int j = 0; j < k; ++j) {
      const int sj = s.start[j];
      r += (sj < si) || (sj == si && s.row[j] < ri);
    }
    s.q_start[r] = si;
    s.q_end[r] = s.end[i];
    s.q_addr[r] = s.addr[i];
    s.q_cw[r] = s.cw[i];
    s.q_inc[r] = s.inc[i];
    s.q_ph0[r] = s.ph0[i];
    s.q_amp[r] = s.amp[i];
  }
  __syncthreads();
  if (warp == 0) {
    int carry = INT_MIN;
    for (int b = 0; b < k; b += 32) {
      int v = b + lane < k ? s.q_end[b + lane] : INT_MIN;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v = max(v, u);
      }
      v = max(v, carry);
      if (b + lane < k) s.q_pmax[b + lane] = v;
      carry = __shfl_sync(FULL, v, 31);
    }
  }
  __syncthreads();
  int lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int a = lo_tile + j * THREADS;
    while (lo < k && s.q_pmax[lo] <= a) ++lo;
    while (hi < k && s.q_start[hi] < a + THREADS) ++hi;
    const int n = a + tid;
    for (int i = lo; i < hi; ++i) {
      const int st = s.q_start[i];
      if (n < st || n >= s.q_end[i]) continue;
      // n - start in [0, 2^32): exact in 32 unsigned bits
      const unsigned off = (unsigned)n - (unsigned)st;
      const unsigned q = s.q_cw[i] ? 0u
                         : shift >= 0 ? off >> shift : off / (unsigned)interp;
      const int addr = s.q_addr[i];
      const int idx = (addr >= L - 1 || q >= (unsigned)(L - 1 - addr))
                          ? L - 1 : addr + (int)q;
      const float2 ev = env[idx];
      // the 32-bit accumulator wraps in uint32 (signed overflow is
      // undefined); its int32 reading spans [-pi, pi)
      const unsigned pa = s.q_inc[i] * (unsigned)n + s.q_ph0[i];
      const float theta = (float)(int)pa * 1.4629180792671596e-9f;
      float sn, cs;
      sincosf(theta, &sn, &cs);
      const float amp = s.q_amp[i];
      acc_i[j] += amp * (ev.x * cs - ev.y * sn);
      acc_q[j] += amp * (ev.x * sn + ev.y * cs);
    }
  }
  __syncthreads();
  if (tid == 0) s.cnt = 0;
}

__global__ void __launch_bounds__(THREADS)
render_kernel(Records rec, const int* __restrict__ traces,
              const float2* __restrict__ env_tab,
              const unsigned* __restrict__ inc_tab, int n_clks,
              float2* __restrict__ out) {
  __shared__ Stage s;
  const int* tr = traces + blockIdx.y * TRACE_FIELDS;
  const int spc = tr[T_SPC];
  const int n_t = n_clks * spc;
  const int lo_tile = blockIdx.x * TILE;
  if (lo_tile >= n_t) return;                 // a shorter trace's tail
  const int core = tr[T_CORE], elem = tr[T_ELEM], interp = tr[T_INTERP];
  const int shift = tr[T_SHIFT], L = tr[T_ENV_LEN], n_inc = tr[T_N_INC];
  const float2* env = env_tab + tr[T_ENV_OFF];
  const unsigned* inc = inc_tab + tr[T_INC_OFF];
  const int hi_tile = min(lo_tile + TILE, n_t);
  const size_t base = (size_t)core * rec.rows;
  const int n_valid = max(0, min(rec.n_pulses[core], rec.rows));
  const int tid = threadIdx.x;
  float acc_i[PER_THREAD], acc_q[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) acc_i[j] = acc_q[j] = 0.0f;
  if (tid == 0) s.cnt = 0;
  __syncthreads();
  for (int r0 = 0; r0 < n_valid; r0 += THREADS) {
    const int p = r0 + tid;
    bool take = false;
    int start = 0, end = 0, env_word = 0;
    bool cw = false;
    if (p < n_valid && rec.elem[base + p] == elem) {
      const long long s64 = (long long)rec.gtime[base + p] * spc;
      env_word = rec.env[base + p];
      const int nw = (env_word >> 12) & 0xfff;
      cw = nw == ENV_CW_SENTINEL;
      start = wrap32(s64);
      if (cw) {
        take = start < hi_tile;               // its end is found in flush
      } else {
        end = wrap32(s64 + (long long)nw * 4 * interp);
        take = start < hi_tile && end > lo_tile && start < end;
      }
    }
    const int n_take = __syncthreads_count(take);
    if (s.cnt + n_take > CAP)
      flush(s, rec, core, elem, spc, interp, shift, n_valid, n_t, env, L,
            lo_tile, acc_i, acc_q);
    __syncthreads();
    if (take) {
      const int slot = atomicAdd(&s.cnt, 1);
      const int f = min(max(rec.freq[base + p], 0), n_inc);
      s.start[slot] = start;
      s.end[slot] = end;
      s.addr[slot] = (env_word & 0xfff) * 4;
      s.row[slot] = p;
      s.cw[slot] = cw;
      s.inc[slot] = inc[f];
      s.ph0[slot] = (unsigned)rec.phase[base + p] << 15;
      s.amp[slot] = (float)rec.amp[base + p] / 65535.0f;
    }
    __syncthreads();
  }
  flush(s, rec, core, elem, spc, interp, shift, n_valid, n_t, env, L,
        lo_tile, acc_i, acc_q);
  float2* o = out + (size_t)n_clks * tr[T_OUT_SPC];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int n = lo_tile + j * THREADS + tid;
    if (n < hi_tile) o[n] = make_float2(acc_i[j], acc_q[j]);
  }
}

}  // namespace

// Render every trace of a render table from one shot's records on
// `stream`.  gtime .. freq: the shot's int32 record fields, [C, rows]
// each, row-major; n_pulses: int32 [C]; traces: the table's rows
// [n_traces, TRACE_FIELDS]; env_tab: float32 [*, 2]; inc_tab: the NCO
// words (uint32 bit patterns); out: float32 [n_clks * sum(spc), 2].
// spc_max is the largest spc of the table: the grid's width in tiles.
// Returns the launch's cudaGetLastError() as an int (0 = launched).
extern "C" int dp_render_shot(const int* gtime, const int* env,
                              const int* phase, const int* amp,
                              const int* elem, const int* freq,
                              const int* n_pulses, int rows,
                              const int* traces, int n_traces,
                              const float* env_tab, const int* inc_tab,
                              int n_clks, int spc_max, float* out,
                              void* stream) {
  const Records rec{gtime, env, phase, amp, elem, freq, n_pulses, rows};
  const long long width = (long long)n_clks * spc_max;
  const dim3 grid((unsigned)((width + TILE - 1) / TILE), (unsigned)n_traces);
  render_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rec, traces, reinterpret_cast<const float2*>(env_tab),
      reinterpret_cast<const unsigned*>(inc_tab), n_clks,
      reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}
