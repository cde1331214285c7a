// Straight-line span executor for Hopper (sm_90a): the kernels K1 and K3.
//
// Replaces the TPU megastep kernel distributed_processor_tpu/ops/
// exec_pallas.py::_span_call_raw (its pallas_call at :349) in span mode,
// with either of its two bodies:
//   K1  interpreter._exec_span_pallas: a whole forward-jump-only program
//       over every (shot, core) lane, measurement bits injected and valid;
//   K3  interpreter._exec_span_pallas_fused: the same in physics mode on
//       the parity device, each measurement window resolved at its trigger
//       with the sigma = 0 readout (_fused_window_energy +
//       _fused_discriminate), so the epoch loop runs once.
// The semantics are those of interpreter._sl_apply_instr, whose port is the
// plain version (distributed_processor_tpu_torch/sim/interpreter.py).
//
// Design.  In span mode the cores of a shot are independent: no SYNC, and
// an fproc read sees only the core's own sticky channel.  So one thread
// owns one (shot, core) lane and walks its program with the lane's state in
// registers (regs[16] and pp[5] in a thread-local array).  The program is
// data, not traced code: the [C, N, 18] int32 field table sits in shared
// memory (21 KB at the 8-core, 37-instruction headline; read from global
// memory when it exceeds MAX_SMEM_PROG).  A lane executes index i iff
// pc == i, and jumps only go forward, so the thread jumps straight from
// index to index along its pc; it stops at DONE, at a pc past the program,
// at a pc that does not move forward (the TPU kernel's ascending index loop
// would never revisit it), or at an fproc read whose bit is not valid yet
// (K3: phys_wait).  Arrays that instructions update by slot (rst_time,
// meas_avail, the pulse records, the opcode histogram, the measurement
// planes) are copied in -> out once per lane and updated in global memory.
// The TPU kernel's shot tiles, row-replication padding and constant
// lifting have no counterpart.
//
// Integers.  Every add and subtract that the JAX engine lets wrap in int32
// is done in uint32 (signed overflow is undefined in C++); cmd_time holds
// uint32 bit patterns.  `le` is strict signed less-than.  The two divisions
// (pulse duration, parity step) use C's truncating `/` where the plain
// version floors: the wrapper holds their operands non-negative.
//
// Readout (K3).  At sigma = 0 a window's matched-filter sums are g_s * E
// with E = amp^2 * sum_{s < count} |env|^2 >= 0, so the bit is the sign of
// a projection that depends only on which response scaled E: the kernel
// sums the energy row in its own order and only the bit leaves it.  The
// projection is computed with the plain version's float32 operations one
// by one (no contraction into FMAs).
//
// Bound on this card.  Each lane reads its carry once and writes it once:
// at the headline (B = 262144, C = 8, max_meas = max_resets = 2, no pulse
// records) that is ~280 bytes per lane, ~0.6 GB per launch, ~0.18 ms at
// 3.35 TB/s; the integer work per retired instruction is a few dozen
// operations and does not bind.  K3 adds one pass over an energy row per
// measurement (count float32 adds, ~1024 at the headline), read from
// L1/L2, not counted as device-memory bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// instruction kinds (isa.py)
enum Kind {
  K_PULSE_WRITE = 0, K_PULSE_TRIG = 1, K_REG_ALU = 2, K_JUMP_I = 3,
  K_JUMP_COND = 4, K_ALU_FPROC = 5, K_JUMP_FPROC = 6, K_INC_QCLK = 7,
  K_SYNC = 8, K_DONE = 9, K_PULSE_RESET = 10, K_IDLE = 11, N_KINDS = 12
};

// columns of the [C, N, N_FIELDS] program table (interpreter._FIELDS)
enum Field {
  F_KIND, F_ALU_OP, F_IN0_IS_REG, F_IMM, F_IN0_REG, F_IN1_REG, F_OUT_REG,
  F_JUMP_ADDR, F_FUNC_ID, F_CMD_TIME, F_P_ENV, F_P_PHASE, F_P_FREQ, F_P_AMP,
  F_P_CFG, F_P_WEN, F_P_REGSEL, F_P_REG, N_FIELDS
};

// state leaves (ops/exec_span.py LEAVES); int32 except the bool leaves
// L_DONE, L_MEAS_VALID and L_PHYS_WAIT (one byte each)
enum Leaf {
  L_PC, L_REGS, L_TIME, L_OFFSET, L_DONE, L_ERR, L_FAULT, L_PP, L_N_PULSES,
  L_N_RESETS, L_RST_TIME, L_N_MEAS, L_MEAS_AVAIL, L_REC, L_OP_HIST,
  L_MEAS_STATE, L_MEAS_AMP, L_MEAS_PHASE, L_MEAS_FREQ, L_MEAS_ENV,
  L_MEAS_GTIME, L_QTURNS, L_MEAS_BITS, L_MEAS_VALID, L_PHYS_WAIT, N_LEAVES
};

// scalar parameters (ops/exec_span.py PARAMS)
enum Param {
  P_B, P_C, P_N, P_M, P_R, P_P, P_E, P_MEAS_ELEM, P_MEAS_LATENCY,
  P_ALU_CLKS, P_JCOND_CLKS, P_JFPROC_CLKS, P_REGWRITE_CLKS, P_LOAD_CLKS,
  P_X90_AMP, P_DRIVE_ELEM, P_N_ADDRS, P_W, P_WP, N_PARAMS
};

constexpr int N_REGS = 16, N_PP = 5, N_REC = 9;
constexpr int STICKY_RACE_MARGIN = 2;
constexpr int ERR_MISSED_TRIG = 1, ERR_PULSE_OVERFLOW = 2,
              ERR_MEAS_OVERFLOW = 4, ERR_STICKY_RACE = 64, ERR_CW_MEAS = 128;
constexpr int FAULT_PULSE_OVERFLOW = 8, FAULT_MEAS_OVERFLOW = 16,
              FAULT_RESET_OVERFLOW = 32, FAULT_ILLEGAL_OP = 64,
              FAULT_JUMP_OOB = 128;
constexpr size_t MAX_SMEM_PROG = 200 * 1024;
constexpr int THREADS = 256;

struct Leaves {
  const void* in[N_LEAVES];
  void* out[N_LEAVES];
};

struct Params {
  int v[N_PARAMS];
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

// the 8-op ALU (hdl/alu.v); `le` (op 4) is strict signed less-than
__device__ __forceinline__ int alu(int op, int a, int b) {
  switch (op) {
    case 0: return a;
    case 1: return wadd(a, b);
    case 2: return wsub(a, b);
    case 3: return a == b;
    case 4: return a < b;
    case 5: return a >= b;
    case 6: return b;
    default: return 0;
  }
}

// a register address outside the file reads 0 (the plain version's
// one-hot select)
__device__ __forceinline__ int reg_read(const int* regs, int a) {
  return (a >= 0 && a < N_REGS) ? regs[a] : 0;
}

__device__ __forceinline__ const int* in_i(const Leaves& lv, int leaf) {
  return static_cast<const int*>(lv.in[leaf]);
}

__device__ __forceinline__ int* out_i(const Leaves& lv, int leaf) {
  return static_cast<int*>(lv.out[leaf]);
}

// copy one lane's row of `width` elements of an updated-by-slot leaf
template <typename T>
__device__ __forceinline__ T* lane_row(const Leaves& lv, int leaf,
                                       long long lane, int width) {
  if (lv.out[leaf] == nullptr) return nullptr;
  const T* src = static_cast<const T*>(lv.in[leaf]) + lane * width;
  T* dst = static_cast<T*>(lv.out[leaf]) + lane * width;
  if (src != dst)
    for (int k = 0; k < width; ++k) dst[k] = src[k];
  return dst;
}

// 2-class threshold of the sigma = 0 sums g_s * e (physics
// _discriminate_acc), the float32 operations of the plain version in order
__device__ __forceinline__ int discriminate(float e, int state_bit,
                                            const float* g0c,
                                            const float* g1c) {
  const float gsi = state_bit == 1 ? g1c[0] : g0c[0];
  const float gsq = state_bit == 1 ? g1c[1] : g0c[1];
  const float acc_i = __fmul_rn(gsi, e), acc_q = __fmul_rn(gsq, e);
  const float a0_i = __fmul_rn(g0c[0], e), a0_q = __fmul_rn(g0c[1], e);
  const float a1_i = __fmul_rn(g1c[0], e), a1_q = __fmul_rn(g1c[1], e);
  const float p_i = __fmul_rn(
      __fsub_rn(acc_i, __fdiv_rn(__fadd_rn(a0_i, a1_i), 2.0f)),
      __fsub_rn(a1_i, a0_i));
  const float p_q = __fmul_rn(
      __fsub_rn(acc_q, __fdiv_rn(__fadd_rn(a0_q, a1_q), 2.0f)),
      __fsub_rn(a1_q, a0_q));
  return __fadd_rn(p_i, p_q) > 0.0f ? 1 : 0;
}

// run one (shot, core) lane through the program
template <bool FUSED>
__device__ __forceinline__ void run_lane(long long lane, const Leaves& lv,
                                         const Params& prm,
                         const int* prog, const int* __restrict__ spc,
                         const int* __restrict__ interp,
                         const int* __restrict__ bits_in,
                         const float* __restrict__ e2,
                         const float* __restrict__ g0,
                         const float* __restrict__ g1,
                         const int* __restrict__ addrs, float amp_scale) {
  const int* pv = prm.v;
  const int C = pv[P_C], N = pv[P_N], M = pv[P_M], R = pv[P_R];
  const int P = pv[P_P], E = pv[P_E];
  const int c = (int)(lane % C);

  int* rst_time = lane_row<int>(lv, L_RST_TIME, lane, R);
  int* meas_avail = lane_row<int>(lv, L_MEAS_AVAIL, lane, M);
  int* rec = lane_row<int>(lv, L_REC, lane, N_REC * P);
  int* op_hist = lane_row<int>(lv, L_OP_HIST, lane, N_KINDS);
  int *m_state = nullptr, *m_amp = nullptr, *m_phase = nullptr,
      *m_freq = nullptr, *m_env = nullptr, *m_gtime = nullptr;
  int* bits = nullptr;
  uint8_t* valid = nullptr;
  if (FUSED) {
    m_state = lane_row<int>(lv, L_MEAS_STATE, lane, M);
    m_amp = lane_row<int>(lv, L_MEAS_AMP, lane, M);
    m_phase = lane_row<int>(lv, L_MEAS_PHASE, lane, M);
    m_freq = lane_row<int>(lv, L_MEAS_FREQ, lane, M);
    m_env = lane_row<int>(lv, L_MEAS_ENV, lane, M);
    m_gtime = lane_row<int>(lv, L_MEAS_GTIME, lane, M);
    bits = lane_row<int>(lv, L_MEAS_BITS, lane, M);
    valid = lane_row<uint8_t>(lv, L_MEAS_VALID, lane, M);
  }
  const int* bits_rd = FUSED ? bits : bits_in + lane * M;

  int regs[N_REGS], pp[N_PP];
#pragma unroll
  for (int k = 0; k < N_REGS; ++k) regs[k] = in_i(lv, L_REGS)[lane * N_REGS + k];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) pp[k] = in_i(lv, L_PP)[lane * N_PP + k];
  int pc = in_i(lv, L_PC)[lane], time = in_i(lv, L_TIME)[lane];
  int offset = in_i(lv, L_OFFSET)[lane], err = in_i(lv, L_ERR)[lane];
  int fault = in_i(lv, L_FAULT)[lane];
  int n_pulses = in_i(lv, L_N_PULSES)[lane];
  int n_resets = in_i(lv, L_N_RESETS)[lane];
  int n_meas = in_i(lv, L_N_MEAS)[lane];
  bool done = static_cast<const uint8_t*>(lv.in[L_DONE])[lane] != 0;
  int qturns = FUSED ? in_i(lv, L_QTURNS)[lane] : 0;
  bool stalled = false;
  const int* spc_c = spc + (size_t)c * E;
  const int* interp_c = interp + (size_t)c * E;

  for (int last = -1; !done && pc > last && pc < N;) {
    const int i = pc;
    last = i;
    const int* f = prog + ((size_t)c * N + i) * N_FIELDS;
    const int kind = f[F_KIND];
    int err_i = 0, fault_i = 0;
    if (kind < 0 || kind >= N_KINDS) fault_i |= FAULT_ILLEGAL_OP;
    const bool is_fproc = kind == K_ALU_FPROC || kind == K_JUMP_FPROC;

    // ---- fproc: own-core sticky read --------------------------------
    int f_data = 0;
    bool f_race = false;
    if (is_fproc) {
      const int req = time;
      const int lo = wsub(req, STICKY_RACE_MARGIN);
      const int hi = wadd(req, STICKY_RACE_MARGIN);
      int m_cnt = 0;
      for (int m = 0; m < M; ++m) {
        const int a = meas_avail[m];
        m_cnt += a <= req;
        f_race |= a > lo && a <= hi;
      }
      const int latest = m_cnt > 0 ? m_cnt - 1 : 0;
      if (FUSED && m_cnt > 0 && valid[latest] == 0) {
        stalled = true;   // the bit is not resolved yet: phys_wait
        break;
      }
      f_data = m_cnt > 0 ? bits_rd[latest] : 0;
    }

    // ---- ALU ----------------------------------------------------------
    int alu_res = 0;
    if (kind == K_REG_ALU || kind == K_INC_QCLK || kind == K_JUMP_COND ||
        is_fproc) {
      const int in0 =
          f[F_IN0_IS_REG] == 1 ? reg_read(regs, f[F_IN0_REG]) : f[F_IMM];
      int in1;
      if (kind == K_REG_ALU || kind == K_JUMP_COND)
        in1 = reg_read(regs, f[F_IN1_REG]);
      else if (kind == K_INC_QCLK)
        in1 = wsub(time, offset);
      else
        in1 = f_data;
      alu_res = alu(f[F_ALU_OP], in0, in1);
      const int out_reg = f[F_OUT_REG];
      if ((kind == K_REG_ALU || kind == K_ALU_FPROC) && out_reg >= 0 &&
          out_reg < N_REGS)
        regs[out_reg] = alu_res;
    }

    // ---- pulse latch + trigger ----------------------------------------
    int trig = 0;
    if (kind == K_PULSE_WRITE || kind == K_PULSE_TRIG) {
      const int wen = f[F_P_WEN], rsel = f[F_P_REGSEL];
      const int regval = reg_read(regs, f[F_P_REG]);
      const int pmask[N_PP] = {0xffffff, 0x1ffff, 0x1ff, 0xffff, 0xf};
#pragma unroll
      for (int k = 0; k < N_PP; ++k)
        if ((wen >> k) & 1)
          pp[k] = (((rsel >> k) & 1) ? regval : f[F_P_ENV + k]) & pmask[k];
    }
    if (kind == K_PULSE_TRIG) {
      trig = wadd(offset, f[F_CMD_TIME]);
      if (trig < time) err_i |= ERR_MISSED_TRIG;
      trig = max(trig, time);
      const int elem = pp[4] & 3;
      const int e = min(elem, E - 1);
      const int env_len = (pp[0] >> 12) & 0xfff;
      const int nsamp = env_len * 4 * interp_c[e];
      const int dur = env_len == 0xfff ? 0 : (nsamp + spc_c[e] - 1) / spc_c[e];
      if (n_pulses >= P) {
        err_i |= ERR_PULSE_OVERFLOW;
        fault_i |= FAULT_PULSE_OVERFLOW;
      } else if (rec != nullptr) {
        const int vals[N_REC] = {f[F_CMD_TIME], trig, pp[0], pp[1], pp[2],
                                 pp[3], pp[4], elem, dur};
#pragma unroll
        for (int k = 0; k < N_REC; ++k) rec[k * P + n_pulses] = vals[k];
      }
      n_pulses += 1;
      const bool is_meas = elem == pv[P_MEAS_ELEM];
      const int slot = min(n_meas, M - 1);
      if (is_meas) {
        if (n_meas >= M) {
          err_i |= ERR_MEAS_OVERFLOW;
          fault_i |= FAULT_MEAS_OVERFLOW;
        }
        meas_avail[slot] = wadd(wadd(trig, dur), pv[P_MEAS_LATENCY]);
        n_meas += 1;
      }
      if (FUSED) {
        // the parity device: a drive pulse adds round(amp / x90) quarter
        // turns; physics mode without CW windows flags a CW readout
        const int x90 = pv[P_X90_AMP];
        if (x90 > 0 && elem == pv[P_DRIVE_ELEM])
          qturns = wadd(qturns, (2 * pp[3] + x90) / (2 * x90));
        const int state_bit = (qturns >> 1) & 1;
        if (is_meas) {
          if (env_len == 0xfff) err_i |= ERR_CW_MEAS;
          m_state[slot] = state_bit;
          m_amp[slot] = pp[3];
          m_phase[slot] = pp[1];
          m_freq[slot] = pp[2];
          m_env[slot] = pp[0];
          m_gtime[slot] = trig;
          // sigma = 0 readout of this window
          const int count = env_len == 0xfff ? 0 : min(nsamp, pv[P_W]);
          const int addr = (pp[0] & 0xfff) * 4;
          const int n_addrs = pv[P_N_ADDRS], Wp = pv[P_WP];
          float tot = 0.0f;
          for (int r = 0; r < n_addrs; ++r) {
            if (addrs[r] != addr) continue;
            const float* row = e2 + ((size_t)c * n_addrs + r) * Wp;
            float acc = 0.0f;
            for (int s = 0; s < count; ++s) acc += row[s];
            tot = __fadd_rn(tot, acc);
          }
          const float amp = __fdiv_rn((float)pp[3], amp_scale);
          const float energy = __fmul_rn(__fmul_rn(amp, amp), tot);
          bits[slot] = discriminate(energy, state_bit, g0 + 2 * c,
                                    g1 + 2 * c);
          valid[slot] = 1;
        }
      }
    }

    // ---- phase reset / idle -------------------------------------------
    int idle_end = 0;
    if (kind == K_PULSE_RESET) {
      rst_time[min(n_resets, R - 1)] = time;
      if (n_resets >= R) fault_i |= FAULT_RESET_OVERFLOW;
      n_resets += 1;
    } else if (kind == K_IDLE) {
      idle_end = wadd(offset, f[F_CMD_TIME]);
      if (time > idle_end) err_i |= ERR_MISSED_TRIG;
      idle_end = max(idle_end, time);
    }
    if (is_fproc && f_race) err_i |= ERR_STICKY_RACE;
    if (op_hist != nullptr && kind >= 0 && kind < N_KINDS) op_hist[kind] += 1;

    // ---- next pc / time / offset / done --------------------------------
    int pc_next = i + 1;
    const int ja = f[F_JUMP_ADDR];
    const bool taken =
        kind == K_JUMP_I ||
        ((kind == K_JUMP_COND || kind == K_JUMP_FPROC) && (alu_res & 1));
    if (taken) {
      pc_next = ja;
      if (ja < 0 || ja >= N) fault |= FAULT_JUMP_OOB;
    }
    int time_next = time;
    switch (kind) {
      case K_PULSE_TRIG: time_next = wadd(trig, pv[P_LOAD_CLKS]); break;
      case K_PULSE_WRITE:
      case K_PULSE_RESET: time_next = wadd(time, pv[P_REGWRITE_CLKS]); break;
      case K_IDLE: time_next = wadd(idle_end, pv[P_LOAD_CLKS]); break;
      case K_REG_ALU:
      case K_INC_QCLK: time_next = wadd(time, pv[P_ALU_CLKS]); break;
      case K_JUMP_I:
      case K_JUMP_COND: time_next = wadd(time, pv[P_JCOND_CLKS]); break;
      case K_ALU_FPROC:
      case K_JUMP_FPROC: time_next = wadd(time, pv[P_JFPROC_CLKS]); break;
      default: break;
    }
    if (kind == K_INC_QCLK) offset = wsub(time, alu_res);
    time = time_next;
    err |= err_i;
    fault |= fault_i;
    if (kind == K_DONE)
      done = true;
    else
      pc = pc_next;
  }

  // ---- the lane's scalars and register files out ----------------------
#pragma unroll
  for (int k = 0; k < N_REGS; ++k) out_i(lv, L_REGS)[lane * N_REGS + k] = regs[k];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) out_i(lv, L_PP)[lane * N_PP + k] = pp[k];
  out_i(lv, L_PC)[lane] = pc;
  out_i(lv, L_TIME)[lane] = time;
  out_i(lv, L_OFFSET)[lane] = offset;
  out_i(lv, L_ERR)[lane] = err;
  out_i(lv, L_FAULT)[lane] = fault;
  out_i(lv, L_N_PULSES)[lane] = n_pulses;
  out_i(lv, L_N_RESETS)[lane] = n_resets;
  out_i(lv, L_N_MEAS)[lane] = n_meas;
  static_cast<uint8_t*>(lv.out[L_DONE])[lane] = done ? 1 : 0;
  if (FUSED) {
    out_i(lv, L_QTURNS)[lane] = qturns;
    static_cast<uint8_t*>(lv.out[L_PHYS_WAIT])[lane] = stalled ? 1 : 0;
  }
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS) exec_span_kernel(
    Leaves lv, Params prm, const int* __restrict__ gprog, int prog_in_smem,
    const int* __restrict__ spc, const int* __restrict__ interp,
    const int* __restrict__ bits_in, const float* __restrict__ e2,
    const float* __restrict__ g0, const float* __restrict__ g1,
    const int* __restrict__ addrs, float amp_scale) {
  extern __shared__ int sprog[];
  const int* prog = gprog;
  if (prog_in_smem) {
    const int n = prm.v[P_C] * prm.v[P_N] * N_FIELDS;
    for (int k = threadIdx.x; k < n; k += blockDim.x) sprog[k] = gprog[k];
    __syncthreads();
    prog = sprog;
  }
  const long long lanes = (long long)prm.v[P_B] * prm.v[P_C];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       lane < lanes; lane += stride)
    run_lane<FUSED>(lane, lv, prm, prog, spc, interp, bits_in, e2, g0, g1,
                    addrs, amp_scale);
}

template <bool FUSED>
int launch(const Leaves& lv, const Params& prm, const int* prog,
           const int* spc, const int* interp, const int* bits_in,
           const float* e2, const float* g0, const float* g1,
           const int* addrs, float amp_scale, cudaStream_t stream) {
  const long long lanes = (long long)prm.v[P_B] * prm.v[P_C];
  if (lanes == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const size_t prog_bytes =
      (size_t)prm.v[P_C] * prm.v[P_N] * N_FIELDS * sizeof(int);
  const int in_smem = prog_bytes <= MAX_SMEM_PROG;
  const size_t smem = in_smem ? prog_bytes : 0;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(exec_span_kernel<FUSED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  // a grid-stride loop over the lanes: each block loads the program once
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < (long long)sms * 8 ? blocks : (long long)sms * 8);
  exec_span_kernel<FUSED><<<grid, THREADS, smem, stream>>>(
      lv, prm, prog, in_smem, spc, interp, bits_in, e2, g0, g1, addrs,
      amp_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one span pass on `stream`.  in_ptrs/out_ptrs: N_LEAVES device
// pointers each (0 = leaf absent; out may equal in).  params: N_PARAMS ints.
// prog: [C, N, N_FIELDS] int32; spc/interp: [C, E] int32.  K1 (fused = 0)
// reads the injected bits_in [B, C, M] int32; K3 (fused = 1) carries the
// bits in the L_MEAS_BITS/L_MEAS_VALID leaves and reads e2 [C, n_addrs, Wp]
// float32, g0/g1 [C, 2] float32 and addrs [n_addrs] int32.  Returns the
// launch's cudaError as an int (0 = launched).
extern "C" int dp_exec_span(const unsigned long long* in_ptrs,
                            const unsigned long long* out_ptrs, int n_leaves,
                            const int* params, int n_params, const int* prog,
                            const int* spc, const int* interp,
                            const int* bits_in, const float* e2,
                            const float* g0, const float* g1,
                            const int* addrs, float amp_scale, int fused,
                            void* stream) {
  if (n_leaves != N_LEAVES || n_params != N_PARAMS)
    return (int)cudaErrorInvalidValue;
  Leaves lv;
  for (int k = 0; k < N_LEAVES; ++k) {
    lv.in[k] = reinterpret_cast<const void*>(in_ptrs[k]);
    lv.out[k] = reinterpret_cast<void*>(out_ptrs[k]);
  }
  Params prm;
  for (int k = 0; k < N_PARAMS; ++k) prm.v[k] = params[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused)
    return launch<true>(lv, prm, prog, spc, interp, bits_in, e2, g0, g1,
                        addrs, amp_scale, s);
  return launch<false>(lv, prm, prog, spc, interp, bits_in, e2, g0, g1, addrs,
                       amp_scale, s);
}
