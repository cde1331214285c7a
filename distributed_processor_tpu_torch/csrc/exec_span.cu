// The megastep executor for Hopper (sm_90a): the kernels K1 (span and
// block mode) and K3.
//
// Replaces the TPU megastep kernel distributed_processor_tpu/ops/
// exec_pallas.py::_span_call_raw (its pallas_call at :349) with each of its
// three bodies:
//   K1  interpreter._exec_span_pallas: a whole forward-jump-only program
//       over every (shot, core) lane, measurement bits injected and valid;
//   K3  interpreter._exec_span_pallas_fused: the same in physics mode on
//       the parity device, each measurement window resolved at its trigger
//       with the sigma = 0 readout (_fused_window_energy +
//       _fused_discriminate), so the epoch loop runs once;
//   K1 block  interpreter._exec_block_body_pallas (inside _exec_blocks): the
//       block engine's superinstructions, deduplicated straight-line bodies
//       retired by the lanes whose block id selects them.
// The semantics are those of interpreter._sl_apply_instr and
// _blk_apply_row, whose ports are the plain versions
// (distributed_processor_tpu_torch/sim/interpreter.py _exec_straightline and
// _apply_blocks).  Both modes run one instruction row with the same device
// code (exec_row).
//
// Design.  In span mode the cores of a shot are independent: no SYNC, and
// an fproc read sees only the core's own sticky channel.  So one thread
// owns one (shot, core) lane and walks its program with the lane's state in
// registers (regs[16] in a thread-local array).  The program is
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
// Block mode.  The TPU code launches one masked pallas_call per
// deduplicated body per iteration of the block engine; here one launch per
// iteration serves every body.  A thread reads its lane's pc and block id
// bid_at[pc] once; a live lane with a block walks that body's rows of its
// core's table, pc advancing by one per retired row (a deduplicated body
// serves segments at other start addresses), and stops at a DONE row.  A
// body holds no jump, fproc read or sync (those end a block), so a lane
// needs nothing of any other lane.  The carry is updated in place: a lane
// with no block, or done, is not touched at all, and there is no
// out-of-place copy of the whole carry per iteration.  The boundary step
// between launches is the plain torch generic step.
//
// Integers.  Every add and subtract that the JAX engine lets wrap in int32
// is done in uint32 (signed overflow is undefined in C++); cmd_time holds
// uint32 bit patterns.  `le` is strict signed less-than.  The two divisions
// (pulse duration, parity step) use C's truncating `/` where the plain
// version floors: the wrapper holds their operands non-negative.
//
// Readout (K3).  At sigma = 0 a window's matched-filter sums are g_s * E
// with E = amp^2 * sum_{s < count} |env|^2 >= 0, so the bit is the sign of
// a projection that depends only on which response scaled E, not on how E
// was summed (E is 0 only when every summed sample is).  So the kernel
// reads the sum from a prefix table of the energy rows,
// E2p[c, r, n] = sum_{s < n} |env|^2 (ops/resolve.py
// build_energy_prefix: float64 sums stored as float32), at
// E2p[c, r, count]: one read per measurement where a walk of the row
// read up to W samples from L1/L2.  Only the bit leaves the kernel.  The
// projection is computed with the plain version's float32 operations one
// by one (no contraction into FMAs).
//
// Bound on this card.  Each lane reads its carry once and writes it once:
// at the headline (B = 262144, C = 8, max_meas = max_resets = 2, no pulse
// records) that is ~280 bytes per lane, ~0.6 GB per launch, ~0.18 ms at
// 3.35 TB/s; the integer work per retired instruction is a few dozen
// operations and does not bind.  K3 adds one prefix read and the
// discriminator's ~20 float32 operations per measurement.  Block mode
// reads and writes
// the carry of the lanes it retires (at most the whole carry) per launch;
// its launches are one per block-engine iteration.

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

// one (shot, core) lane: its scalars and pulse registers in registers, the
// rows that instructions update by slot in global memory.  The register
// file, which instructions index at run time, is kept apart (a thread-local
// array), so that it alone goes to local memory.
struct Lane {
  int pp[N_PP];
  int pc, time, offset, err, fault, n_pulses, n_resets, n_meas, qturns;
  bool done;
  int *rst_time, *meas_avail, *rec, *op_hist;
  int *m_state, *m_amp, *m_phase, *m_freq, *m_env, *m_gtime, *bits;
  uint8_t* valid;
  const int* bits_rd;
};

// K3's sigma = 0 readout: energy prefix rows, responses and envelope
// addresses
struct Readout {
  const float* e2p;
  const float* g0;
  const float* g1;
  const int* addrs;
  float amp_scale;
};

// read one lane in (copying its slot rows in -> out when they differ)
template <bool FUSED>
__device__ __forceinline__ void load_lane(Lane& s, int* regs, long long lane,
                                          const Leaves& lv, const Params& prm,
                                          const int* __restrict__ bits_in) {
  const int* pv = prm.v;
  const int M = pv[P_M], R = pv[P_R], P = pv[P_P];
  s.rst_time = lane_row<int>(lv, L_RST_TIME, lane, R);
  s.meas_avail = lane_row<int>(lv, L_MEAS_AVAIL, lane, M);
  s.rec = lane_row<int>(lv, L_REC, lane, N_REC * P);
  s.op_hist = lane_row<int>(lv, L_OP_HIST, lane, N_KINDS);
  s.m_state = s.m_amp = s.m_phase = s.m_freq = s.m_env = s.m_gtime = nullptr;
  s.bits = nullptr;
  s.valid = nullptr;
  if (FUSED) {
    s.m_state = lane_row<int>(lv, L_MEAS_STATE, lane, M);
    s.m_amp = lane_row<int>(lv, L_MEAS_AMP, lane, M);
    s.m_phase = lane_row<int>(lv, L_MEAS_PHASE, lane, M);
    s.m_freq = lane_row<int>(lv, L_MEAS_FREQ, lane, M);
    s.m_env = lane_row<int>(lv, L_MEAS_ENV, lane, M);
    s.m_gtime = lane_row<int>(lv, L_MEAS_GTIME, lane, M);
    s.bits = lane_row<int>(lv, L_MEAS_BITS, lane, M);
    s.valid = lane_row<uint8_t>(lv, L_MEAS_VALID, lane, M);
  }
  s.bits_rd = FUSED ? s.bits : (bits_in ? bits_in + lane * M : nullptr);
#pragma unroll
  for (int k = 0; k < N_REGS; ++k)
    regs[k] = in_i(lv, L_REGS)[lane * N_REGS + k];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) s.pp[k] = in_i(lv, L_PP)[lane * N_PP + k];
  s.pc = in_i(lv, L_PC)[lane];
  s.time = in_i(lv, L_TIME)[lane];
  s.offset = in_i(lv, L_OFFSET)[lane];
  s.err = in_i(lv, L_ERR)[lane];
  s.fault = in_i(lv, L_FAULT)[lane];
  s.n_pulses = in_i(lv, L_N_PULSES)[lane];
  s.n_resets = in_i(lv, L_N_RESETS)[lane];
  s.n_meas = in_i(lv, L_N_MEAS)[lane];
  s.done = static_cast<const uint8_t*>(lv.in[L_DONE])[lane] != 0;
  s.qturns = FUSED ? in_i(lv, L_QTURNS)[lane] : 0;
}

// write one lane's scalars and register files out
template <bool FUSED>
__device__ __forceinline__ void store_lane(const Lane& s, const int* regs,
                                           long long lane, const Leaves& lv) {
#pragma unroll
  for (int k = 0; k < N_REGS; ++k)
    out_i(lv, L_REGS)[lane * N_REGS + k] = regs[k];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) out_i(lv, L_PP)[lane * N_PP + k] = s.pp[k];
  out_i(lv, L_PC)[lane] = s.pc;
  out_i(lv, L_TIME)[lane] = s.time;
  out_i(lv, L_OFFSET)[lane] = s.offset;
  out_i(lv, L_ERR)[lane] = s.err;
  out_i(lv, L_FAULT)[lane] = s.fault;
  out_i(lv, L_N_PULSES)[lane] = s.n_pulses;
  out_i(lv, L_N_RESETS)[lane] = s.n_resets;
  out_i(lv, L_N_MEAS)[lane] = s.n_meas;
  static_cast<uint8_t*>(lv.out[L_DONE])[lane] = s.done ? 1 : 0;
  if (FUSED) out_i(lv, L_QTURNS)[lane] = s.qturns;
}

// retire the instruction row `f` on core `c`'s lane `s` (register file
// `regs`): the next pc is
// pc + 1 or a taken jump's target, and DONE halts without advancing pc.
// Returns false, with the lane unchanged, when an fproc read's bit is not
// resolved yet (K3: phys_wait).
template <bool FUSED>
__device__ __forceinline__ bool exec_row(Lane& s, int* regs, const int* f,
                                         int c,
                                         const Params& prm,
                                         const int* __restrict__ spc_c,
                                         const int* __restrict__ interp_c,
                                         const Readout& ro) {
  const int* pv = prm.v;
  const int N = pv[P_N], M = pv[P_M], R = pv[P_R], P = pv[P_P], E = pv[P_E];
  const int kind = f[F_KIND];
  int err_i = 0, fault_i = 0;
  if (kind < 0 || kind >= N_KINDS) fault_i |= FAULT_ILLEGAL_OP;
  const bool is_fproc = kind == K_ALU_FPROC || kind == K_JUMP_FPROC;

  // ---- fproc: own-core sticky read --------------------------------------
  int f_data = 0;
  bool f_race = false;
  if (is_fproc) {
    const int req = s.time;
    const int lo = wsub(req, STICKY_RACE_MARGIN);
    const int hi = wadd(req, STICKY_RACE_MARGIN);
    int m_cnt = 0;
    for (int m = 0; m < M; ++m) {
      const int a = s.meas_avail[m];
      m_cnt += a <= req;
      f_race |= a > lo && a <= hi;
    }
    const int latest = m_cnt > 0 ? m_cnt - 1 : 0;
    if (FUSED && m_cnt > 0 && s.valid[latest] == 0) return false;
    f_data = m_cnt > 0 ? s.bits_rd[latest] : 0;
  }

  // ---- ALU ----------------------------------------------------------------
  int alu_res = 0;
  if (kind == K_REG_ALU || kind == K_INC_QCLK || kind == K_JUMP_COND ||
      is_fproc) {
    const int in0 =
        f[F_IN0_IS_REG] == 1 ? reg_read(regs, f[F_IN0_REG]) : f[F_IMM];
    int in1;
    if (kind == K_REG_ALU || kind == K_JUMP_COND)
      in1 = reg_read(regs, f[F_IN1_REG]);
    else if (kind == K_INC_QCLK)
      in1 = wsub(s.time, s.offset);
    else
      in1 = f_data;
    alu_res = alu(f[F_ALU_OP], in0, in1);
    const int out_reg = f[F_OUT_REG];
    if ((kind == K_REG_ALU || kind == K_ALU_FPROC) && out_reg >= 0 &&
        out_reg < N_REGS)
      regs[out_reg] = alu_res;
  }

  // ---- pulse latch + trigger ----------------------------------------------
  int trig = 0;
  if (kind == K_PULSE_WRITE || kind == K_PULSE_TRIG) {
    const int wen = f[F_P_WEN], rsel = f[F_P_REGSEL];
    const int regval = reg_read(regs, f[F_P_REG]);
    const int pmask[N_PP] = {0xffffff, 0x1ffff, 0x1ff, 0xffff, 0xf};
#pragma unroll
    for (int k = 0; k < N_PP; ++k)
      if ((wen >> k) & 1)
        s.pp[k] = (((rsel >> k) & 1) ? regval : f[F_P_ENV + k]) & pmask[k];
  }
  if (kind == K_PULSE_TRIG) {
    trig = wadd(s.offset, f[F_CMD_TIME]);
    if (trig < s.time) err_i |= ERR_MISSED_TRIG;
    trig = max(trig, s.time);
    const int elem = s.pp[4] & 3;
    const int e = min(elem, E - 1);
    const int env_len = (s.pp[0] >> 12) & 0xfff;
    const int nsamp = env_len * 4 * interp_c[e];
    const int dur = env_len == 0xfff ? 0 : (nsamp + spc_c[e] - 1) / spc_c[e];
    if (s.n_pulses >= P) {
      err_i |= ERR_PULSE_OVERFLOW;
      fault_i |= FAULT_PULSE_OVERFLOW;
    } else if (s.rec != nullptr) {
      const int vals[N_REC] = {f[F_CMD_TIME], trig, s.pp[0], s.pp[1], s.pp[2],
                               s.pp[3], s.pp[4], elem, dur};
#pragma unroll
      for (int k = 0; k < N_REC; ++k) s.rec[k * P + s.n_pulses] = vals[k];
    }
    s.n_pulses += 1;
    const bool is_meas = elem == pv[P_MEAS_ELEM];
    const int slot = min(s.n_meas, M - 1);
    if (is_meas) {
      if (s.n_meas >= M) {
        err_i |= ERR_MEAS_OVERFLOW;
        fault_i |= FAULT_MEAS_OVERFLOW;
      }
      s.meas_avail[slot] = wadd(wadd(trig, dur), pv[P_MEAS_LATENCY]);
      s.n_meas += 1;
    }
    if (FUSED) {
      // the parity device: a drive pulse adds round(amp / x90) quarter
      // turns; physics mode without CW windows flags a CW readout
      const int x90 = pv[P_X90_AMP];
      if (x90 > 0 && elem == pv[P_DRIVE_ELEM])
        s.qturns = wadd(s.qturns, (2 * s.pp[3] + x90) / (2 * x90));
      const int state_bit = (s.qturns >> 1) & 1;
      if (is_meas) {
        if (env_len == 0xfff) err_i |= ERR_CW_MEAS;
        s.m_state[slot] = state_bit;
        s.m_amp[slot] = s.pp[3];
        s.m_phase[slot] = s.pp[1];
        s.m_freq[slot] = s.pp[2];
        s.m_env[slot] = s.pp[0];
        s.m_gtime[slot] = trig;
        // sigma = 0 readout of this window
        const int count = env_len == 0xfff ? 0 : min(nsamp, pv[P_W]);
        const int addr = (s.pp[0] & 0xfff) * 4;
        const int n_addrs = pv[P_N_ADDRS], Wp = pv[P_WP];
        float tot = 0.0f;
        for (int r = 0; r < n_addrs; ++r)
          if (ro.addrs[r] == addr)
            tot = __fadd_rn(tot, ro.e2p[((size_t)c * n_addrs + r) * Wp
                                        + count]);
        const float amp = __fdiv_rn((float)s.pp[3], ro.amp_scale);
        const float energy = __fmul_rn(__fmul_rn(amp, amp), tot);
        s.bits[slot] = discriminate(energy, state_bit, ro.g0 + 2 * c,
                                    ro.g1 + 2 * c);
        s.valid[slot] = 1;
      }
    }
  }

  // ---- phase reset / idle -------------------------------------------------
  int idle_end = 0;
  if (kind == K_PULSE_RESET) {
    s.rst_time[min(s.n_resets, R - 1)] = s.time;
    if (s.n_resets >= R) fault_i |= FAULT_RESET_OVERFLOW;
    s.n_resets += 1;
  } else if (kind == K_IDLE) {
    idle_end = wadd(s.offset, f[F_CMD_TIME]);
    if (s.time > idle_end) err_i |= ERR_MISSED_TRIG;
    idle_end = max(idle_end, s.time);
  }
  if (is_fproc && f_race) err_i |= ERR_STICKY_RACE;
  if (s.op_hist != nullptr && kind >= 0 && kind < N_KINDS)
    s.op_hist[kind] += 1;

  // ---- next pc / time / offset / done -------------------------------------
  int pc_next = s.pc + 1;
  const int ja = f[F_JUMP_ADDR];
  const bool taken =
      kind == K_JUMP_I ||
      ((kind == K_JUMP_COND || kind == K_JUMP_FPROC) && (alu_res & 1));
  if (taken) {
    pc_next = ja;
    if (ja < 0 || ja >= N) s.fault |= FAULT_JUMP_OOB;
  }
  int time_next = s.time;
  switch (kind) {
    case K_PULSE_TRIG: time_next = wadd(trig, pv[P_LOAD_CLKS]); break;
    case K_PULSE_WRITE:
    case K_PULSE_RESET: time_next = wadd(s.time, pv[P_REGWRITE_CLKS]); break;
    case K_IDLE: time_next = wadd(idle_end, pv[P_LOAD_CLKS]); break;
    case K_REG_ALU:
    case K_INC_QCLK: time_next = wadd(s.time, pv[P_ALU_CLKS]); break;
    case K_JUMP_I:
    case K_JUMP_COND: time_next = wadd(s.time, pv[P_JCOND_CLKS]); break;
    case K_ALU_FPROC:
    case K_JUMP_FPROC: time_next = wadd(s.time, pv[P_JFPROC_CLKS]); break;
    default: break;
  }
  if (kind == K_INC_QCLK) s.offset = wsub(s.time, alu_res);
  s.time = time_next;
  s.err |= err_i;
  s.fault |= fault_i;
  if (kind == K_DONE)
    s.done = true;
  else
    s.pc = pc_next;
  return true;
}

// span mode: run one (shot, core) lane through the program, index by index
// along its pc
template <bool FUSED>
__device__ __forceinline__ void run_lane(long long lane, const Leaves& lv,
                                         const Params& prm, const int* prog,
                                         const int* __restrict__ spc,
                                         const int* __restrict__ interp,
                                         const int* __restrict__ bits_in,
                                         const Readout& ro) {
  const int C = prm.v[P_C], N = prm.v[P_N], E = prm.v[P_E];
  const int c = (int)(lane % C);
  Lane s;
  int regs[N_REGS];
  load_lane<FUSED>(s, regs, lane, lv, prm, bits_in);
  bool stalled = false;
  for (int last = -1; !s.done && s.pc > last && s.pc < N;) {
    last = s.pc;
    if (!exec_row<FUSED>(s, regs, prog + ((size_t)c * N + s.pc) * N_FIELDS,
                         c, prm, spc + (size_t)c * E, interp + (size_t)c * E,
                         ro)) {
      stalled = true;   // the bit is not resolved yet: phys_wait
      break;
    }
  }
  store_lane<FUSED>(s, regs, lane, lv);
  if (FUSED)
    static_cast<uint8_t*>(lv.out[L_PHYS_WAIT])[lane] = stalled ? 1 : 0;
}

// stage the [C, N, N_FIELDS] program table in shared memory when it fits
__device__ __forceinline__ const int* stage_program(const int* gprog,
                                                    int prog_in_smem,
                                                    const Params& prm,
                                                    int* sprog) {
  if (!prog_in_smem) return gprog;
  const int n = prm.v[P_C] * prm.v[P_N] * N_FIELDS;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sprog[k] = gprog[k];
  __syncthreads();
  return sprog;
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS) exec_span_kernel(
    Leaves lv, Params prm, const int* __restrict__ gprog, int prog_in_smem,
    const int* __restrict__ spc, const int* __restrict__ interp,
    const int* __restrict__ bits_in, Readout ro) {
  extern __shared__ int sprog[];
  const int* prog = stage_program(gprog, prog_in_smem, prm, sprog);
  const long long lanes = (long long)prm.v[P_B] * prm.v[P_C];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       lane < lanes; lane += stride)
    run_lane<FUSED>(lane, lv, prm, prog, spc, interp, bits_in, ro);
}

// block mode: every live lane whose pc starts a block (bid_at[pc] >= 0)
// retires that block's deduplicated body, rows [start, start + length) of
// its core's table, with pc advancing by one per retired row; every other
// lane is left untouched.  The carry is updated in place.
__global__ void __launch_bounds__(THREADS) exec_blocks_kernel(
    Leaves lv, Params prm, const int* __restrict__ gprog, int prog_in_smem,
    const int* __restrict__ spc, const int* __restrict__ interp,
    const int* __restrict__ bid_at, const int* __restrict__ bodies) {
  extern __shared__ int sprog[];
  const int* prog = stage_program(gprog, prog_in_smem, prm, sprog);
  const int C = prm.v[P_C], N = prm.v[P_N], E = prm.v[P_E];
  const long long lanes = (long long)prm.v[P_B] * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const Readout none = {nullptr, nullptr, nullptr, nullptr, 1.0f};
  for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       lane < lanes; lane += stride) {
    const int pc = in_i(lv, L_PC)[lane];
    if (static_cast<const uint8_t*>(lv.in[L_DONE])[lane] || pc < 0 ||
        pc >= N)
      continue;
    const int bid = bid_at[pc];
    if (bid < 0) continue;
    const int start = bodies[2 * bid], length = bodies[2 * bid + 1];
    const int c = (int)(lane % C);
    Lane s;
    int regs[N_REGS];
    load_lane<false>(s, regs, lane, lv, prm, nullptr);
    for (int r = 0; r < length && !s.done; ++r)
      exec_row<false>(s, regs, prog + ((size_t)c * N + start + r) * N_FIELDS,
                      c, prm, spc + (size_t)c * E, interp + (size_t)c * E,
                      none);
    store_lane<false>(s, regs, lane, lv);
  }
}

// a grid-stride loop over the B * C lanes, each block staging the program
// once: the grid, and the shared memory of `kernel` (0 when the program is
// read from global memory)
template <typename Kernel>
cudaError_t geometry(Kernel kernel, const Params& prm, int* grid,
                     size_t* smem, int* in_smem) {
  const long long lanes = (long long)prm.v[P_B] * prm.v[P_C];
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const size_t prog_bytes =
      (size_t)prm.v[P_C] * prm.v[P_N] * N_FIELDS * sizeof(int);
  *in_smem = prog_bytes <= MAX_SMEM_PROG;
  *smem = *in_smem ? prog_bytes : 0;
  if (*smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
    if (rc != cudaSuccess) return rc;
  }
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  *grid = (int)(blocks < (long long)sms * 8 ? blocks : (long long)sms * 8);
  return cudaSuccess;
}

Leaves leaves(const unsigned long long* in_ptrs,
              const unsigned long long* out_ptrs) {
  Leaves lv;
  for (int k = 0; k < N_LEAVES; ++k) {
    lv.in[k] = reinterpret_cast<const void*>(in_ptrs[k]);
    lv.out[k] = reinterpret_cast<void*>(out_ptrs[k]);
  }
  return lv;
}

Params params_of(const int* params) {
  Params prm;
  for (int k = 0; k < N_PARAMS; ++k) prm.v[k] = params[k];
  return prm;
}

template <bool FUSED>
int launch_span(const Leaves& lv, const Params& prm, const int* prog,
                const int* spc, const int* interp, const int* bits_in,
                const Readout& ro, cudaStream_t stream) {
  if ((long long)prm.v[P_B] * prm.v[P_C] == 0) return 0;
  int grid = 0, in_smem = 0;
  size_t smem = 0;
  const cudaError_t rc =
      geometry(exec_span_kernel<FUSED>, prm, &grid, &smem, &in_smem);
  if (rc != cudaSuccess) return (int)rc;
  exec_span_kernel<FUSED><<<grid, THREADS, smem, stream>>>(
      lv, prm, prog, in_smem, spc, interp, bits_in, ro);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one span pass on `stream`.  in_ptrs/out_ptrs: N_LEAVES device
// pointers each (0 = leaf absent; out may equal in).  params: N_PARAMS ints.
// prog: [C, N, N_FIELDS] int32; spc/interp: [C, E] int32.  K1 (fused = 0)
// reads the injected bits_in [B, C, M] int32; K3 (fused = 1) carries the
// bits in the L_MEAS_BITS/L_MEAS_VALID leaves and reads the energy prefix
// e2p [C, n_addrs, Wp] float32 (Wp = params[P_WP] > W), g0/g1 [C, 2]
// float32 and addrs [n_addrs] int32.  Returns the
// launch's cudaError as an int (0 = launched).
extern "C" int dp_exec_span(const unsigned long long* in_ptrs,
                            const unsigned long long* out_ptrs, int n_leaves,
                            const int* params, int n_params, const int* prog,
                            const int* spc, const int* interp,
                            const int* bits_in, const float* e2p,
                            const float* g0, const float* g1,
                            const int* addrs, float amp_scale, int fused,
                            void* stream) {
  if (n_leaves != N_LEAVES || n_params != N_PARAMS)
    return (int)cudaErrorInvalidValue;
  const Leaves lv = leaves(in_ptrs, out_ptrs);
  const Params prm = params_of(params);
  const Readout ro = {e2p, g0, g1, addrs, amp_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused)
    return launch_span<true>(lv, prm, prog, spc, interp, bits_in, ro, s);
  return launch_span<false>(lv, prm, prog, spc, interp, bits_in, ro, s);
}

// Launch one block-mode pass on `stream`, updating the carry in place:
// ptrs holds N_LEAVES device pointers (0 = leaf absent).  bid_at: [N]
// int32 block id of each program index (-1: no block starts there);
// bodies: [n_bodies, 2] int32 (start, length) of each deduplicated body.
// Returns the launch's cudaError as an int (0 = launched).
extern "C" int dp_exec_blocks(const unsigned long long* ptrs, int n_leaves,
                              const int* params, int n_params,
                              const int* prog, const int* spc,
                              const int* interp, const int* bid_at,
                              const int* bodies, void* stream) {
  if (n_leaves != N_LEAVES || n_params != N_PARAMS)
    return (int)cudaErrorInvalidValue;
  const Leaves lv = leaves(ptrs, ptrs);
  const Params prm = params_of(params);
  if ((long long)prm.v[P_B] * prm.v[P_C] == 0) return 0;
  int grid = 0, in_smem = 0;
  size_t smem = 0;
  const cudaError_t rc =
      geometry(exec_blocks_kernel, prm, &grid, &smem, &in_smem);
  if (rc != cudaSuccess) return (int)rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  exec_blocks_kernel<<<grid, THREADS, smem, s>>>(lv, prm, prog, in_smem, spc,
                                                 interp, bid_at, bodies);
  return (int)cudaGetLastError();
}
