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
// One kernel here replaces no TPU kernel: exec_span_physics_kernel, K3's
// pass with its readout left to the epoch resolver K2, which the physics
// loop runs once per epoch (see its note).
// The semantics are those of interpreter._sl_apply_instr and
// _blk_apply_row, whose ports are the plain versions
// (distributed_processor_tpu_torch/sim/interpreter.py _exec_straightline and
// _apply_blocks).  Every kernel here retires a row with the same device
// code (exec_row), one case per kind.
//
// Design.  The program is data, not traced code: a [C, N, 18] int32 field
// table.  A lane executes index i iff pc == i, and jumps only go forward
// in span mode, so one ascending pass over the indices retires every lane;
// a lane stops at DONE, at a pc past the program, at a pc that does not
// move forward (the TPU kernel's ascending index loop would never revisit
// it), or (K3) at an fproc read whose bit is not valid yet (phys_wait).
//
// K1 span and K1 block (the tile kernel, exec_tile_kernel).  The lanes of
// one core walk the same program, so a warp serves one core's 32 shots
// and is core-uniform: a thread block owns a tile of `sub` x 32
// consecutive shots x every core (about 16 warps, one per (32 shots,
// core) item; items beyond the block's warps are looped; a ragged last
// tile is masked), a persistent grid striding over the tiles.  In span
// mode the warp visits the indices in ascending order, each the least pc
// of its live lanes, and the lanes at that pc retire the row together:
// one row read (a shared-memory broadcast), one case of the row's kind
// (exec_row, the pulse rows tested first).  Lanes split only where a
// data-dependent jump (an fproc read of the injected bits, a conditional
// jump on per-shot registers) sends them to different indices, and meet
// again at the next common one.  In block mode bid_at[pc] is shared by
// all cores; the warp retires one deduplicated body at a time for the
// lanes whose block id selects it.  A pulse's duration divides by the
// element's samples per clock with a multiply and a shift (Dur), from a
// per-block table of the [C, 4] element geometry.
//
// The carry tile.  A tile's lanes [l0, l0 + sub*32*C) are contiguous in
// every [B, C, ...] leaf, so the block stages the leaves a row reads and
// writes (`BODY_LEAVES` of chip_smoke.py: regs, pp, pc, time, offset,
// err, fault, n_pulses, n_resets, n_meas, done) into shared memory:
// consecutive threads take consecutive lanes and load every word of
// their lane before storing any (one memory latency per lane, the
// register row as 16-byte vectors), transposed to [column][item][pitch].
// A warp-uniform register index then reads 32 consecutive words, and the
// pitch, 32 + 32 / C, keeps the staging threads on 32 banks as well; the
// register file never lives in thread-local memory.  After the rows, the
// tile goes back the same way.  The leaves that rows write by slot stay in
// global memory and are written in place: rst_time, meas_avail and
// meas_time (read by fproc), the pulse records rec [B, C, 9, P] and the
// opcode histogram; in span mode (out of place) the tile's segment of each
// is first copied in -> out with 16-byte loads, before any row runs (so
// meas_time's INT32_MAX fill reaches the output of a lane that measures
// fewer than M times).  In block mode a tile first reads pc and
// done; only the lanes that run a body are staged and written back, and
// a tile with none is left untouched.  The program table is staged in
// shared memory beside the tile where it fits (21 KB at the headline),
// else read through L1.  The geometry (`sub`, warps, column stride,
// pitch) is the wrapper's tile_geometry; a tile that would not fit in
// shared memory falls back to one thread per lane.
//
// The 'lut' fabric (hdl/fproc_lut.sv + meas_lut.sv).  A LUT read gathers
// the bits of the masked cores of its shot, so it needs other lanes' state
// (lut_read): each masked core's measurement count, and its rows of
// production clocks (meas_time, the trigger time of each slot), of
// availability and of bits.  The TPU kernel applies index i to every core
// before i + 1, and the eligibility rule (interpreter._lut_span_reject)
// puts every masked core's possible measurement below the first read index
// min_read, so at a read those rows are final.  The kernels here do not
// keep that order: a warp walks one core's lanes at its own pace.  So a
// span pass under the fabric splits at min_read (P_MIN_READ): first every
// lane retires the indices below it, then, after a barrier, the rest.  The
// tile kernel holds every core of its shots, so the barrier is a
// __syncthreads() between the two phases of the item loop, the counts read
// from the staged column.  In the one-thread-per-lane span kernels the
// first THREADS - THREADS % C threads of a block hold whole shots; each
// lane publishes its count to the output leaf before the barrier, and
// reads the others' from there.  A lane that jumps from below min_read past it waits at its
// target for the second phase.  Block bodies hold no fproc read (it ends a
// block), so block mode only writes meas_time at a measurement.
//
// One thread per lane (exec_span_kernel, exec_blocks_kernel): the first
// design, which K3 runs and K1 falls back to — regs[16] in a
// thread-local array, each lane reading its own rows with warp-strided
// loads, the program in shared memory, a pulse's duration by division.
// In span mode each warp first copies its 32 lanes' slot rows in -> out
// together (copy_slot_rows), so that no thread strides alone through a
// row of pulse records, 36 P bytes.  Every kernel
// is specialised on the fabric: a sticky carry runs code with neither
// the meas_time write nor the LUT read.
//
// Block mode.  The TPU code launches one masked pallas_call per
// deduplicated body per iteration of the block engine; here one launch per
// iteration serves every body.  A live lane with a block walks that body's
// rows of its core's table, pc advancing by one per retired row (a
// deduplicated body serves segments at other start addresses), and stops
// at a DONE row.  A body holds no jump, fproc read or sync (those end a
// block), so a lane needs nothing of any other lane.  The carry is updated
// in place.  The boundary step between launches is the plain torch
// generic step.
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
// Bound on this card.  Bytes: each lane's carry read once and written
// once; at the headline (B = 262144, C = 8, max_meas = max_resets = 2, no
// pulse records) 0.575 GB per launch, 0.17 ms at 3.35 TB/s.  Operations:
// ~40 32-bit integer adds, compares and logic operations per retired row
// (decode, ALU, pulse latch and trigger, next pc and time), issued at 64
// per clock per SM on compute capability 9.0 (132 SMs at 1.98 GHz: 1.67e13
// per second); the headline's 74.4M retired rows give 0.178 ms, so K1 span
// is bound by operations.  Block mode moves only what a body needs: pc and
// done of every lane, the staged leaves of the lanes that run a body (117
// bytes each way) and one slot per reset or measurement, one launch per
// block-engine iteration: bound by bytes.  What the kernels take against
// these bounds, and what the designs tried and dropped took, is in
// PERF.md.  K3 adds one prefix read and the discriminator's ~20 float32
// operations per measurement.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

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
  L_N_RESETS, L_RST_TIME, L_N_MEAS, L_MEAS_AVAIL, L_MEAS_TIME, L_REC,
  L_OP_HIST,
  L_MEAS_STATE, L_MEAS_AMP, L_MEAS_PHASE, L_MEAS_FREQ, L_MEAS_ENV,
  L_MEAS_GTIME, L_QTURNS, L_MEAS_BITS, L_MEAS_VALID, L_PHYS_WAIT, N_LEAVES
};

// scalar parameters (ops/exec_span.py PARAMS)
enum Param {
  P_B, P_C, P_N, P_M, P_R, P_P, P_E, P_MEAS_ELEM, P_MEAS_LATENCY,
  P_ALU_CLKS, P_JCOND_CLKS, P_JFPROC_CLKS, P_REGWRITE_CLKS, P_LOAD_CLKS,
  P_X90_AMP, P_DRIVE_ELEM, P_N_ADDRS, P_W, P_WP, P_MIN_READ, P_LUT_N,
  N_PARAMS
};

constexpr int N_REGS = 16, N_PP = 5, N_REC = 9;
constexpr int STICKY_RACE_MARGIN = 2;
constexpr int ERR_MISSED_TRIG = 1, ERR_PULSE_OVERFLOW = 2,
              ERR_MEAS_OVERFLOW = 4, ERR_FPROC_DEADLOCK = 8,
              ERR_STICKY_RACE = 64, ERR_CW_MEAS = 128;
constexpr int FAULT_FPROC_STARVED = 4, FAULT_PULSE_OVERFLOW = 8,
              FAULT_MEAS_OVERFLOW = 16, FAULT_RESET_OVERFLOW = 32,
              FAULT_ILLEGAL_OP = 64, FAULT_JUMP_OOB = 128;
constexpr size_t MAX_SMEM_PROG = 200 * 1024;
constexpr int THREADS = 256;
// the tile kernel: 32 shots per warp, at most 16 warps per block
// (ops/exec_span.py TILE_SHOTS, TILE_WARPS), two blocks per SM (at most 64
// registers a thread)
constexpr int TILE_SHOTS = 32, TILE_MAX_THREADS = 512;
// the elements a pulse can name (cfg & 3): the tile kernel's Dur entries
// per core
constexpr int DUR_ELEMS = 4;
// shared memory a block may take on the card
constexpr size_t MAX_SMEM_BLOCK = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;
// the staged scalar columns, in shared memory after regs and pp
enum Scalar {
  S_PC, S_TIME, S_OFFSET, S_ERR, S_FAULT, S_N_PULSES, S_N_RESETS, S_N_MEAS,
  S_DONE, N_SCALARS
};

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

// a lane's register file: a thread-local array (one thread per lane) or
// a column of the tile's [16][item][33] words in shared memory
struct LocalRegs {
  int* r;
  __device__ __forceinline__ int& operator[](int k) const { return r[k]; }
};

struct TileRegs {
  int* r;
  int stride;
  __device__ __forceinline__ int& operator[](int k) const {
    return r[k * stride];
  }
};

// a register address outside the file reads 0 (the plain version's
// one-hot select)
template <class Regs>
__device__ __forceinline__ int reg_read(const Regs& regs, int a) {
  return (a >= 0 && a < N_REGS) ? regs[a] : 0;
}

__device__ __forceinline__ const int* in_i(const Leaves& lv, int leaf) {
  return static_cast<const int*>(lv.in[leaf]);
}

__device__ __forceinline__ int* out_i(const Leaves& lv, int leaf) {
  return static_cast<int*>(lv.out[leaf]);
}

// one lane's row of `width` elements of an updated-by-slot leaf in the
// output, copied there from the input when `copy` and the two differ
template <typename T>
__device__ __forceinline__ T* lane_row(const Leaves& lv, int leaf,
                                       long long lane, int width,
                                       bool copy) {
  if (lv.out[leaf] == nullptr) return nullptr;
  const T* src = static_cast<const T*>(lv.in[leaf]) + lane * width;
  T* dst = static_cast<T*>(lv.out[leaf]) + lane * width;
  if (copy && src != dst)
    for (int k = 0; k < width; ++k) dst[k] = src[k];
  return dst;
}

// the tile's segment of a slot leaf of `w` words per lane, in -> out (span
// mode); 16-byte loads where both sides are aligned
__device__ __forceinline__ void tile_copy(const Leaves& lv, int leaf, int w,
                                          long long l0, int n) {
  if (lv.out[leaf] == nullptr || lv.in[leaf] == lv.out[leaf]) return;
  const int* src = in_i(lv, leaf) + l0 * w;
  int* dst = out_i(lv, leaf) + l0 * w;
  const int cnt = n * w;
  int head = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const int n4 = cnt >> 2;
    for (int e = threadIdx.x; e < n4; e += blockDim.x)
      reinterpret_cast<int4*>(dst)[e] = reinterpret_cast<const int4*>(src)[e];
    head = n4 << 2;
  }
  for (int e = head + threadIdx.x; e < cnt; e += blockDim.x) dst[e] = src[e];
}

// threads `tid` of `nt` copy `bytes` bytes at byte `off` of a leaf in ->
// out: 16 bytes a thread where both sides are aligned, else 4 or 1 (one
// loop: kept short, the copy costs the one-thread-per-lane kernels no
// registers the row interpreter needs)
__device__ __forceinline__ void seg_copy(const Leaves& lv, int leaf,
                                         size_t off, size_t bytes, int tid,
                                         int nt) {
  if (lv.out[leaf] == nullptr || lv.in[leaf] == lv.out[leaf]) return;
  const char* src = static_cast<const char*>(lv.in[leaf]) + off;
  char* dst = static_cast<char*>(lv.out[leaf]) + off;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst);
  const size_t unit = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
  const size_t n = bytes / unit;
  for (size_t e = tid; e < n; e += nt) {
    if (unit == 16)
      reinterpret_cast<int4*>(dst)[e] = reinterpret_cast<const int4*>(src)[e];
    else if (unit == 4)
      reinterpret_cast<int*>(dst)[e] = reinterpret_cast<const int*>(src)[e];
    else
      dst[e] = src[e];
  }
  for (size_t e = n * unit + tid; e < bytes; e += nt) dst[e] = src[e];
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
// file, which instructions index at run time, is kept apart: a
// thread-local array in the one-thread-per-lane design (so that it alone
// goes to local memory), shared memory in the tile kernel.
struct Lane {
  int pp[N_PP];
  int pc, time, offset, err, fault, n_pulses, n_resets, n_meas, qturns;
  bool done;
  int *rst_time, *meas_avail, *meas_time, *rec, *op_hist;
  int *m_state, *m_amp, *m_phase, *m_freq, *m_env, *m_gtime, *bits;
  uint8_t* valid;
  const int* bits_rd;
};

// what a LUT read sees of the other cores of its shot (the 'lut' fabric):
// producer k's measurement count at n_meas[k * n_stride], and its [M]
// rows of production clocks, availability, bits and validity at k * M of
// the shot's planes.  `lut`: the address shift of each of the C cores (-1:
// not in the mask), then the table; null under the sticky fabric.
struct Peers {
  const int* lut;
  const int* n_meas;
  int n_stride;
  const int* mtime;
  const int* mavail;
  const int* bits;
  const uint8_t* valid;   // null: every bit valid (injected bits)
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

// the slot leaves' rows of lanes [l0, l0 + n), in -> out, copied by
// threads `tid` of `nt` (in the one-thread-per-lane span kernels the warp
// of 32 consecutive lanes, so that no thread strides alone through a row
// of pulse records, 36 P bytes)
template <bool FUSED>
__device__ __forceinline__ void copy_slot_rows(const Leaves& lv,
                                               const Params& prm,
                                               long long l0, int n, int tid,
                                               int nt) {
  const int M = prm.v[P_M], R = prm.v[P_R], P = prm.v[P_P];
  const int widths[][2] = {{L_RST_TIME, R}, {L_MEAS_AVAIL, M},
                           {L_MEAS_TIME, M}, {L_REC, N_REC * P},
                           {L_OP_HIST, N_KINDS}, {L_MEAS_STATE, M},
                           {L_MEAS_AMP, M}, {L_MEAS_PHASE, M},
                           {L_MEAS_FREQ, M}, {L_MEAS_ENV, M},
                           {L_MEAS_GTIME, M}, {L_MEAS_BITS, M}};
  for (int k = 0; k < (FUSED ? 12 : 5); ++k)
    seg_copy(lv, widths[k][0], (size_t)l0 * widths[k][1] * 4,
             (size_t)n * widths[k][1] * 4, tid, nt);
  if (FUSED)
    seg_copy(lv, L_MEAS_VALID, (size_t)l0 * M, (size_t)n * M, tid, nt);
}

// read one lane in (copying its slot rows in -> out when they differ,
// unless `copied`: copy_slot_rows moved them)
template <bool FUSED>
__device__ __forceinline__ void load_lane(Lane& s, int* regs, long long lane,
                                          const Leaves& lv, const Params& prm,
                                          const int* __restrict__ bits_in,
                                          bool copied) {
  const int* pv = prm.v;
  const int M = pv[P_M], R = pv[P_R], P = pv[P_P];
  const bool copy = !copied;
  s.rst_time = lane_row<int>(lv, L_RST_TIME, lane, R, copy);
  s.meas_avail = lane_row<int>(lv, L_MEAS_AVAIL, lane, M, copy);
  s.meas_time = lane_row<int>(lv, L_MEAS_TIME, lane, M, copy);
  s.rec = lane_row<int>(lv, L_REC, lane, N_REC * P, copy);
  s.op_hist = lane_row<int>(lv, L_OP_HIST, lane, N_KINDS, copy);
  s.m_state = s.m_amp = s.m_phase = s.m_freq = s.m_env = s.m_gtime = nullptr;
  s.bits = nullptr;
  s.valid = nullptr;
  if (FUSED) {
    s.m_state = lane_row<int>(lv, L_MEAS_STATE, lane, M, copy);
    s.m_amp = lane_row<int>(lv, L_MEAS_AMP, lane, M, copy);
    s.m_phase = lane_row<int>(lv, L_MEAS_PHASE, lane, M, copy);
    s.m_freq = lane_row<int>(lv, L_MEAS_FREQ, lane, M, copy);
    s.m_env = lane_row<int>(lv, L_MEAS_ENV, lane, M, copy);
    s.m_gtime = lane_row<int>(lv, L_MEAS_GTIME, lane, M, copy);
    s.bits = lane_row<int>(lv, L_MEAS_BITS, lane, M, copy);
    s.valid = lane_row<uint8_t>(lv, L_MEAS_VALID, lane, M, copy);
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

// a pulse's duration in clocks, ceil(env_len * 4 * interp / spc), for one
// (core, element): the numerator n = env_len * 4 * interp + spc - 1 lies in
// [0, 2^31) (the wrapper holds it there), so n / spc is (n * m) >> (31 + l)
// with l = ceil(log2 spc), m = ceil(2^(31 + l) / spc) < 2^32 (the
// round-up method of Granlund and Montgomery): one wide multiply in
// place of a division
struct Dur {
  int interp, spc_m1;
  unsigned m, shift;
};

__device__ __forceinline__ Dur make_dur(int spc, int interp) {
  const unsigned l = spc > 1 ? 32 - __clz(spc - 1) : 0;
  const unsigned long long p = 1ull << (31 + l);
  return {interp, spc - 1, (unsigned)((p + spc - 1) / spc), 31 + l};
}

__device__ __forceinline__ int pulse_dur(const Dur& d, int env_len) {
  const unsigned n = (unsigned)(env_len * 4 * d.interp + d.spc_m1);
  return (int)(((unsigned long long)n * d.m) >> d.shift);
}

// the sample count and the duration of a pulse of element `e` on one
// core: by division of the [C, E] geometry (DivDur, the one-thread-per-lane
// kernels) or from the block's Dur table (TabDur, the tile kernel); the
// two agree on every operand the wrapper admits
struct DivDur {
  const int* spc_c;
  const int* interp_c;
  __device__ __forceinline__ int nsamp(int e, int env_len) const {
    return env_len * 4 * interp_c[e];
  }
  __device__ __forceinline__ int dur(int e, int env_len) const {
    return (nsamp(e, env_len) + spc_c[e] - 1) / spc_c[e];
  }
};

struct TabDur {
  const Dur* d;
  __device__ __forceinline__ int nsamp(int e, int env_len) const {
    return env_len * 4 * d[e].interp;
  }
  __device__ __forceinline__ int dur(int e, int env_len) const {
    return pulse_dur(d[e], env_len);
  }
};

// an ALU row's first operand: a register or the immediate
template <class Regs>
__device__ __forceinline__ int alu_in0(const Regs& regs, const int* f) {
  return f[F_IN0_IS_REG] == 1 ? reg_read(regs, f[F_IN0_REG]) : f[F_IMM];
}

// a taken jump's target; one outside the program faults
__device__ __forceinline__ int jump_to(Lane& s, const int* f, int N) {
  const int ja = f[F_JUMP_ADDR];
  if (ja < 0 || ja >= N) s.fault |= FAULT_JUMP_OOB;
  return ja;
}

// K3 at a trigger: the parity device, where a drive pulse adds
// round(amp / x90) quarter turns
__device__ __forceinline__ void parity_step(Lane& s, int elem,
                                            const Params& prm) {
  const int* pv = prm.v;
  const int x90 = pv[P_X90_AMP];
  if (x90 > 0 && elem == pv[P_DRIVE_ELEM])
    s.qturns = wadd(s.qturns, (2 * s.pp[3] + x90) / (2 * x90));
}

// physics mode at a measurement into `slot`: latch the window the epoch
// resolver reads (the state the parity device holds, the pulse registers,
// the trigger time); physics mode without CW windows flags a CW readout.
// Returns the state bit.
__device__ __forceinline__ int latch_window(Lane& s, int slot, int trig,
                                            int env_len) {
  const int state_bit = (s.qturns >> 1) & 1;
  if (env_len == 0xfff) s.err |= ERR_CW_MEAS;
  s.m_state[slot] = state_bit;
  s.m_amp[slot] = s.pp[3];
  s.m_phase[slot] = s.pp[1];
  s.m_freq[slot] = s.pp[2];
  s.m_env[slot] = s.pp[0];
  s.m_gtime[slot] = trig;
  return state_bit;
}

// K3 at a measurement into `slot` on core `c`: the window latched, then
// its sigma = 0 readout
__device__ __forceinline__ void fused_readout(Lane& s, int slot, int trig,
                                              int env_len, int nsamp, int c,
                                              const Params& prm,
                                              const Readout& ro) {
  const int* pv = prm.v;
  const int state_bit = latch_window(s, slot, trig, env_len);
  const int count = env_len == 0xfff ? 0 : min(nsamp, pv[P_W]);
  const int addr = (s.pp[0] & 0xfff) * 4;
  const int n_addrs = pv[P_N_ADDRS], Wp = pv[P_WP];
  float tot = 0.0f;
  for (int r = 0; r < n_addrs; ++r)
    if (ro.addrs[r] == addr)
      tot = __fadd_rn(tot, ro.e2p[((size_t)c * n_addrs + r) * Wp + count]);
  const float amp = __fdiv_rn((float)s.pp[3], ro.amp_scale);
  const float energy = __fmul_rn(__fmul_rn(amp, amp), tot);
  s.bits[slot] = discriminate(energy, state_bit, ro.g0 + 2 * c,
                              ro.g1 + 2 * c);
  s.valid[slot] = 1;
}

// the 'lut' fabric's read at request time `req` for core `c` of a shot
// (interpreter._sl_apply_instr's span serve, hdl/fproc_lut.sv +
// meas_lut.sv): per masked producer the newest bit produced strictly
// before the request, slot max(#{m < n_meas : meas_time[m] < req}, 1) - 1;
// the masked bits form the table address (LSB = the lowest masked core)
// and bit c of the entry is the reader's data.  The planes are final here
// (the span's split at the first read index).  Returns 1 when a masked
// producer recorded no measurement (starved), 2 when a selected bit is not
// valid yet (K3: phys_wait), else 0 with the data and the distribution
// time: the latest selected availability over the mask (unwritten read as
// 0), and 0 from any unmasked core.
__device__ __forceinline__ int lut_read(const Peers& pr, int c, int req,
                                        const Params& prm, int* data,
                                        int* t_lut) {
  const int C = prm.v[P_C], M = prm.v[P_M];
  int addr = 0, t = INT32_MIN, masked = 0, status = 0;
  for (int k = 0; k < C; ++k) {
    const int sh = pr.lut[k];
    if (sh < 0) continue;
    ++masked;
    const int n = pr.n_meas[k * pr.n_stride];
    if (n == 0) status = 1;
    const int* mt = pr.mtime + k * M;
    int cnt = 0;
    for (int m = 0; m < M; ++m) cnt += (m < n) & (mt[m] < req);
    const int sel = k * M + (cnt > 0 ? cnt - 1 : 0);
    if (pr.valid != nullptr && pr.valid[sel] == 0 && status == 0)
      status = 2;
    const int a = pr.mavail[sel];
    t = max(t, a == INT32_MAX ? 0 : a);
    addr = wadd(addr, (int)((uint32_t)pr.bits[sel] << sh));
  }
  if (masked < C) t = max(t, 0);
  const int T = prm.v[P_LUT_N];
  const int entry = addr >= 0 && addr < T ? pr.lut[C + addr] : 0;
  *data = (entry >> min(c, 31)) & 1;
  *t_lut = t;
  return status;
}

// retire the instruction row `f` on core `c`'s lane `s` (register file
// `regs`, pulse durations from `du`), the one interpreter of every
// kernel here: one case per kind, the pulse rows tested first (most rows
// of a program are pulses), so that a core-uniform warp, whose lanes
// share the row, runs that case alone.  The next pc is pc + 1 or a taken
// jump's target, and DONE halts without advancing pc.  Returns false,
// with the lane unchanged, when an fproc read's bit is not resolved yet
// (K3: phys_wait).  An fproc read is the own core's sticky read, or under
// the 'lut' fabric (`pr.lut` set) the LUT read of lut_read; a starved LUT
// read halts the lane at the read with the deadlock and starved bits.
// FUSED: K3's physics mode (injected bits otherwise).  LUT: the 'lut'
// fabric's carry, whose meas_time plane a measurement writes and whose
// reads `pr` may serve (a sticky-fabric kernel carries no code for
// either).
// HIST: the carry may hold pulse records or the opcode histogram (the
// tile kernel is specialised on it; without either it carries no code
// for them).  READOUT (physics mode): a measurement resolves its window's
// bit (K3), or only latches the window and leaves the bit, and its valid
// flag, to the epoch resolver (K3 with its readout left to K2).
template <bool FUSED, bool HIST, bool LUT, bool READOUT = FUSED, class Regs,
          class DurOf>
__device__ __forceinline__ bool exec_row(Lane& s, const Regs& regs,
                                         const int* f, int c,
                                         const Params& prm, const DurOf& du,
                                         const Readout& ro, const Peers& pr) {
  const int* pv = prm.v;
  const int kind = f[F_KIND];
  int pc_next = s.pc + 1;
  if (__builtin_expect((unsigned)kind <= K_PULSE_TRIG, 1)) {
    // ---- pulse latch ----------------------------------------------------
    const int wen = f[F_P_WEN], rsel = f[F_P_REGSEL];
    const int pmask[N_PP] = {0xffffff, 0x1ffff, 0x1ff, 0xffff, 0xf};
    if (wen == (1 << N_PP) - 1 && rsel == 0) {
      // the common row: every pulse register from the row's words
#pragma unroll
      for (int k = 0; k < N_PP; ++k) s.pp[k] = f[F_P_ENV + k] & pmask[k];
    } else {
      const int regval = reg_read(regs, f[F_P_REG]);
#pragma unroll
      for (int k = 0; k < N_PP; ++k) {
        const int v =
            (((rsel >> k) & 1) ? regval : f[F_P_ENV + k]) & pmask[k];
        s.pp[k] = ((wen >> k) & 1) ? v : s.pp[k];
      }
    }
    if (kind == K_PULSE_WRITE) {
      s.time = wadd(s.time, pv[P_REGWRITE_CLKS]);
    } else {
      // ---- trigger --------------------------------------------------------
      const int M = pv[P_M], P = pv[P_P];
      int trig = wadd(s.offset, f[F_CMD_TIME]);
      if (trig < s.time) s.err |= ERR_MISSED_TRIG;
      trig = max(trig, s.time);
      const int elem = s.pp[4] & 3;
      const int e = min(elem, pv[P_E] - 1);
      const int env_len = (s.pp[0] >> 12) & 0xfff;
      const int dur = env_len == 0xfff ? 0 : du.dur(e, env_len);
      if (s.n_pulses >= P) {
        s.err |= ERR_PULSE_OVERFLOW;
        s.fault |= FAULT_PULSE_OVERFLOW;
      } else if (HIST && s.rec != nullptr) {
        const int vals[N_REC] = {f[F_CMD_TIME], trig, s.pp[0], s.pp[1],
                                 s.pp[2], s.pp[3], s.pp[4], elem, dur};
#pragma unroll
        for (int k = 0; k < N_REC; ++k) s.rec[k * P + s.n_pulses] = vals[k];
      }
      s.n_pulses += 1;
      if (FUSED) parity_step(s, elem, prm);
      if (elem == pv[P_MEAS_ELEM]) {
        const int slot = min(s.n_meas, M - 1);
        if (s.n_meas >= M) {
          s.err |= ERR_MEAS_OVERFLOW;
          s.fault |= FAULT_MEAS_OVERFLOW;
        }
        s.meas_avail[slot] = wadd(wadd(trig, dur), pv[P_MEAS_LATENCY]);
        // the lut fabric's production clock: the trigger time
        if (LUT && s.meas_time != nullptr) s.meas_time[slot] = trig;
        if (FUSED && READOUT)
          fused_readout(s, slot, trig, env_len, du.nsamp(e, env_len), c, prm,
                        ro);
        else if (FUSED)
          latch_window(s, slot, trig, env_len);
        s.n_meas += 1;
      }
      s.time = wadd(trig, pv[P_LOAD_CLKS]);
    }
  } else {
    switch (kind) {
      case K_REG_ALU: {
        const int res = alu(f[F_ALU_OP], alu_in0(regs, f),
                            reg_read(regs, f[F_IN1_REG]));
        const int out_reg = f[F_OUT_REG];
        if (out_reg >= 0 && out_reg < N_REGS) regs[out_reg] = res;
        s.time = wadd(s.time, pv[P_ALU_CLKS]);
        break;
      }
      case K_INC_QCLK: {
        const int res =
            alu(f[F_ALU_OP], alu_in0(regs, f), wsub(s.time, s.offset));
        s.offset = wsub(s.time, res);
        s.time = wadd(s.time, pv[P_ALU_CLKS]);
        break;
      }
      case K_JUMP_I:
      case K_JUMP_COND: {
        const bool taken =
            kind == K_JUMP_I || (alu(f[F_ALU_OP], alu_in0(regs, f),
                                     reg_read(regs, f[F_IN1_REG])) & 1);
        s.time = wadd(s.time, pv[P_JCOND_CLKS]);
        if (taken) pc_next = jump_to(s, f, pv[P_N]);
        break;
      }
      case K_ALU_FPROC:
      case K_JUMP_FPROC: {
        const int req = s.time;
        int f_data = 0, t_ready = req;
        if (LUT && pr.lut != nullptr) {
          int t_lut = 0;
          const int st = lut_read(pr, c, req, prm, &f_data, &t_lut);
          if (st == 1) {
            // starved: halted at the read, pc and time frozen
            s.err |= ERR_FPROC_DEADLOCK;
            s.fault |= FAULT_FPROC_STARVED;
            s.done = true;
            return true;
          }
          if (st == 2) return false;
          t_ready = max(req, t_lut);
        } else {
          // own-core sticky read: the bit of the latest measurement
          // available at the request
          const int M = pv[P_M];
          const int lo = wsub(req, STICKY_RACE_MARGIN);
          const int hi = wadd(req, STICKY_RACE_MARGIN);
          int m_cnt = 0;
          bool race = false;
          for (int m = 0; m < M; ++m) {
            const int a = s.meas_avail[m];
            m_cnt += a <= req;
            race |= a > lo && a <= hi;
          }
          const int latest = m_cnt > 0 ? m_cnt - 1 : 0;
          if (FUSED && m_cnt > 0 && s.valid[latest] == 0) return false;
          f_data = m_cnt > 0 ? s.bits_rd[latest] : 0;
          if (race) s.err |= ERR_STICKY_RACE;
        }
        const int res = alu(f[F_ALU_OP], alu_in0(regs, f), f_data);
        s.time = wadd(t_ready, pv[P_JFPROC_CLKS]);
        if (kind == K_ALU_FPROC) {
          const int out_reg = f[F_OUT_REG];
          if (out_reg >= 0 && out_reg < N_REGS) regs[out_reg] = res;
        } else if (res & 1) {
          pc_next = jump_to(s, f, pv[P_N]);
        }
        break;
      }
      case K_PULSE_RESET: {
        const int R = pv[P_R];
        s.rst_time[min(s.n_resets, R - 1)] = s.time;
        if (s.n_resets >= R) s.fault |= FAULT_RESET_OVERFLOW;
        s.n_resets += 1;
        s.time = wadd(s.time, pv[P_REGWRITE_CLKS]);
        break;
      }
      case K_IDLE: {
        int idle_end = wadd(s.offset, f[F_CMD_TIME]);
        if (s.time > idle_end) s.err |= ERR_MISSED_TRIG;
        idle_end = max(idle_end, s.time);
        s.time = wadd(idle_end, pv[P_LOAD_CLKS]);
        break;
      }
      case K_DONE:
        s.done = true;
        pc_next = s.pc;
        break;
      case K_SYNC:
        break;
      default:
        s.fault |= FAULT_ILLEGAL_OP;
        break;
    }
  }
  if (HIST && s.op_hist != nullptr && (unsigned)kind < N_KINDS)
    s.op_hist[kind] += 1;
  s.pc = pc_next;
  return true;
}

// retire lane `s` of core `c` along its pc, index by index, while the pc
// moves forward past `last` and lies below `lim`; returns false when an
// fproc read's bit is not resolved yet (physics mode: phys_wait)
template <bool FUSED, bool LUT, bool READOUT = FUSED, class DurOf>
__device__ __forceinline__ bool run_rows(Lane& s, int* regs, int& last,
                                         int lim, int c, const int* prog,
                                         const Params& prm, const DurOf& du,
                                         const Readout& ro, const Peers& pr) {
  const int N = prm.v[P_N];
  while (!s.done && s.pc > last && s.pc < lim) {
    last = s.pc;
    if (!exec_row<FUSED, true, LUT, READOUT>(
            s, LocalRegs{regs}, prog + ((size_t)c * N + s.pc) * N_FIELDS, c,
            prm, du, ro, pr))
      return false;
  }
  return true;
}

// what a LUT read of lane `lane` (core `c`) sees of its shot's other
// lanes in the one-thread-per-lane kernels: their counts and planes in
// the output leaves
template <bool FUSED>
__device__ __forceinline__ Peers lane_peers(const Leaves& lv, long long lane,
                                            int c, const Params& prm,
                                            const int* bits_in,
                                            const int* lut) {
  if (lut == nullptr) return Peers{};
  const long long first = lane - c;   // the shot's core 0
  const long long row = first * prm.v[P_M];
  return Peers{lut, out_i(lv, L_N_MEAS) + first, 1,
               out_i(lv, L_MEAS_TIME) + row, out_i(lv, L_MEAS_AVAIL) + row,
               FUSED ? out_i(lv, L_MEAS_BITS) + row : bits_in + row,
               FUSED ? static_cast<const uint8_t*>(lv.out[L_MEAS_VALID]) + row
                     : nullptr};
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

// span mode, one thread per lane (K3, its physics pass with the readout
// left to K2, and K1 where the tile would not fit): each lane walks the
// program index by index along its pc.  A block
// holds whole shots (blockDim.x / C of them on its first threads; the rest
// only help copy the slot rows) and strides over groups of them.  Under the 'lut' fabric
// (`lut` set) the pass splits at the first read index P_MIN_READ: every
// lane of the block retires the indices below it and publishes its
// measurement count, the block synchronises, and the rest of the program
// runs, its LUT reads over final planes of the shot's masked cores (the
// eligibility rule puts every masked core's measurements below the split).
// `prog`: the program table, staged in shared memory where it fits.
template <bool FUSED, bool LUT, bool READOUT>
__device__ __forceinline__ void span_lanes(
    const Leaves& lv, const Params& prm, const int* prog,
    const int* __restrict__ spc, const int* __restrict__ interp,
    const int* __restrict__ bits_in, const Readout& ro,
    const int* __restrict__ lut) {
  const int C = prm.v[P_C], N = prm.v[P_N], E = prm.v[P_E];
  const int split = prm.v[P_MIN_READ];
  const bool two = LUT && lut != nullptr && split < N;
  const long long lanes = (long long)prm.v[P_B] * C;
  // whole shots per block (the launch takes one thread per lane, in no
  // shot order, only for C > THREADS, which the split refuses)
  const int per_block =
      C <= (int)blockDim.x ? blockDim.x - blockDim.x % C : blockDim.x;
  for (long long base = (long long)blockIdx.x * per_block; base < lanes;
       base += (long long)gridDim.x * per_block) {
    const long long lane = base + threadIdx.x;
    const bool act = threadIdx.x < per_block && lane < lanes;
    const int c = (int)(lane % C);
    const DivDur du{spc + (size_t)c * E, interp + (size_t)c * E};
    {
      // the warp's 32 consecutive lanes' slot rows, in -> out
      const long long w0 = base + (threadIdx.x & ~31u);
      const int nw = (int)max(0LL, min(min(w0 + 32, base + per_block),
                                       lanes) - w0);
      copy_slot_rows<FUSED>(lv, prm, w0, nw, threadIdx.x & 31, 32);
      __syncwarp();
    }
    Lane s;
    int regs[N_REGS];
    int last = -1;
    bool ok = true;
    if (act) {
      load_lane<FUSED>(s, regs, lane, lv, prm, bits_in, true);
      ok = run_rows<FUSED, LUT, READOUT>(s, regs, last, two ? split : N, c,
                                         prog, prm, du, ro, Peers{});
    }
    if (two) {
      // the LUT reads below read the shot's counts and planes
      if (act) out_i(lv, L_N_MEAS)[lane] = s.n_meas;
      __syncthreads();
      if (act && ok) {
        last = max(last, split - 1);
        ok = run_rows<FUSED, LUT, READOUT>(
            s, regs, last, N, c, prog, prm, du, ro,
            lane_peers<FUSED>(lv, lane, c, prm, bits_in, lut));
      }
    }
    if (act) {
      store_lane<FUSED>(s, regs, lane, lv);
      // the bit is not resolved yet: phys_wait
      if (FUSED) static_cast<uint8_t*>(lv.out[L_PHYS_WAIT])[lane] = !ok;
    }
  }
}

// K1 (FUSED = false) and K3 (FUSED = true), one thread per lane
template <bool FUSED, bool LUT>
__global__ void __launch_bounds__(THREADS) exec_span_kernel(
    Leaves lv, Params prm, const int* __restrict__ gprog,
    const int* __restrict__ spc, const int* __restrict__ interp,
    const int* __restrict__ bits_in, Readout ro, const int* __restrict__ lut,
    int prog_in_smem) {
  extern __shared__ int sprog[];
  const int* prog = stage_program(gprog, prog_in_smem, prm, sprog);
  span_lanes<FUSED, LUT, FUSED>(lv, prm, prog, spc, interp, bits_in, ro,
                                lut);
}

// K3 with its readout left to K2: the straight-line pass of one epoch of
// the physics loop (sim/physics.py run_physics_batch).  It replaces no TPU
// kernel: the JAX package refuses its megastep kernel in physics mode
// (distributed_processor_tpu/sim/interpreter.py:1864, pallas_ineligible)
// and runs this pass on its XLA engines.
// It shares K3's design because it is K3's pass in all but the readout:
// the parity co-state and the stall at an fproc read whose bit is not
// valid are K3's own, and a measurement latches its window (meas_state,
// amp, phase, freq, env, gtime, meas_avail, n_meas) for the epoch
// resolver and writes no bit.  The carry's meas_bits and meas_valid are
// read in place (the wrapper passes the same pointer in and out), and a
// lane stalled at a read resumes there on the next epoch's launch.  It
// takes no readout tables (P_N_ADDRS = 0).  Bound: K1's ~40 integer
// operations a retired row, or the physics carry's bytes, each lane's read
// once and written once, whichever is larger; at the headline (262144 x 8
// lanes, M = 2) the carry is 0.80 GB a pass (0.24 ms at 3.35 TB/s) and the
// resumed pass retires 74.4M rows (0.18 ms), so it is bound by bytes.
// The one-thread-per-lane design keeps each lane's carry in registers
// between one load and one store, which is what that bound asks for.
template <bool LUT>
__global__ void __launch_bounds__(THREADS) exec_span_physics_kernel(
    Leaves lv, Params prm, const int* __restrict__ gprog,
    const int* __restrict__ spc, const int* __restrict__ interp,
    const int* __restrict__ bits_in, Readout ro, const int* __restrict__ lut,
    int prog_in_smem) {
  extern __shared__ int sprog[];
  const int* prog = stage_program(gprog, prog_in_smem, prm, sprog);
  span_lanes<true, LUT, false>(lv, prm, prog, spc, interp, bits_in, ro, lut);
}

// block mode, one thread per lane (where the tile would not fit): every
// live lane whose pc
// starts a block (bid_at[pc] >= 0) retires that block's deduplicated body,
// rows [start, start + length) of its core's table, with pc advancing by
// one per retired row; every other lane is left untouched.  The carry is
// updated in place.
template <bool LUT>
__global__ void __launch_bounds__(THREADS) exec_blocks_kernel(
    Leaves lv, Params prm, const int* __restrict__ gprog,
    const int* __restrict__ spc, const int* __restrict__ interp,
    const int* __restrict__ bid_at, const int* __restrict__ bodies,
    int prog_in_smem) {
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
    const DivDur du{spc + (size_t)c * E, interp + (size_t)c * E};
    Lane s;
    int regs[N_REGS];
    load_lane<false>(s, regs, lane, lv, prm, nullptr, false);
    for (int r = 0; r < length && !s.done; ++r)
      exec_row<false, true, LUT>(s, LocalRegs{regs},
                            prog + ((size_t)c * N + start + r) * N_FIELDS, c,
                            prm, du, none, Peers{});
    store_lane<false>(s, regs, lane, lv);
  }
}

// ---- the tile kernel: K1 span and K1 block -----------------------------------

// the leaf of each staged scalar column but done
__host__ __device__ constexpr int scalar_leaf(int q) {
  return q == S_PC ? L_PC : q == S_TIME ? L_TIME : q == S_OFFSET ? L_OFFSET
       : q == S_ERR ? L_ERR : q == S_FAULT ? L_FAULT
       : q == S_N_PULSES ? L_N_PULSES : q == S_N_RESETS ? L_N_RESETS
       : L_N_MEAS;
}

// the tile's shape (ops/exec_span.py tile_geometry): `sub` rows of 32 shots
// x C cores, `warps` warps per block, the staged columns `kst` words apart,
// an item's 32 lanes at `pitch` words
struct Tile {
  int sub, warps, kst, pitch;
};

// stage the tile's lanes in (IN) or out: consecutive threads on
// consecutive lanes of the leaves' own order, each thread moving every
// staged word of its lane at once (the register row as 16-byte vectors
// where aligned), so that a lane costs one memory latency.  Lane l sits at
// column word slot[l]; `pick`: only the lanes l with pick[l] >= 0 (block
// mode), or every lane when null.
template <bool IN>
__device__ __forceinline__ void tile_stage(const Leaves& lv, int* regs_s,
                                           int* pp_s, int* sc_s, int kst,
                                           const int* slot, const int* pick,
                                           long long l0, int n) {
  const void* gregs = IN ? lv.in[L_REGS] : lv.out[L_REGS];
  const bool vec = ((uintptr_t)gregs & 15) == 0;
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    if (pick != nullptr && pick[l] < 0) continue;
    const long long lane = l0 + l;
    const int sl = slot[l];
    int r[N_REGS], p[N_PP], q[N_SCALARS];
    if (IN) {
      const int* g = in_i(lv, L_REGS) + lane * N_REGS;
      if (vec) {
#pragma unroll
        for (int k = 0; k < N_REGS / 4; ++k) {
          const int4 v = reinterpret_cast<const int4*>(g)[k];
          r[4 * k] = v.x;
          r[4 * k + 1] = v.y;
          r[4 * k + 2] = v.z;
          r[4 * k + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < N_REGS; ++k) r[k] = g[k];
      }
#pragma unroll
      for (int k = 0; k < N_PP; ++k) p[k] = in_i(lv, L_PP)[lane * N_PP + k];
#pragma unroll
      for (int k = 0; k < N_SCALARS - 1; ++k)
        q[k] = in_i(lv, scalar_leaf(k))[lane];
      q[S_DONE] = static_cast<const uint8_t*>(lv.in[L_DONE])[lane];
#pragma unroll
      for (int k = 0; k < N_REGS; ++k) regs_s[k * kst + sl] = r[k];
#pragma unroll
      for (int k = 0; k < N_PP; ++k) pp_s[k * kst + sl] = p[k];
#pragma unroll
      for (int k = 0; k < N_SCALARS; ++k) sc_s[k * kst + sl] = q[k];
    } else {
#pragma unroll
      for (int k = 0; k < N_REGS; ++k) r[k] = regs_s[k * kst + sl];
#pragma unroll
      for (int k = 0; k < N_PP; ++k) p[k] = pp_s[k * kst + sl];
#pragma unroll
      for (int k = 0; k < N_SCALARS; ++k) q[k] = sc_s[k * kst + sl];
      int* g = out_i(lv, L_REGS) + lane * N_REGS;
      if (vec) {
#pragma unroll
        for (int k = 0; k < N_REGS / 4; ++k)
          reinterpret_cast<int4*>(g)[k] =
              make_int4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < N_REGS; ++k) g[k] = r[k];
      }
#pragma unroll
      for (int k = 0; k < N_PP; ++k) out_i(lv, L_PP)[lane * N_PP + k] = p[k];
#pragma unroll
      for (int k = 0; k < N_SCALARS - 1; ++k)
        out_i(lv, scalar_leaf(k))[lane] = q[k];
      static_cast<uint8_t*>(lv.out[L_DONE])[lane] = q[S_DONE] != 0;
    }
  }
}

// block mode: each thread reads its lanes' pc and done and, for a lane
// that may run a body, its staged words in the same pass, then keeps the
// lane (bid_l[l] = its block id) only where bid_at[pc] names a body.
// Returns whether any lane of the tile runs a body.
__device__ __forceinline__ int tile_pick_stage(
    const Leaves& lv, int* regs_s, int* pp_s, int* sc_s, int kst,
    const int* slot, int* bid_l, const int* __restrict__ bid_at, int N,
    long long l0, int n, int L) {
  const bool vec = (reinterpret_cast<uintptr_t>(lv.in[L_REGS]) & 15) == 0;
  int any = 0;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    int b = -1;
    if (l < n) {
      const long long lane = l0 + l;
      const int pc = in_i(lv, L_PC)[lane];
      const bool done = static_cast<const uint8_t*>(lv.in[L_DONE])[lane];
      if (!done && pc >= 0 && pc < N) {
        int r[N_REGS], p[N_PP], q[N_SCALARS];
        const int* g = in_i(lv, L_REGS) + lane * N_REGS;
        b = bid_at[pc];
        if (vec) {
#pragma unroll
          for (int k = 0; k < N_REGS / 4; ++k) {
            const int4 v = reinterpret_cast<const int4*>(g)[k];
            r[4 * k] = v.x;
            r[4 * k + 1] = v.y;
            r[4 * k + 2] = v.z;
            r[4 * k + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < N_REGS; ++k) r[k] = g[k];
        }
#pragma unroll
        for (int k = 0; k < N_PP; ++k) p[k] = in_i(lv, L_PP)[lane * N_PP + k];
#pragma unroll
        for (int k = 1; k < N_SCALARS - 1; ++k)
          q[k] = in_i(lv, scalar_leaf(k))[lane];
        q[S_PC] = pc;
        q[S_DONE] = 0;
        if (b >= 0) {
          const int sl = slot[l];
#pragma unroll
          for (int k = 0; k < N_REGS; ++k) regs_s[k * kst + sl] = r[k];
#pragma unroll
          for (int k = 0; k < N_PP; ++k) pp_s[k * kst + sl] = p[k];
#pragma unroll
          for (int k = 0; k < N_SCALARS; ++k) sc_s[k * kst + sl] = q[k];
        }
      }
    }
    bid_l[l] = b;
    any |= b >= 0;
  }
  return __syncthreads_or(any);
}

// one lane of the tile in from the staged columns, with its slot rows at
// `lane` of the output leaves: the fields exec_row reads
__device__ __forceinline__ void tile_load_lane(Lane& s, long long lane,
                                               int sl, int kst,
                                               const int* pp_s,
                                               const int* sc_s,
                                               const Leaves& lv,
                                               const Params& prm,
                                               const int* bits_in) {
  const int M = prm.v[P_M], R = prm.v[P_R], P = prm.v[P_P];
  s.rst_time = lv.out[L_RST_TIME] ? out_i(lv, L_RST_TIME) + lane * R
                                  : nullptr;
  s.meas_avail = lv.out[L_MEAS_AVAIL] ? out_i(lv, L_MEAS_AVAIL) + lane * M
                                      : nullptr;
  s.meas_time = lv.out[L_MEAS_TIME] ? out_i(lv, L_MEAS_TIME) + lane * M
                                    : nullptr;
  s.rec = lv.out[L_REC] ? out_i(lv, L_REC) + lane * N_REC * P : nullptr;
  s.op_hist = lv.out[L_OP_HIST] ? out_i(lv, L_OP_HIST) + lane * N_KINDS
                                : nullptr;
  s.bits_rd = bits_in ? bits_in + lane * M : nullptr;
#pragma unroll
  for (int k = 0; k < N_PP; ++k) s.pp[k] = pp_s[k * kst + sl];
  s.pc = sc_s[S_PC * kst + sl];
  s.time = sc_s[S_TIME * kst + sl];
  s.offset = sc_s[S_OFFSET * kst + sl];
  s.err = sc_s[S_ERR * kst + sl];
  s.fault = sc_s[S_FAULT * kst + sl];
  s.n_pulses = sc_s[S_N_PULSES * kst + sl];
  s.n_resets = sc_s[S_N_RESETS * kst + sl];
  s.n_meas = sc_s[S_N_MEAS * kst + sl];
  s.done = sc_s[S_DONE * kst + sl] != 0;
}

__device__ __forceinline__ void tile_store_lane(const Lane& s, int sl,
                                                int kst, int* pp_s,
                                                int* sc_s) {
#pragma unroll
  for (int k = 0; k < N_PP; ++k) pp_s[k * kst + sl] = s.pp[k];
  sc_s[S_PC * kst + sl] = s.pc;
  sc_s[S_TIME * kst + sl] = s.time;
  sc_s[S_OFFSET * kst + sl] = s.offset;
  sc_s[S_ERR * kst + sl] = s.err;
  sc_s[S_FAULT * kst + sl] = s.fault;
  sc_s[S_N_PULSES * kst + sl] = s.n_pulses;
  sc_s[S_N_RESETS * kst + sl] = s.n_resets;
  sc_s[S_N_MEAS * kst + sl] = s.n_meas;
  sc_s[S_DONE * kst + sl] = s.done ? 1 : 0;
}

// the shared memory of the tile kernel's tile, in words: the lane -> slot
// map, block mode's block id per lane, the register file, pp and the
// scalar columns (ops/exec_span.py tile_geometry counts the same, with
// the Dur table)
__host__ __device__ __forceinline__ size_t tile_words(const Tile& tg, int C,
                                                      bool blocks) {
  const size_t lanes = (size_t)tg.sub * TILE_SHOTS * C;
  return lanes * (blocks ? 2 : 1) + (size_t)tg.kst * (N_REGS + N_PP +
                                                       N_SCALARS);
}

// K1 span (BLOCKS = false: one ascending pass per warp, out of place) and
// K1 block (BLOCKS = true: each running lane retires its block's body, in
// place) over tiles of `sub` x 32 shots x C cores, a persistent grid
// striding over the tiles, the carry tile in shared memory (block mode
// stages only the running lanes and skips a tile with none).  PROG_SMEM:
// the program table staged in shared memory beside the tile (else read
// through L1).  HIST: the carry holds pulse records or the opcode
// histogram.
template <bool BLOCKS, bool PROG_SMEM, bool HIST, bool LUT>
__global__ void __launch_bounds__(TILE_MAX_THREADS, 2) exec_tile_kernel(
    Leaves lv, Params prm, Tile tg, const int* __restrict__ gprog,
    const int* __restrict__ spc,
    const int* __restrict__ interp, const int* __restrict__ bits_in,
    const int* __restrict__ bid_at, const int* __restrict__ bodies,
    const int* __restrict__ lut) {
  extern __shared__ int4 smem4[];   // 16-byte aligned
  int* smem = reinterpret_cast<int*>(smem4);
  const int B = prm.v[P_B], C = prm.v[P_C], N = prm.v[P_N], E = prm.v[P_E];
  const int items = tg.sub * C, L = items * TILE_SHOTS, kst = tg.kst;
  int* slot = smem;
  int* bid_l = slot + L;   // block mode only
  int* regs_s = bid_l + (BLOCKS ? L : 0);
  int* pp_s = regs_s + N_REGS * kst;
  int* sc_s = pp_s + N_PP * kst;
  // after the tile: the Dur table [C][DUR_ELEMS], then the program
  const int tw = (int)tile_words(tg, C, BLOCKS);
  Dur* dur = reinterpret_cast<Dur*>(smem + tw);
  for (int k = threadIdx.x; k < C * DUR_ELEMS; k += blockDim.x) {
    const int c = k / DUR_ELEMS, e = min(k % DUR_ELEMS, E - 1);
    dur[k] = make_dur(spc[c * E + e], interp[c * E + e]);
  }
  const int* prog = gprog;
  if (PROG_SMEM) {
    // 16-byte aligned after the Dur table (indexed from the shared array,
    // so that row reads stay shared-memory loads); 16-byte copies, four
    // in flight
    int* sprog = smem + ((tw + C * DUR_ELEMS * 4 + 3) & ~3);
    const int n = C * N * N_FIELDS;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(gprog) & 15) == 0) {
#pragma unroll 4
      for (int k = threadIdx.x; k < n / 4; k += blockDim.x)
        reinterpret_cast<int4*>(sprog)[k] =
            reinterpret_cast<const int4*>(gprog)[k];
      head = n / 4 * 4;
    }
    for (int k = head + threadIdx.x; k < n; k += blockDim.x)
      sprog[k] = gprog[k];
    prog = sprog;
  }
  // lane l = t * C + c of a tile (t its shot in the tile) is item
  // (t / 32) * C + c, slot item * pitch + t % 32
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int t = l / C, c = l - t * C;
    slot[l] = ((t / TILE_SHOTS) * C + c) * tg.pitch + t % TILE_SHOTS;
  }
  const Readout none = {nullptr, nullptr, nullptr, nullptr, 1.0f};
  const long long lanes = (long long)B * C;
  const long long n_tiles =
      ((long long)B + tg.sub * TILE_SHOTS - 1) / (tg.sub * TILE_SHOTS);
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  // span mode under the 'lut' fabric: two phases split at the first read
  // index, every lane of the tile retiring the indices below it first
  const int split = prm.v[P_MIN_READ], M = prm.v[P_M];
  const int phases = !BLOCKS && LUT && lut != nullptr && split < N ? 2 : 1;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long l0 = tile * L;
    const int n = (int)min((long long)L, lanes - l0);
    __syncthreads();   // the previous tile is written back
    if (BLOCKS) {
      if (!tile_pick_stage(lv, regs_s, pp_s, sc_s, kst, slot, bid_l, bid_at,
                           N, l0, n, L))
        continue;
    } else {
      tile_copy(lv, L_RST_TIME, prm.v[P_R], l0, n);
      tile_copy(lv, L_MEAS_AVAIL, M, l0, n);
      tile_copy(lv, L_MEAS_TIME, M, l0, n);
      tile_copy(lv, L_REC, N_REC * prm.v[P_P], l0, n);
      tile_copy(lv, L_OP_HIST, N_KINDS, l0, n);
      tile_stage<true>(lv, regs_s, pp_s, sc_s, kst, slot, nullptr, l0, n);
    }
    for (int ph = 0; ph < phases; ++ph) {
      // the tile is staged (phase 0), or phase 0 has stored every lane
      __syncthreads();
      const int lim = ph + 1 < phases ? split : N;
      for (int item = warp; item < items; item += tg.warps) {
        const int j = item / C, c = item - j * C;
        const int l = (j * TILE_SHOTS + ln) * C + c;
        const long long lane = l0 + l;
        const int sl = item * tg.pitch + ln;
        const TileRegs regs{regs_s + sl, kst};
        const int* row0 = prog + (size_t)c * N * N_FIELDS;
        const TabDur du{dur + c * DUR_ELEMS};
        const int bid = BLOCKS && l < n ? bid_l[l] : -1;
        const bool run = l < n && (!BLOCKS || bid >= 0);
        Lane s;
        Peers pr{};
        if (run) {
          tile_load_lane(s, lane, sl, kst, pp_s, sc_s, lv, prm,
                         BLOCKS ? nullptr : bits_in);
          if (LUT && ph == 1) {
            // the shot's other cores: counts in the staged column (items
            // C apart hold one shot's cores), planes in the output leaves
            const long long row = (lane - c) * M;
            pr = Peers{lut, sc_s + S_N_MEAS * kst + sl - c * tg.pitch,
                       tg.pitch, out_i(lv, L_MEAS_TIME) + row,
                       out_i(lv, L_MEAS_AVAIL) + row, bits_in + row, nullptr};
          }
        }
        if (BLOCKS) {
          // one body at a time, for the lanes whose block id selects it
          bool pend = run;
          for (unsigned m; (m = __ballot_sync(FULL, pend)) != 0;) {
            const int b = __shfl_sync(FULL, bid, __ffs(m) - 1);
            if (pend && bid == b) {
              const int start = bodies[2 * b], length = bodies[2 * b + 1];
              for (int r = 0; r < length && !s.done; ++r)
                exec_row<false, HIST, LUT>(s, regs,
                                      row0 + (size_t)(start + r) * N_FIELDS, c,
                                      prm, du, none, pr);
              pend = false;
            }
          }
        } else {
          // ascending over the indices the live lanes stand at
          for (int cur = ph ? split - 1 : -1;;) {
            const bool live = run && !s.done && s.pc > cur && s.pc < lim;
            const int i = __reduce_min_sync(FULL, live ? s.pc : INT32_MAX);
            if (i == INT32_MAX) break;
            if (live && s.pc == i)
              exec_row<false, HIST, LUT>(s, regs,
                                         row0 + (size_t)i * N_FIELDS, c, prm,
                                         du, none, pr);
            cur = i;
          }
        }
        if (run) tile_store_lane(s, sl, kst, pp_s, sc_s);
      }
    }
    __syncthreads();
    tile_stage<false>(lv, regs_s, pp_s, sc_s, kst, slot,
                      BLOCKS ? bid_l : nullptr, l0, n);
  }
}

// what the card holds of one kernel at one block size and shared-memory
// size: the SM count and the blocks an SM takes, asked once per (kernel,
// device, threads, shared memory) under a lock, since a launch per
// block-engine iteration would otherwise ask every time.  The first
// question for a kernel on a device raises its dynamic shared-memory
// limit to the card's most, so no launch ever lowers it under another's.
struct Occupancy {
  const void* fn;
  int dev, threads;
  size_t smem;
  int sms, per_sm;
};

cudaError_t occupancy(const void* fn, int threads, size_t smem, int* sms,
                      int* per_sm) {
  static std::mutex mu;
  static std::vector<Occupancy> known;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const std::lock_guard<std::mutex> lock(mu);
  bool raised = false;
  for (const Occupancy& o : known) {
    if (o.fn != fn || o.dev != dev) continue;
    raised = true;
    if (o.threads == threads && o.smem == smem) {
      *sms = o.sms;
      *per_sm = o.per_sm;
      return cudaSuccess;
    }
  }
  Occupancy o = {fn, dev, threads, smem, 0, 0};
  int most = 0;
  rc = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess && !raised)
    rc = cudaDeviceGetAttribute(&most,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess && !raised)
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              most);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, fn,
                                                       threads, smem);
  if (rc != cudaSuccess) return rc;
  // programs of many sizes: forget the oldest answers (asking again is
  // only slower)
  if (known.size() >= 64) known.erase(known.begin());
  known.push_back(o);
  *sms = o.sms;
  *per_sm = o.per_sm;
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

// the one-thread-per-lane kernels' launch (K3, and K1 where the tile
// would not fit): a grid-stride loop over the B * C lanes, each block
// staging the program in shared memory where it fits.  `threads`: the
// block size
template <typename Kernel, typename... Args>
int launch_lanes(Kernel kernel, const Params& prm, int threads,
                 cudaStream_t stream, Args... args) {
  const long long lanes = (long long)prm.v[P_B] * prm.v[P_C];
  const size_t prog_bytes =
      (size_t)prm.v[P_C] * prm.v[P_N] * N_FIELDS * sizeof(int);
  const int in_smem = prog_bytes <= MAX_SMEM_PROG;
  const size_t smem = in_smem ? prog_bytes : 0;
  int sms = 0, per_sm = 0;
  const cudaError_t rc = occupancy(reinterpret_cast<const void*>(kernel),
                                   threads, smem, &sms, &per_sm);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (lanes + threads - 1) / threads;
  const int grid =
      (int)(blocks < (long long)sms * 8 ? blocks : (long long)sms * 8);
  kernel<<<grid, threads, smem, stream>>>(args..., in_smem);
  return (int)cudaGetLastError();
}

// the span kernels' block size: THREADS, of which the kernel gives whole
// shots of C lanes to the first THREADS - THREADS % C; past THREADS cores
// one thread per lane in no shot order, which a split pass (the 'lut'
// fabric with a read) cannot take (-1)
int span_threads(const Params& prm, const int* lut) {
  return prm.v[P_C] > THREADS && lut != nullptr &&
                 prm.v[P_MIN_READ] < prm.v[P_N]
             ? -1
             : THREADS;
}

// the tile kernel's launch: a persistent grid of as many blocks as the
// card holds at once, each striding over the tiles
template <bool BLOCKS, bool PROG_SMEM, bool HIST, bool LUT>
int launch_tile(const Leaves& lv, const Params& prm, const Tile& tg,
                const int* prog, const int* spc, const int* interp,
                const int* bits_in, const int* bid_at, const int* bodies,
                const int* lut, size_t smem, cudaStream_t stream) {
  const auto kernel = exec_tile_kernel<BLOCKS, PROG_SMEM, HIST, LUT>;
  const int threads = tg.warps * 32;
  int sms = 0, per_sm = 0;
  const cudaError_t rc = occupancy(reinterpret_cast<const void*>(kernel),
                                   threads, smem, &sms, &per_sm);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = ((long long)prm.v[P_B] + tg.sub * TILE_SHOTS - 1)
                            / (tg.sub * TILE_SHOTS);
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(n_tiles < most ? n_tiles : most);
  kernel<<<grid, threads, smem, stream>>>(lv, prm, tg, prog, spc, interp,
                                          bits_in, bid_at, bodies, lut);
  return (int)cudaGetLastError();
}

// the tile kernel with the program in shared memory where it fits beside
// the tile and the Dur table
template <bool BLOCKS, bool HIST, bool LUT>
int launch_tile(const Leaves& lv, const Params& prm, const Tile& tg,
                const int* prog, const int* spc, const int* interp,
                const int* bits_in, const int* bid_at, const int* bodies,
                const int* lut, cudaStream_t stream) {
  const size_t tile = tile_words(tg, prm.v[P_C], BLOCKS) * 4 +
                      (size_t)prm.v[P_C] * DUR_ELEMS * sizeof(Dur);
  const size_t prog_bytes =
      (size_t)prm.v[P_C] * prm.v[P_N] * N_FIELDS * sizeof(int) + 16;
  if (tile + prog_bytes <= MAX_SMEM_BLOCK)
    return launch_tile<BLOCKS, true, HIST, LUT>(lv, prm, tg, prog, spc,
                                                interp,
                                           bits_in, bid_at, bodies, lut,
                                           tile + prog_bytes, stream);
  return launch_tile<BLOCKS, false, HIST, LUT>(lv, prm, tg, prog, spc,
                                               interp,
                                          bits_in, bid_at, bodies, lut, tile,
                                          stream);
}

// the tile kernel, specialised on whether the carry holds pulse records
// or the opcode histogram, and on the 'lut' fabric (its meas_time plane;
// in span mode its reads)
template <bool BLOCKS, bool LUT>
int launch_tile(const Leaves& lv, const Params& prm, const Tile& tg,
                const int* prog, const int* spc, const int* interp,
                const int* bits_in, const int* bid_at, const int* bodies,
                const int* lut, cudaStream_t stream) {
  if (tg.warps < 1 || tg.warps * 32 > TILE_MAX_THREADS ||
      tg.pitch < TILE_SHOTS || tg.kst < tg.sub * prm.v[P_C] * tg.pitch)
    return (int)cudaErrorInvalidValue;
  if (lv.out[L_REC] != nullptr || lv.out[L_OP_HIST] != nullptr)
    return launch_tile<BLOCKS, true, LUT>(lv, prm, tg, prog, spc, interp,
                                          bits_in,
                                     bid_at, bodies, lut, stream);
  return launch_tile<BLOCKS, false, LUT>(lv, prm, tg, prog, spc, interp,
                                         bits_in,
                                    bid_at, bodies, lut, stream);
}

}  // namespace

// Launch one span pass on `stream`.  in_ptrs/out_ptrs: N_LEAVES device
// pointers each (0 = leaf absent; out may equal in).  params: N_PARAMS ints.
// prog: [C, N, N_FIELDS] int32; spc/interp: [C, E] int32.  K1 (fused = 0)
// reads the injected bits_in [B, C, M] int32; K3 (fused = 1) carries the
// bits in the L_MEAS_BITS/L_MEAS_VALID leaves and reads the energy prefix
// e2p [C, n_addrs, Wp] float32 (Wp = params[P_WP] > W), g0/g1 [C, 2]
// float32 and addrs [n_addrs] int32.  fused = 2: K3's physics pass with
// the readout left to K2, which reads those two leaves and writes neither
// (the wrapper passes them in place, in = out) and takes no readout tables
// (n_addrs = 0).  lut: under the 'lut' fabric, int32
// [C + params[P_LUT_N]]: each core's address shift (-1: not masked), then
// the table; the carry then holds L_MEAS_TIME and the pass splits at
// params[P_MIN_READ]; null under the sticky fabric.  tile: the tile's sub,
// warps, column stride and slot pitch (ops/exec_span.py tile_geometry)
// for K1's tile kernel, or sub = 0 for one thread per lane (K3 runs only
// that).  Returns the launch's cudaError as an int (0 = launched).
extern "C" int dp_exec_span(const unsigned long long* in_ptrs,
                            const unsigned long long* out_ptrs, int n_leaves,
                            const int* params, int n_params, const int* prog,
                            const int* spc, const int* interp,
                            const int* bits_in, const float* e2p,
                            const float* g0, const float* g1,
                            const int* addrs, const int* lut,
                            float amp_scale, int fused, const int* tile,
                            void* stream) {
  const Tile tg = {tile[0], tile[1], tile[2], tile[3]};
  if (n_leaves != N_LEAVES || n_params != N_PARAMS || fused < 0 ||
      fused > 2 || (fused && tg.sub != 0))
    return (int)cudaErrorInvalidValue;
  const Leaves lv = leaves(in_ptrs, out_ptrs);
  const Params prm = params_of(params);
  if ((long long)prm.v[P_B] * prm.v[P_C] == 0) return 0;
  if (lut != nullptr && lv.out[L_MEAS_TIME] == nullptr)
    return (int)cudaErrorInvalidValue;
  const Readout ro = {e2p, g0, g1, addrs, amp_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused || tg.sub == 0) {
    const int threads = span_threads(prm, lut);
    if (threads < 0) return (int)cudaErrorInvalidConfiguration;
    const auto kernel =
        fused == 2 ? (lut ? exec_span_physics_kernel<true>
                          : exec_span_physics_kernel<false>)
        : fused    ? (lut ? exec_span_kernel<true, true>
                          : exec_span_kernel<true, false>)
                   : (lut ? exec_span_kernel<false, true>
                          : exec_span_kernel<false, false>);
    return launch_lanes(kernel, prm, threads, s, lv, prm, prog, spc, interp,
                        bits_in, ro, lut);
  }
  if (lut != nullptr)
    return launch_tile<false, true>(lv, prm, tg, prog, spc, interp, bits_in,
                                    nullptr, nullptr, lut, s);
  return launch_tile<false, false>(lv, prm, tg, prog, spc, interp, bits_in,
                                   nullptr, nullptr, nullptr, s);
}

// Launch one block-mode pass on `stream`, updating the carry in place:
// ptrs holds N_LEAVES device pointers (0 = leaf absent).  bid_at: [N]
// int32 block id of each program index (-1: no block starts there);
// bodies: [n_bodies, 2] int32 (start, length) of each deduplicated body.
// tile as for dp_exec_span.  Returns the launch's cudaError as an int (0 =
// launched).
extern "C" int dp_exec_blocks(const unsigned long long* ptrs, int n_leaves,
                              const int* params, int n_params,
                              const int* prog, const int* spc,
                              const int* interp, const int* bid_at,
                              const int* bodies, const int* tile,
                              void* stream) {
  if (n_leaves != N_LEAVES || n_params != N_PARAMS)
    return (int)cudaErrorInvalidValue;
  const Leaves lv = leaves(ptrs, ptrs);
  const Params prm = params_of(params);
  if ((long long)prm.v[P_B] * prm.v[P_C] == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tile tg = {tile[0], tile[1], tile[2], tile[3]};
  // a 'lut'-fabric carry: measurements write its meas_time plane
  const bool lut = lv.out[L_MEAS_TIME] != nullptr;
  if (tg.sub == 0)
    return launch_lanes(lut ? exec_blocks_kernel<true>
                            : exec_blocks_kernel<false>,
                        prm, THREADS, s, lv, prm, prog, spc, interp, bid_at,
                        bodies);
  if (lut)
    return launch_tile<true, true>(lv, prm, tg, prog, spc, interp, nullptr,
                                   bid_at, bodies, nullptr, s);
  return launch_tile<true, false>(lv, prm, tg, prog, spc, interp, nullptr,
                                  bid_at,
                           bodies, nullptr, s);
}
