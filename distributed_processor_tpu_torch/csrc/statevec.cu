// The statevec device's step for Hopper (sm_90a): one launch runs one
// generic-engine step's statevec block for every shot.
//
// It replaces no TPU kernel: the JAX package runs this block in XLA
// (distributed_processor_tpu/sim/interpreter.py, _step's statevec block).
// The port's plain version is the eager block
// sim/interpreter.py:_statevec_pulse, which the CPU takes and which the
// card tests hold this kernel against; ops/statevec.py is the wrapper.
// For each shot (a [2^C] complex64 trajectory, core c on bit C-1-c of the
// basis index) it computes what that block computes, in its order:
//   the co-fire check (ERR_COFIRE_ORDER on a coupling's control core);
//   (1) detuning precession over each touched core's gap, one diagonal Rz;
//   (2) per touched core, the T1 quantum jump (or the no-jump damping and
//       its sqrt(1 - p_dec P(1)) normalisation), then the dephasing flip;
//   (3) per 1q-driven core, its rotation with the 1q Pauli folded in
//       (P @ U), then the 1q leakage channel;
//   (4) per coupling pulse in list order, the ZX or ZZ rotation, the 2q
//       Pauli, then the control's coupling-induced leakage;
//   (5) per measured core in order, the projective collapse, each
//       conditioned on the cores before it; then seepage;
// and writes the new psi, leaked, phys_t and meas_p1, the state bit and
// the co-fire word.  The arithmetic is the eager block's: float32 and
// complex64, the same clamp(min=1e-12) guards, the same thresholds
// against the same uniforms (the trajectory's, drawn once by the engine's
// step for whichever path runs the block, and the measurement uniform of
// each core's slot).  Products that the eager block rounds apart from a later add or
// comparison are rounded apart here too (__fmul_rn), so no fused
// multiply-add moves a threshold.  Sums are taken in another order than
// torch's reductions: amplitudes agree to float32 rounding, and a decision
// can differ only where a uniform lies within rounding of its threshold.
//
// Untouched cores.  A shot reads its own fire / is_meas row first and
// skips every stage of a core it does not touch.  That is exact: on such a
// core the eager block's updates are identities (dt = 0 gives p_dec = 0,
// damping 1 and norm 1, and no uniform is below 0; theta = 0 gives the
// identity rotation; no Pauli is picked; the projection is masked off).
// A shot that touches no core copies its state and leaves the rest as it
// was.
//
// Bound.  The launch reads psi once and writes it once (out of place: the
// input state is left as it was), so it is bound by psi's bytes: at
// B = 131072, C = 8, 2 x 268 MB = 0.537 GB, 0.160 ms at 3.35 TB/s.  The
// per-core words, uniforms and meas_p1 bring it to 0.642 GB, 0.192 ms.
//
// Design.  One warp owns one shot.  The warp loads the shot's 8 * 2^C
// bytes into its slice of shared memory with 16-byte coalesced loads
// (lane l takes amplitude pairs l, l + 32, ...: neighbouring lanes on
// neighbouring addresses), runs every stage on it there and stores it the
// same way, so the state crosses HBM once each way whatever the number of
// updates.  An update on core c is one walk of the warp over the state: a
// diagonal scale over the amplitudes (lane l takes indices l, l + 32,
// ...), or a 2x2 map over the 2^(C-1) amplitude pairs that differ in bit
// q = C-1-c (lane l takes pairs l, l + 32, ..., each pair read and written
// by one lane), each walk closed by __syncwarp.  A core's P(1) is a
// lane-local sum then a 5-step xor butterfly, whose result every lane
// holds bit for bit (float addition commutes), so every lane takes the
// same branch.  The per-core words of the shot (triggers, phase and
// frequency words, amplitudes, gaps, uniforms) sit beside the state in
// shared memory, read by lane c, and the control flow (which cores and
// couplings fire, which branches) is uniform across the warp.  One
// algorithm serves every C from 1 to 12: the bit of a core is a runtime
// shift, and the layout adapts by warps per block (8 below C = 11, where
// a warp's slice is 2.5 KB at C = 8; 2 at C = 11; 1 at C = 12, 33 KB).  The
// other layout, amplitudes in registers with the high bits on the lanes,
// needs each register bit as a compile-time index (else the array spills
// to local memory), so a template per C and per bit, and shared memory
// past C = 10 all the same.  The walks, not HBM, set this kernel's time:
// about 0.6 ms at B = 131072, C = 8 with each core firing a quarter of the
// time, 3.3x the bound, a small share of a generic-engine step's cost.
//
// Integers.  The gap trig - phys_t wraps in int32 as torch's does (done in
// uint32).  The slot index is clamped into meas_u's slots for memory
// safety; the engine's slot is already in range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_CORES = 12;        // sim/device.py STATEVEC_MAX_CORES
constexpr int MAX_U = 8;             // trajectory uniforms a (shot, core)
constexpr int ERR_COFIRE_ORDER = 256;
constexpr int KIND_ZZ = 1;           // coupling kinds: 0 zx, 1 zz
// equatorial axes agree mod pi <=> 17-bit phase words agree mod 2^16
constexpr unsigned HALF_TURN_MASK = (1u << 16) - 1;
constexpr float TWO_PI = 6.28318530717958648f;
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int WARPS_MAX = 8;
constexpr int SMEM_TARGET = 48 * 1024;

enum Flag : int {
  F_DET = 1, F_DECAY = 2, F_DP1 = 4, F_DP2 = 8, F_LEAK = 16, F_LEAK1 = 32,
  F_LEAK2 = 64, F_SEEP = 128, F_LEAK_IQ = 256,
};

// operands, in the order of ops/statevec.py PTRS, INTS and REALS
enum Ptr : int {
  P_PSI, P_LEAKED, P_PHYS_T, P_MEAS_P1, P_FIRE, P_ELEM, P_PP, P_TRIG,
  P_SLOT, P_IS_MEAS, P_MEAS_U, P_TRAJ_U, P_DET, P_INV_T1, P_INV_T2,
  P_COUPLINGS, P_PSI_OUT, P_LEAKED_OUT, P_PHYS_T_OUT, P_MEAS_P1_OUT,
  P_STATE_BIT, P_COFIRE, N_PTRS
};
enum Int : int {
  I_B, I_C, I_M, I_MU, I_NU, I_K, I_DRIVE_ELEM, I_FLAGS, I_LEAK_BIT, N_INTS
};
enum Real : int {
  R_THETA, R_PHI, R_DEPOL, R_DEPOL2, R_ZX90, R_ZZ90, R_LEAK, R_LEAK2,
  R_SEEP, N_REALS
};

struct Args {
  const float2* psi;
  const uint8_t* leaked;
  const int* phys_t;
  const float* meas_p1;     // [B, C, M]
  const uint8_t* fire;
  const int* elem;
  const int* pp;            // [B, C, 5]: env, phase, freq, amp, cfg words
  const int* trig;
  const int* slot;
  const uint8_t* is_meas;
  const float* meas_u;      // [B, C, Mu]
  const float* traj_u;      // [B, C, NU] or null (no stochastic channel)
  const float* det;         // [C] cycles a clock
  const float* inv_t1;      // [C] 1 / clocks
  const float* inv_t2;
  const int* cp;            // [K, 4]: control, frequency word, target, kind
  float2* psi_out;
  uint8_t* leaked_out;
  int* phys_t_out;
  float* meas_p1_out;
  int* state_bit;
  int* cofire;              // null without couplings
  int B, C, M, Mu, NU, K, drive_elem, flags, leak_bit;
  float theta;              // rotation angle a unit of the amp word (1q)
  float phi;                // phase angle a unit of the phase word
  float depol, depol2, zx90, zz90, leak, leak2, seep;
};

// one core's words of the shot, beside the state in shared memory
struct Core {
  int trig, pw, fw, amp;    // trigger, phase, frequency and amp words
  float dt;                 // gap since its last evolution (0 untouched)
  float h;                  // detuning: -alpha / 2
  float us;                 // the measurement uniform of its slot
  float u[MAX_U];           // the trajectory's uniforms
};

struct U2 {
  float2 m00, m01, m10, m11;
};

__host__ __device__ constexpr int warp_bytes(int C) {
  return ((8 << C) + C * (int)sizeof(Core) + 15) & ~15;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float f) {
  return make_float2(a.x * f, a.y * f);
}

// the lower index of pair p over bit q: p with a 0 inserted at bit q
__device__ __forceinline__ int pair_lo(int p, int q) {
  return ((p >> q) << (q + 1)) | (p & ((1 << q) - 1));
}

// P(|1>) of the core on bit q: sum of |psi_d|^2 over d with bit q set,
// the same on every lane
__device__ float p1_of(const float2* s, int D, int q, int lane) {
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    if ((d >> q) & 1) {
      const float2 v = s[d];
      acc += __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

// amplitudes with bit q clear times f0, with it set times f1
__device__ void scale_bit(float2* s, int D, int q, int lane, float f0,
                          float f1) {
  for (int d = lane; d < D; d += 32)
    s[d] = cscale(s[d], ((d >> q) & 1) ? f1 : f0);
  __syncwarp();
}

// the T1 jump: |0><1| on bit q, times f
__device__ void lower(float2* s, int D, int q, int lane, float f) {
  for (int p = lane; p < (D >> 1); p += 32) {
    const int i0 = pair_lo(p, q), i1 = i0 | (1 << q);
    s[i0] = cscale(s[i1], f);
    s[i1] = make_float2(0.f, 0.f);
  }
  __syncwarp();
}

// a 2x2 map on bit q: u0, or u1 where the pair's bit qsel is set (qsel < 0:
// u0 everywhere)
__device__ void apply_2x2(float2* s, int D, int q, int lane, const U2 u0,
                          const U2 u1, int qsel) {
  for (int p = lane; p < (D >> 1); p += 32) {
    const int i0 = pair_lo(p, q), i1 = i0 | (1 << q);
    const bool one = qsel >= 0 && ((i0 >> qsel) & 1);
    const float2 m00 = one ? u1.m00 : u0.m00, m01 = one ? u1.m01 : u0.m01;
    const float2 m10 = one ? u1.m10 : u0.m10, m11 = one ? u1.m11 : u0.m11;
    const float2 x0 = s[i0], x1 = s[i1];
    s[i0] = cadd(cmul(m00, x0), cmul(m01, x1));
    s[i1] = cadd(cmul(m10, x0), cmul(m11, x1));
  }
  __syncwarp();
}

__device__ __forceinline__ float2 times_i(float2 z) {
  return make_float2(-z.y, z.x);
}

__device__ __forceinline__ float2 times_minus_i(float2 z) {
  return make_float2(z.y, -z.x);
}

__device__ __forceinline__ float2 neg(float2 z) {
  return make_float2(-z.x, -z.y);
}

// Pauli sel (1 X, 2 Y, 3 Z) on bit q: a monomial map, exact
__device__ void pauli(float2* s, int D, int q, int lane, int sel) {
  for (int p = lane; p < (D >> 1); p += 32) {
    const int i0 = pair_lo(p, q), i1 = i0 | (1 << q);
    const float2 x0 = s[i0], x1 = s[i1];
    if (sel == 1) {
      s[i0] = x1;
      s[i1] = x0;
    } else if (sel == 2) {
      s[i0] = times_minus_i(x1);
      s[i1] = times_i(x0);
    } else {
      s[i1] = neg(x1);
    }
  }
  __syncwarp();
}

// exp(-i theta/2 (cos phi X + sin phi Y)) (interpreter._sv_rot_1q)
__device__ U2 rot_1q(float theta, float phi) {
  const float ch = cosf(0.5f * theta), sh = sinf(0.5f * theta);
  const float cp = cosf(phi), sp = sinf(phi);
  U2 u;
  u.m00 = make_float2(ch, 0.f);
  u.m01 = make_float2(-sh * sp, -sh * cp);
  u.m10 = make_float2(sh * sp, -sh * cp);
  u.m11 = u.m00;
  return u;
}

// P[sel] @ u: the eager block's product with a Pauli, row by row (exact)
__device__ U2 pauli_times(int sel, U2 u) {
  U2 r = u;
  if (sel == 1) {
    r.m00 = u.m10; r.m01 = u.m11; r.m10 = u.m00; r.m11 = u.m01;
  } else if (sel == 2) {
    r.m00 = times_minus_i(u.m10); r.m01 = times_minus_i(u.m11);
    r.m10 = times_i(u.m00); r.m11 = times_i(u.m01);
  } else if (sel == 3) {
    r.m10 = neg(u.m10); r.m11 = neg(u.m11);
  }
  return r;
}

// the no-jump branch of a jump channel of rate p on bit q: damp |1> by
// sqrt(1 - p) and renormalise by sqrt(1 - p P(1))
__device__ void no_jump(float2* s, int D, int q, int lane, float p,
                        float p1) {
  const float nrm =
      sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(p, p1)), 1e-12f));
  const float damp = __fsub_rn(1.f, __fsub_rn(1.f, sqrtf(1.f - p)));
  scale_bit(s, D, q, lane, 1.f / nrm, damp / nrm);
}

// the leakage channel of the core on bit q (interpreter._sv_leak_jump):
// returns whether the trajectory jumped (the core leaks)
__device__ bool leak_jump(float2* s, int D, int q, int lane, float p_eff,
                          float u) {
  const float p1 = p1_of(s, D, q, lane);
  if (u < __fmul_rn(p_eff, p1)) {
    scale_bit(s, D, q, lane, 0.f, 1.f / sqrtf(fmaxf(p1, 1e-12f)));
    return true;
  }
  no_jump(s, D, q, lane, p_eff, p1);
  return false;
}

__global__ void __launch_bounds__(WARPS_MAX * 32)
statevec_step_kernel(const Args a, int warps, int wbytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * warps + warp;
  if (b >= a.B) return;   // the whole warp: one shot a warp
  const int C = a.C, D = 1 << C, F = a.flags, K = a.K;
  const bool has_leak = F & F_LEAK;
  float2* s = reinterpret_cast<float2*>(smem + (size_t)warp * wbytes);
  Core* core = reinterpret_cast<Core*>(smem + (size_t)warp * wbytes +
                                       (size_t)D * sizeof(float2));

  // ---- the shot's per-core words: lane c reads core c -----------------
  const int c = lane;
  const bool mine = c < C;
  const long long bc = b * C + c;
  bool fire = false, meas = false, lk = false;
  int trig = 0, pt = 0, slot = 0;
  if (mine) {
    fire = a.fire[bc] != 0;
    meas = a.is_meas[bc] != 0;
    lk = a.leaked[bc] != 0;
    trig = a.trig[bc];
    pt = a.phys_t[bc];
    slot = a.slot[bc];
    const int* w = a.pp + bc * 5;
    core[c].trig = trig;
    core[c].pw = w[1];
    core[c].fw = w[2];
    core[c].amp = w[3];
  }
  const bool drive = mine && fire && a.elem[bc] == a.drive_elem;
  const bool touch = drive || meas;
  const unsigned fire_m = __ballot_sync(FULL, fire);
  const unsigned drive_m = __ballot_sync(FULL, drive);
  const unsigned meas_m = __ballot_sync(FULL, meas);
  const unsigned leak_in = __ballot_sync(FULL, lk);
  const unsigned touch_m = drive_m | meas_m;
  bool seeps = false;
  if (mine) {
    const float dt = touch ? (float)(int)((unsigned)trig - (unsigned)pt)
                           : 0.f;
    core[c].dt = dt;
    core[c].h = -0.5f * (__fmul_rn(TWO_PI, a.det[c]) * dt);
    if (a.traj_u != nullptr) {
      const float* u = a.traj_u + bc * a.NU;
      for (int j = 0; j < a.NU; ++j) core[c].u[j] = u[j];
      seeps = (F & F_SEEP) && u[7] < a.seep;
    }
    core[c].us = a.meas_u[bc * a.Mu + min(max(slot, 0), a.Mu - 1)];
  }
  const unsigned seep_m = __ballot_sync(FULL, seeps);
  __syncwarp();

  // a drive pulse whose frequency word matches a coupling entry is that
  // coupling's 2q interaction, not a 1q rotation
  auto cp_hit = [&](int k) -> bool {
    const int cc = a.cp[4 * k];
    return ((drive_m >> cc) & 1) && core[cc].fw == a.cp[4 * k + 1];
  };
  unsigned cr = 0;
  for (int k = lane; k < K; k += 32)
    if (cp_hit(k)) cr |= 1u << a.cp[4 * k];
  const unsigned q1_m = drive_m & ~__reduce_or_sync(FULL, cr);

  // ---- the co-fire check (interpreter._statevec_cofire), a coupling a
  // lane; masks over the step's input leaked flags --------------------------
  unsigned cofire_m = 0;
  if (a.cofire != nullptr) {
    auto eff = [&](int k) -> bool {
      const int* e = a.cp + 4 * k;
      return cp_hit(k) &&
             !(has_leak && (((leak_in >> e[0]) | (leak_in >> e[2])) & 1));
    };
    auto same = [&](int x, int t) -> bool {
      return ((fire_m >> x) & 1) && core[x].trig == t;
    };
    auto ax_ne = [&](int x, int y) -> bool {
      return (((unsigned)core[x].pw - (unsigned)core[y].pw) &
              HALF_TURN_MASK) != 0;
    };
    unsigned bad_m = 0;
    for (int i = lane; i < K; i += 32) {
      if (!eff(i)) continue;
      const int c1 = a.cp[4 * i], t1 = a.cp[4 * i + 2];
      const bool zz1 = a.cp[4 * i + 3] == KIND_ZZ;
      const int tcc = core[c1].trig;
      bool bad = same(t1, tcc) && ((q1_m >> t1) & 1);
      if (!zz1) {
        bad = bad && ax_ne(c1, t1);
        bad = bad || (same(t1, tcc) && ((meas_m >> t1) & 1));
      }
      for (int j = i + 1; j < K && !bad; ++j) {
        const int c2 = a.cp[4 * j], t2 = a.cp[4 * j + 2];
        const bool zz2 = a.cp[4 * j + 3] == KIND_ZZ;
        if (zz1 && zz2) continue;   // both diagonal: commute
        bool hard, soft = false;
        if (!zz1 && !zz2) {
          hard = t1 == c2 || t2 == c1;   // X vs Z
          soft = t1 == t2;               // X vs X
        } else if (!zz1) {
          hard = t1 == c2 || t1 == t2;
        } else {
          hard = t2 == c1 || t2 == t1;
        }
        if (hard)
          bad = eff(j) && same(c2, tcc);
        else if (soft)
          bad = eff(j) && same(c2, tcc) && ax_ne(c1, c2);
      }
      if (bad) bad_m |= 1u << c1;
    }
    cofire_m = __reduce_or_sync(FULL, bad_m);
  }

  const float2* in = a.psi + b * D;
  float2* out = a.psi_out + b * D;
  unsigned leaked_m = leak_in;
  int my_bit = 0;
  float my_p1 = 0.f;
  if (touch_m == 0) {
    // nothing to evolve: the state is copied
    for (int i = lane; i < (D >> 1); i += 32)
      reinterpret_cast<float4*>(out)[i] =
          reinterpret_cast<const float4*>(in)[i];
  } else {
    for (int i = lane; i < (D >> 1); i += 32)
      reinterpret_cast<float4*>(s)[i] =
          reinterpret_cast<const float4*>(in)[i];
    __syncwarp();

    // (1) free evolution: detuning precession, one diagonal Rz
    if (F & F_DET) {
      for (int d = lane; d < D; d += 32) {
        float arg = 0.f;
        for (int k = 0; k < C; ++k) {
          if ((touch_m >> k) & 1) {
            const float h = core[k].h;
            arg += ((d >> (C - 1 - k)) & 1) ? -h : h;
          }
        }
        s[d] = cmul(s[d], make_float2(cosf(arg), sinf(arg)));
      }
      __syncwarp();
    }

    // (2) T1 / pure-dephasing quantum jumps per touched core
    if (F & F_DECAY) {
      for (int k = 0; k < C; ++k) {
        if (!((touch_m >> k) & 1)) continue;
        const int q = C - 1 - k;
        const float i1 = a.inv_t1[k];
        const float iphi = fmaxf(a.inv_t2[k] - 0.5f * i1, 0.f);
        const float dt = core[k].dt;
        // a leaked core's slot is a frozen |1> bookkeeping state
        const bool frozen = has_leak && ((leak_in >> k) & 1);
        const float p_dec = frozen ? 0.f : 1.f - expf(-dt * i1);
        const float p1 = p1_of(s, D, q, lane);
        if (core[k].u[0] < __fmul_rn(p_dec, p1))
          lower(s, D, q, lane, 1.f / sqrtf(fmaxf(p1, 1e-12f)));
        else
          no_jump(s, D, q, lane, p_dec, p1);
        const float p_phi = frozen ? 0.f : 1.f - expf(-dt * iphi);
        if (core[k].u[1] < 0.5f * p_phi) scale_bit(s, D, q, lane, 1.f, -1.f);
      }
    }

    // (3) 1q drive rotations, the 1q Pauli folded in, then 1q leakage
    for (int k = 0; k < C; ++k) {
      if (!((q1_m >> k) & 1)) continue;
      const int q = C - 1 - k;
      // drives on a leaked core act on |2>: a no-op
      const bool frozen = has_leak && ((leak_in >> k) & 1);
      const float theta = frozen ? 0.f : a.theta * (float)core[k].amp;
      U2 u = rot_1q(theta, a.phi * (float)core[k].pw);
      int sel = 0;
      if ((F & F_DP1) && !frozen && core[k].u[2] < a.depol)
        sel = min((int)(core[k].u[3] * 3.f), 2) + 1;
      if (sel) u = pauli_times(sel, u);
      if (theta != 0.f || sel) apply_2x2(s, D, q, lane, u, u, -1);
      if ((F & F_LEAK1) && !((leaked_m >> k) & 1) &&
          leak_jump(s, D, q, lane, a.leak, core[k].u[6]))
        leaked_m |= 1u << k;
    }

    // (4) coupling pulses in list order: ZX / ZZ, 2q Pauli, the control's
    // leakage; a coupling with a leaked core no-ops
    for (int k = 0; k < K; ++k) {
      const int* e = a.cp + 4 * k;
      const int cc = e[0], tt = e[2];
      if (!cp_hit(k)) continue;
      if (has_leak && (((leaked_m >> cc) | (leaked_m >> tt)) & 1)) continue;
      const bool zz = e[3] == KIND_ZZ;
      const int qc = C - 1 - cc, qt = C - 1 - tt;
      const float th = __fmul_rn(HALF_PI, (float)core[cc].amp) *
                       (1.f / (zz ? a.zz90 : a.zx90));
      if (zz) {
        const float hh = -0.5f * th;
        const float2 even = make_float2(cosf(hh), sinf(hh));
        const float2 odd = make_float2(cosf(-hh), sinf(-hh));
        for (int d = lane; d < D; d += 32)
          s[d] = cmul(s[d], (((d >> qc) ^ (d >> qt)) & 1) ? odd : even);
        __syncwarp();
      } else {
        const float phi = a.phi * (float)core[cc].pw;
        apply_2x2(s, D, qt, lane, rot_1q(th, phi), rot_1q(-th, phi), qc);
      }
      if ((F & F_DP2) && core[cc].u[4] < a.depol2) {
        const int sel = min((int)(core[cc].u[5] * 15.f), 14) + 1;
        if (sel & 3) pauli(s, D, qt, lane, sel & 3);
        if (sel >> 2) pauli(s, D, qc, lane, sel >> 2);
      }
      if ((F & F_LEAK2) && leak_jump(s, D, qc, lane, a.leak2, core[cc].u[6]))
        leaked_m |= 1u << cc;
    }

    // (5) joint projective measurement, sequentially conditioned
    for (int k = 0; k < C; ++k) {
      if (!((meas_m >> k) & 1)) continue;
      const int q = C - 1 - k;
      float p1 = fminf(fmaxf(p1_of(s, D, q, lane), 0.f), 1.f);
      const bool lkr = has_leak && ((leaked_m >> k) & 1);
      // a leaked core discriminates as leak_readout_bit, or reads state 2
      // at the IQ level
      if (lkr && !(F & F_LEAK_IQ)) p1 = (float)a.leak_bit;
      int bit = core[k].us < p1 ? 1 : 0;
      if (lkr && (F & F_LEAK_IQ)) bit = 2;
      if (!lkr) {
        const float f = 1.f / sqrtf(fmaxf(bit == 1 ? p1 : 1.f - p1, 1e-12f));
        scale_bit(s, D, q, lane, bit == 1 ? 0.f : f, bit == 1 ? f : 0.f);
      }
      if (lane == k) {
        my_bit = bit;
        my_p1 = p1;
      }
    }

    for (int i = lane; i < (D >> 1); i += 32)
      reinterpret_cast<float4*>(out)[i] = reinterpret_cast<float4*>(s)[i];
  }

  // seepage |2> -> |1>: a drive on a core leaked before this step un-leaks
  // it from the next step
  leaked_m &= ~(drive_m & leak_in & seep_m);
  if (mine) {
    a.leaked_out[bc] = (leaked_m >> c) & 1;
    a.phys_t_out[bc] = touch ? trig : pt;
    a.state_bit[bc] = my_bit;
    if (a.cofire != nullptr)
      a.cofire[bc] = ((cofire_m >> c) & 1) ? ERR_COFIRE_ORDER : 0;
    const long long row = bc * a.M;
    for (int m = 0; m < a.M; ++m)
      a.meas_p1_out[row + m] =
          (meas && m == slot) ? my_p1 : a.meas_p1[row + m];
  }
}

}  // namespace

// One launch of the step on `stream`.  Returns 0, a cudaError_t, or -1 for
// operand counts that do not match this build and -2 for a shape the
// kernel does not take (the wrapper checks both before it calls).
extern "C" int dp_statevec_step(const unsigned long long* ptrs, int n_ptrs,
                                const int* ints, int n_ints,
                                const float* reals, int n_reals,
                                void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_reals != N_REALS) return -1;
  Args a;
  a.psi = reinterpret_cast<const float2*>(ptrs[P_PSI]);
  a.leaked = reinterpret_cast<const uint8_t*>(ptrs[P_LEAKED]);
  a.phys_t = reinterpret_cast<const int*>(ptrs[P_PHYS_T]);
  a.meas_p1 = reinterpret_cast<const float*>(ptrs[P_MEAS_P1]);
  a.fire = reinterpret_cast<const uint8_t*>(ptrs[P_FIRE]);
  a.elem = reinterpret_cast<const int*>(ptrs[P_ELEM]);
  a.pp = reinterpret_cast<const int*>(ptrs[P_PP]);
  a.trig = reinterpret_cast<const int*>(ptrs[P_TRIG]);
  a.slot = reinterpret_cast<const int*>(ptrs[P_SLOT]);
  a.is_meas = reinterpret_cast<const uint8_t*>(ptrs[P_IS_MEAS]);
  a.meas_u = reinterpret_cast<const float*>(ptrs[P_MEAS_U]);
  a.traj_u = reinterpret_cast<const float*>(ptrs[P_TRAJ_U]);
  a.det = reinterpret_cast<const float*>(ptrs[P_DET]);
  a.inv_t1 = reinterpret_cast<const float*>(ptrs[P_INV_T1]);
  a.inv_t2 = reinterpret_cast<const float*>(ptrs[P_INV_T2]);
  a.cp = reinterpret_cast<const int*>(ptrs[P_COUPLINGS]);
  a.psi_out = reinterpret_cast<float2*>(ptrs[P_PSI_OUT]);
  a.leaked_out = reinterpret_cast<uint8_t*>(ptrs[P_LEAKED_OUT]);
  a.phys_t_out = reinterpret_cast<int*>(ptrs[P_PHYS_T_OUT]);
  a.meas_p1_out = reinterpret_cast<float*>(ptrs[P_MEAS_P1_OUT]);
  a.state_bit = reinterpret_cast<int*>(ptrs[P_STATE_BIT]);
  a.cofire = reinterpret_cast<int*>(ptrs[P_COFIRE]);
  a.B = ints[I_B];
  a.C = ints[I_C];
  a.M = ints[I_M];
  a.Mu = ints[I_MU];
  a.NU = ints[I_NU];
  a.K = ints[I_K];
  a.drive_elem = ints[I_DRIVE_ELEM];
  a.flags = ints[I_FLAGS];
  a.leak_bit = ints[I_LEAK_BIT];
  a.theta = reals[R_THETA];
  a.phi = reals[R_PHI];
  a.depol = reals[R_DEPOL];
  a.depol2 = reals[R_DEPOL2];
  a.zx90 = reals[R_ZX90];
  a.zz90 = reals[R_ZZ90];
  a.leak = reals[R_LEAK];
  a.leak2 = reals[R_LEAK2];
  a.seep = reals[R_SEEP];
  if (a.B == 0) return 0;
  const bool needs_u = a.flags & (F_DECAY | F_DP1 | F_DP2 | F_LEAK);
  if (a.C < 1 || a.C > MAX_CORES || a.NU > MAX_U || a.M < 1 || a.Mu < 1 ||
      (needs_u && (a.traj_u == nullptr || a.NU < 6)) ||
      ((a.flags & (F_LEAK1 | F_LEAK2)) && a.NU < 7) ||
      ((a.flags & F_SEEP) && a.NU < 8) || (a.K > 0 && a.cp == nullptr))
    return -2;
  const int wb = warp_bytes(a.C);
  int warps = SMEM_TARGET / wb;
  warps = warps < 1 ? 1 : warps > WARPS_MAX ? WARPS_MAX : warps;
  const unsigned blocks = (unsigned)((a.B + warps - 1) / warps);
  statevec_step_kernel<<<blocks, warps * 32, (size_t)warps * wb,
                         (cudaStream_t)stream>>>(a, warps, wb);
  return (int)cudaGetLastError();
}
