// Native command codec: 128-bit command buffers <-> SoA field arrays.
//
// This is the host-side hot loop at the FPGA-BRAM boundary (the
// reference's equivalent work is the per-instruction Python encode in
// python/distproc/assembler.py:349-429 and the cocotb-side parsing in
// python/distproc/asmparse.py:12-44).  Large sweep compilations decode
// thousands of commands per core; doing the bit-slicing in C++ keeps
// the program-upload path off the Python interpreter.
//
// Field order must match distributed_processor_tpu_torch.isa.SOA_FIELDS.
// Built by native/__init__.py: g++ -O2 -shared -fPIC into _build/.

#include <cstdint>
#include <cstring>

namespace {

constexpr int CMD_BYTES = 16;
constexpr int N_FIELDS = 19;

// SOA_FIELDS order (isa.py):
enum Field {
    F_KIND = 0, F_ALU_OP, F_IN0_IS_REG, F_IMM, F_IN0_REG, F_IN1_REG,
    F_OUT_REG, F_JUMP_ADDR, F_FUNC_ID, F_BARRIER, F_CMD_TIME,
    F_P_ENV, F_P_PHASE, F_P_FREQ, F_P_AMP, F_P_CFG,
    F_P_WEN, F_P_REGSEL, F_P_REG,
};

// instruction kinds (isa.py K_*)
enum Kind {
    K_PULSE_WRITE = 0, K_PULSE_TRIG, K_REG_ALU, K_JUMP_I, K_JUMP_COND,
    K_ALU_FPROC, K_JUMP_FPROC, K_INC_QCLK, K_SYNC, K_DONE, K_PULSE_RESET,
    K_IDLE,
};

// 5-bit opcode -> kind (-1 = invalid); mirrors isa._OP5_TO_KIND
int op5_to_kind(int op5) {
    switch (op5) {
        case 0b10000: return K_PULSE_WRITE;
        case 0b10010: return K_PULSE_TRIG;
        case 0b00010: case 0b00011: return K_REG_ALU;
        case 0b00100: return K_JUMP_I;
        case 0b00110: case 0b00111: return K_JUMP_COND;
        case 0b01000: case 0b01001: return K_ALU_FPROC;
        case 0b01010: case 0b01011: return K_JUMP_FPROC;
        case 0b01100: case 0b01101: return K_INC_QCLK;
        case 0b01110: return K_SYNC;
        case 0b10100: return K_DONE;
        case 0b10110: return K_PULSE_RESET;
        case 0b11000: return K_IDLE;
        case 0b00000: return K_DONE;   // all-zero opcode halts (ctrl.v:382)
        default: return -1;
    }
}

// extract [pos, pos+width) from a 128-bit little-endian command
inline uint64_t bits(const uint8_t* cmd, int pos, int width) {
    // assemble up to 64 bits spanning byte boundaries
    uint64_t v = 0;
    int first = pos >> 3;
    int nbytes = ((pos + width + 7) >> 3) - first;
    for (int i = nbytes - 1; i >= 0; --i)
        v = (v << 8) | cmd[first + i];
    v >>= (pos & 7);
    if (width < 64)
        v &= ((uint64_t)1 << width) - 1;
    return v;
}

const int PULSE_POS_CMD_TIME = 5;
const int PULSE_POS_CFG = 37, PULSE_W_CFG = 4;
const int PULSE_POS_AMP = 42, PULSE_W_AMP = 16;
const int PULSE_POS_FREQ = 60, PULSE_W_FREQ = 9;
const int PULSE_POS_PHASE = 71, PULSE_W_PHASE = 17;
const int PULSE_POS_ENV = 90, PULSE_W_ENV = 24;

}  // namespace

extern "C" {

// Decode n commands from buf (16 bytes each, little-endian) into
// out[N_FIELDS][n] (row-major int32).  Returns 0 on success, or
// 1-based index of the first command with an unknown opcode.
int soa_decode(const uint8_t* buf, int n, int32_t* out) {
    for (int i = 0; i < n; ++i) {
        const uint8_t* cmd = buf + (size_t)i * CMD_BYTES;
        auto put = [&](int f, int64_t v) { out[(size_t)f * n + i] = (int32_t)v; };
        int op5 = (int)bits(cmd, 123, 5);
        int kind = op5_to_kind(op5);
        if (kind < 0) return i + 1;
        put(F_KIND, kind);
        put(F_ALU_OP, bits(cmd, 120, 3));
        bool aluish = kind == K_REG_ALU || kind == K_JUMP_COND ||
                      kind == K_ALU_FPROC || kind == K_JUMP_FPROC ||
                      kind == K_INC_QCLK;
        put(F_IN0_IS_REG, aluish ? (op5 & 1) : 0);
        put(F_IMM, (int32_t)(uint32_t)bits(cmd, 88, 32));   // two's complement
        put(F_IN0_REG, bits(cmd, 116, 4));
        put(F_IN1_REG, bits(cmd, 84, 4));
        put(F_OUT_REG, bits(cmd, 80, 4));
        put(F_JUMP_ADDR, bits(cmd, 68, 8));
        put(F_FUNC_ID, bits(cmd, 52, 8));
        put(F_BARRIER, bits(cmd, 112, 8));
        put(F_CMD_TIME, (int32_t)(uint32_t)bits(cmd, PULSE_POS_CMD_TIME, 32));
        if (kind == K_PULSE_WRITE || kind == K_PULSE_TRIG) {
            struct { int pos, width; } P[5] = {
                {PULSE_POS_ENV, PULSE_W_ENV}, {PULSE_POS_PHASE, PULSE_W_PHASE},
                {PULSE_POS_FREQ, PULSE_W_FREQ}, {PULSE_POS_AMP, PULSE_W_AMP},
                {PULSE_POS_CFG, PULSE_W_CFG}};
            int fields[5] = {F_P_ENV, F_P_PHASE, F_P_FREQ, F_P_AMP, F_P_CFG};
            int wen = 0, regsel = 0;
            for (int b = 0; b < 5; ++b) {
                put(fields[b], bits(cmd, P[b].pos, P[b].width));
                int w, r;
                if (fields[b] == F_P_CFG) {
                    w = (int)bits(cmd, P[b].pos + P[b].width, 1);
                    r = 0;
                } else {
                    int ctl = (int)bits(cmd, P[b].pos + P[b].width, 2);
                    w = (ctl >> 1) & 1;
                    r = ctl & 1;
                }
                wen |= w << b;
                regsel |= r << b;
            }
            put(F_P_WEN, wen);
            put(F_P_REGSEL, regsel);
            put(F_P_REG, bits(cmd, 116, 4));
        } else {
            put(F_P_ENV, 0); put(F_P_PHASE, 0); put(F_P_FREQ, 0);
            put(F_P_AMP, 0); put(F_P_CFG, 0);
            put(F_P_WEN, 0); put(F_P_REGSEL, 0); put(F_P_REG, 0);
        }
    }
    return 0;
}

// Batch-encode timed full-parameter pulse commands (the sweep-generation
// hot path): one command per entry, all five parameters immediate.
// Fields arrays length n; writes n*16 bytes to out.
void encode_pulse_batch(const int32_t* cmd_time, const int32_t* env,
                        const int32_t* phase, const int32_t* freq,
                        const int32_t* amp, const int32_t* cfg,
                        int n, uint8_t* out) {
    for (int i = 0; i < n; ++i) {
        unsigned __int128 cmd = 0;
        auto put = [&](unsigned __int128 v, int pos) { cmd |= v << pos; };
        put((uint32_t)cmd_time[i], PULSE_POS_CMD_TIME);
        put(((uint32_t)cfg[i] & 0xf) | (1u << PULSE_W_CFG), PULSE_POS_CFG);
        put(((uint32_t)amp[i] & 0xffff) | (1u << (PULSE_W_AMP + 1)),
            PULSE_POS_AMP);
        put(((uint32_t)freq[i] & 0x1ff) | (1u << (PULSE_W_FREQ + 1)),
            PULSE_POS_FREQ);
        put(((uint32_t)phase[i] & 0x1ffff) | (1u << (PULSE_W_PHASE + 1)),
            PULSE_POS_PHASE);
        put(((uint32_t)env[i] & 0xffffff) | (1u << (PULSE_W_ENV + 1)),
            PULSE_POS_ENV);
        put((unsigned __int128)0b10010, 123);   // pulse_write_trig
        uint8_t* dst = out + (size_t)i * CMD_BYTES;
        for (int b = 0; b < CMD_BYTES; ++b)
            dst[b] = (uint8_t)(cmd >> (8 * b));
    }
}

}  // extern "C"
