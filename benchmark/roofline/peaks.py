"""Peak rates of one NVIDIA H100 SXM 80GB, at its full 700 W limit.

From NVIDIA's H100 data sheet: 3.35 TB/s of HBM3 and 67 TFLOP/s of
float32 outside the tensor cores, 132 SMs at the 1.98 GHz boost clock.
From the CUDA C++ Programming Guide's table of arithmetic instruction
throughput (operations per clock per SM), compute capability 9.0: 128
32-bit instructions (float32 add, multiply and FMA; logic; shifts), 64
32-bit integer adds, compares and multiplies, 16 special-function
operations (log2, rsqrt, sqrt, sin, cos).  The integer and issue rates
below are issue rates derived from that table (per clock x SMs x clock),
not published peaks.  A card whose power limit is below 700 W (printed
beside every run) runs below them under load.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SMS = 132
CLOCK_HZ = 1.98e9
ISSUE_PER_CLK = 128
INT32_PER_CLK = 64
IMUL_PER_CLK = 64
SFU_PER_CLK = 16

ISSUE_PER_S = SMS * ISSUE_PER_CLK * CLOCK_HZ          # 3.345e13
INT32_OPS_PER_S = SMS * INT32_PER_CLK * CLOCK_HZ      # 1.673e13
IMUL_PER_S = SMS * IMUL_PER_CLK * CLOCK_HZ
SFU_PER_S = SMS * SFU_PER_CLK * CLOCK_HZ
