from .driver import run_physics_sweep, run_multi_sweep
from .sweep import physics_batch_stats, multi_batch_stats
from .param_sweep import (swept_pulse_machine_program, grid_init_regs,
                          sweep_cfg)
