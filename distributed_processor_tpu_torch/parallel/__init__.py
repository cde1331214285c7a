from .mesh import (make_mesh, make_cores_mesh, shot_sharding,
                   serving_devices)
from .driver import run_physics_sweep, run_multi_sweep, run_cores_sweep
from .sweep import (physics_batch_stats, multi_batch_stats,
                    sharded_simulate, sweep_stats, sweep_stat_sums,
                    sharded_demod, sharded_physics_stats,
                    sharded_physics_stat_sums, sharded_multi_stats,
                    sharded_cores_simulate, sharded_cores_rounds,
                    sharded_cores_stat_sums, sharded_cores_stats,
                    run_spanned)
from .param_sweep import (swept_pulse_machine_program, grid_init_regs,
                          sweep_cfg)
from .multihost import (initialize_multihost, shutdown_multihost,
                        make_global_mesh,
                        host_local_batch, host_local_mesh,
                        dp_row_offset, cross_host_sum,
                        global_shot_array)
