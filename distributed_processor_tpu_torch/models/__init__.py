from .channels import make_channel_config, make_channel_configs
from .experiments import active_reset
from .rb import rb_program
from .default_qchip import make_default_qchip, make_default_qchip_dict
from .readout import (sample_meas_bits, apply_assignment_error,
                      IQReadoutModel)
from .repetition import (repetition_round_machine_program, repetition_config,
                         repetition_round_program,
                         repetition_physics_kwargs, repetition_logical_program,
                         correlated_noise_stage, independent_noise_stage,
                         majority_lut, corrected_counts)
from .qec import (qec_config, qec_multiround_machine_program, chain_lut,
                  surface_cycle_machine_program, surface_cycle_config)
