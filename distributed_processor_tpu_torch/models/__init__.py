from .channels import make_channel_config, make_channel_configs
from .experiments import (active_reset, rabi_program, t1_program,
                          ramsey_program, loop_shots_program, ghz_program,
                          t2_echo_program)
from .rb import rb_program, rb_sequence, rb_ensemble, clifford_table
from .rb2q import (rb2q_program, rb2q_sequence, clifford2_table,
                   rb2q_interleaved_program, element_index,
                   depol2_survival, count_cz)
from .coupling import couplings_from_qchip
from .default_qchip import make_default_qchip, make_default_qchip_dict
from .readout import (sample_meas_bits, apply_assignment_error,
                      IQReadoutModel)
from .repetition import (repetition_round_machine_program, repetition_config,
                         repetition_round_program,
                         repetition_physics_kwargs, repetition_logical_program,
                         correlated_noise_stage, independent_noise_stage,
                         majority_lut, corrected_counts)
from .qec import (qec_config, qec_multiround_machine_program, chain_lut,
                  surface_cycle_machine_program, surface_cycle_config,
                  repetition_decode_spec, surface_decode_spec)
from .calibration import (fit_centroids, assignment_matrix,
                          readout_fidelity, calibrate_readout)
