from .channels import make_channel_config, make_channel_configs
from .experiments import active_reset
from .rb import rb_program
from .default_qchip import make_default_qchip, make_default_qchip_dict
from .readout import (sample_meas_bits, apply_assignment_error,
                      IQReadoutModel)
