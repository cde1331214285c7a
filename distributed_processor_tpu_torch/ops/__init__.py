from .waveform import (PHASE_BITS, AMP_SCALE, complex_to_iq, iq_to_complex,
                       carrier_phase, resolve_pulse_freqs,
                       pulse_window_weights, synthesize_element,
                       synthesize_element_reference)
from .demod import (demod_iq, demod_iq_reference, discriminate,
                    demod_and_discriminate, stack_window_weights)
from .resolve import (build_energy_prefix, build_energy_tables,
                      build_fused_tables, build_prefix_tables,
                      resolve_windows_fused, resolve_windows_reference)
from .exec_span import exec_span, exec_span_fused, exec_span_physics
from .fabric import MeasLUT
