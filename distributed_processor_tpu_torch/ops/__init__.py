from .waveform import PHASE_BITS, AMP_SCALE, complex_to_iq, carrier_phase
from .resolve import (build_energy_tables, build_fused_tables,
                      resolve_windows_fused, resolve_windows_reference)
from .exec_span import exec_span, exec_span_fused
