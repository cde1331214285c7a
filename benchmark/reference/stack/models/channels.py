"""Channel-map generation for N-qubit systems.

The reference ships a hand-written 2-core ``channel_config.json``
(reference: python/test/channel_config.json); scaling to N qubits there
means editing JSON.  Here the standard per-qubit channel triple
(qdrv/rdrv/rdlo with the ZCU216 sample geometry) is generated
programmatically.
"""

from __future__ import annotations

from ..hwconfig import load_channel_configs

# (elem_ind, samples_per_clk, interp_ratio) per channel role — the ZCU216
# geometry from the reference test fixture (channel_config.json:8-35)
CHANNEL_ROLES = {
    'qdrv': (0, 16, 1),
    'rdrv': (1, 16, 16),
    'rdlo': (2, 4, 4),
}


def make_channel_config(n_qubits: int = 8,
                        fpga_clk_freq: float = 500e6) -> dict:
    """Build the raw channel-config dict for ``n_qubits`` qubit cores."""
    cfg = {'fpga_clk_freq': fpga_clk_freq}
    for q in range(n_qubits):
        for role, (elem, spc, interp) in CHANNEL_ROLES.items():
            cfg[f'Q{q}.{role}'] = {
                'core_ind': q,
                'elem_ind': elem,
                'elem_params': {'samples_per_clk': spc,
                                'interp_ratio': interp},
                'env_mem_name': f'{role}env{{core_ind}}',
                'freq_mem_name': f'{role}freq{{core_ind}}',
                'acc_mem_name': 'accbuf{core_ind}',
            }
    return cfg


def make_channel_configs(n_qubits: int = 8, fpga_clk_freq: float = 500e6):
    """Loaded :class:`~..hwconfig.ChannelConfig` objects for N qubits."""
    return load_channel_configs(make_channel_config(n_qubits, fpga_clk_freq))
