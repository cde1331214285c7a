from .visitor import qasm_to_program, QASMTranslator
from .gate_map import GateMap, DefaultGateMap, QubitMap, DefaultQubitMap
