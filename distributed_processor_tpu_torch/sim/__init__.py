from .interpreter import (InterpreterConfig, simulate, simulate_batch,
                          FaultError,
                          FAULT_CODES, fault_shot_counts)
from .device import DeviceModel
from .physics import (ReadoutPhysics, run_physics_batch,
                      prepare_physics_tables, physics_from_dict)
