from .driver import run_physics_sweep
from .sweep import physics_batch_stats
