from .patterns import match_pattern, format_pattern
from .safe_eval import eval_numeric
from .results import save_results, load_results, SweepAccumulator
from .profiling import device_profile, StageTimer
