from .patterns import match_pattern, format_pattern
from .safe_eval import eval_numeric
