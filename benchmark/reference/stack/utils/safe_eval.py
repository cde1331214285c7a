"""Restricted evaluation of numeric expressions found in gate configs.

Gate-library JSON files express phases symbolically (e.g. ``"np.pi/2"``,
``"-numpy.pi/2.0"`` — see the reference fixture python/test/qubitcfg.json).
This evaluates such strings against a numpy-only namespace, rejecting
anything with attribute access outside numpy or names outside a small
whitelist.
"""

from __future__ import annotations

import ast
import numpy as np

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Name,
    ast.Attribute, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow,
    ast.USub, ast.UAdd, ast.Mod, ast.Load,
)
_ALLOWED_NAMES = {'np': np, 'numpy': np, 'pi': np.pi, 'e': np.e}


def eval_numeric(expr):
    """Evaluate a numeric literal or numpy constant expression.

    Non-strings pass through unchanged; strings must be pure arithmetic over
    numbers and numpy constants (``np.pi`` etc.).
    """
    if not isinstance(expr, str):
        return expr
    tree = ast.parse(expr, mode='eval')
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(f'disallowed element {type(node).__name__} in {expr!r}')
        if isinstance(node, ast.Name) and node.id not in _ALLOWED_NAMES:
            raise ValueError(f'unknown name {node.id!r} in {expr!r}')
    return float(eval(compile(tree, '<config>', 'eval'), {'__builtins__': {}}, _ALLOWED_NAMES))
