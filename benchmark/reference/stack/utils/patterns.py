"""Minimal format-string pattern matching.

Channel and core groupings are declared with format patterns like
``'{qubit}.qdrv'`` (reference: python/distproc/compiler.py:141-142).  This
implements the inverse operation — matching a concrete string against the
pattern and extracting the named fields — without the third-party ``parse``
dependency.
"""

from __future__ import annotations

import re
from functools import lru_cache

_FIELD_RE = re.compile(r'\{(\w+)\}')


@lru_cache(maxsize=None)
def _compile(pattern: str) -> re.Pattern:
    out = []
    pos = 0
    for m in _FIELD_RE.finditer(pattern):
        out.append(re.escape(pattern[pos:m.start()]))
        out.append(f'(?P<{m.group(1)}>.+?)')
        pos = m.end()
    out.append(re.escape(pattern[pos:]))
    return re.compile('^' + ''.join(out) + '$')


def match_pattern(pattern: str, string: str) -> dict | None:
    """Match ``string`` against a ``{field}`` format pattern.

    Returns the dict of captured fields, or None if there is no match.
    ``match_pattern('{qubit}.qdrv', 'Q0.qdrv') == {'qubit': 'Q0'}``.
    """
    m = _compile(pattern).match(string)
    return m.groupdict() if m else None


def format_pattern(pattern: str, fields: dict) -> str:
    return pattern.format(**fields)
