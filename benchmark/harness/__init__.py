"""The benchmark's general code: one run of one cell.

Everything that belongs to one configuration, traffic mix, per-layer
metric or layer lives in files of its own under ``benchmark/`` and is
found by name; this package holds what every cell shares.
"""
