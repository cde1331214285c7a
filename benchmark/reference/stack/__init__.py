"""A frozen copy of the port's numpy compile stack and scalar oracle.

The plain reference compiles and runs every program itself: the
benchmark hands it the same program source it hands the port, and it
works out the machine words, tables and per-shot outcomes again from
that source.  These modules are copies taken when the benchmark was
written (import paths rewritten to this package, the native codec and
the compile cache left out); they import numpy and networkx only, and
nothing of the port or of JAX.  The port may change its own copies;
these stay as they are.
"""
