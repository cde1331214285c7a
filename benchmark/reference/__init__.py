"""The plain reference: plain numpy and torch, importing nothing of the
port and nothing of JAX.  :mod:`.stack` is a frozen copy of the compile
stack, :mod:`.oracle` the scalar interpreter, :mod:`.lanes` the per-lane
outcomes, :mod:`.qec` the decode and :mod:`.sweep` the batch sums."""
