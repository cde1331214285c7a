"""The least time of each layer's work on one H100: operations and bytes
counted from a cell's shapes, over the peaks of :mod:`.peaks`."""
