"""Traffic drivers, one module each, named by a traffic file's
``driver``: each sets up a cell, runs its measured window and compares
what the window produced with the reference."""
