"""The share of live core-steps in which the statevec device's
discrete-event gate held a pulse trigger, over the traced batches:
100 x the port's ``gate_stall_steps`` over its ``live_core_steps``
(``run_physics_batch``'s device counters, summed on the device and read
with each batch's sums).  Nothing where the port returns no such
counters."""


def read(rec):
    work = rec['work']
    stall, live = work.get('gate_stall_steps'), work.get('live_core_steps')
    if stall is None or not live:
        return None
    return 100.0 * stall / live
