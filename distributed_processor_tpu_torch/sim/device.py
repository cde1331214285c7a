"""Qubit device co-state models for physics-closed execution.

The reference models no device physics at all — real qubits supply the
measurement bits its gateware branches on (reference:
cocotb/proc/test_proc.py:441-446 injects them; in deployment the readout
chain produces them).  This module supplies the numeric stand-in the TPU
build's closed loop evolves *in-sim*, per (shot, core) lane, inside the
interpreter's ``lax.while_loop``:

``'parity'``
    The round-1/2 classical stand-in: each drive-element pulse adds
    ``round(amp / x90_amp)`` quarter turns to an int32 counter; the
    state bit is the half-turn parity.  Deterministic, cheap, exactly
    reproducible by hand — the mode the randomized engine-vs-oracle
    fuzz and the headline bench use.

``'bloch'``
    An SU(2) co-state: a Bloch vector ``r = (x, y, z)`` (float32,
    ``|0> = +z``, ``P(1) = (1 - z)/2``) per (shot, core).  Physics:

    * **Drive pulses rotate.**  A pulse on ``drive_elem`` applies the
      right-handed rotation by ``theta = (pi/2) * amp / x90_amp`` about
      the equatorial axis ``(cos phi, sin phi, 0)`` where ``phi`` is the
      pulse's 17-bit *phase word* — so virtual-z (the compiler folds
      z-rotations into downstream pulse phase words,
      ir/passes.py ResolveVirtualZ) and amplitude sweeps (register- or
      modi-parameterized amp words) are physically meaningful.  The
      convention matches ``U = exp(-i theta/2 (cos phi X + sin phi Y))``,
      the X90 of models/rb.py at ``phi = 0``; measurement statistics
      from |0> are invariant under the global phase-sign choice, which
      is what pins it against the Clifford table
      (tests/test_device_bloch.py).
    * **Time evolves between pulses.**  At each drive/readout pulse the
      lane first applies free evolution over the elapsed global-clock
      interval since its previous one: detuning precession about z by
      ``2*pi * detuning_hz * clk_period_s`` per clock, transverse decay
      ``exp(-dt/T2)`` on (x, y), longitudinal relaxation
      ``z -> 1 + (z - 1) * exp(-dt/T1)`` toward |0>.  Scheduled delays
      therefore dephase/decay the qubit with no extra bookkeeping — the
      gap simply shows up in the next pulse's trigger time.
    * **Depolarization per drive pulse.**  ``r -> (1 - depol) * r``
      after each rotation — the ensemble-averaged depolarizing channel,
      the injectable error rate randomized benchmarking recovers.
    * **Measurement projects.**  A readout pulse samples
      ``bit ~ Bernoulli((1 - z)/2)`` (one pre-drawn uniform per
      (shot, core, slot), deterministic per run key) and collapses
      ``r -> (0, 0, 1 - 2*bit)``.  The sampled bit is what the readout
      channel (sim/physics.py) then discriminates through noise — so
      projection statistics and assignment errors layer the way they do
      on hardware.  The pre-projection ``P(1)`` is recorded per slot
      (``meas_p1``) for noise-free expectation readout in tests and
      fitting.

    All parameters may be scalars or per-core sequences; they enter the
    jitted step as traced arrays, so sweeping T1/T2/detuning never
    recompiles.

``'statevec'``
    The entangling model: one full ``2^n_cores``-dimensional state
    vector per shot (complex64 ``[B, 2^C]``), evolved as a quantum
    trajectory.  Everything 'bloch' does per-core holds (phase-word
    rotation axes, detuning precession, projective measurement), plus:

    * **Two-qubit interactions are real.**  A drive pulse on a core
      whose frequency word matches a configured coupling (see
      ``couplings``) applies an entangling rotation — ZX for
      cross-resonance pulses (control driven at the target's
      frequency), ZZ for ef-frequency drives — with angle
      ``(pi/2) * amp / zx90_amp`` (resp. ``zz90_amp``).  The default
      qchip's CNOT (echoed-CR + target X90 + virtual-z) and CZ
      calibrations compose *exactly* to CNOT / CZ under this model
      (pinned by tests/test_device_statevec.py), so GHZ preparation
      produces genuinely correlated bits and two-qubit RB sees real
      entangling errors.
    * **Noise is trajectory-unraveled.**  T1 is a quantum-jump
      amplitude-damping channel (jump probability per gap weighted by
      the qubit's excited population), pure dephasing a stochastic Z,
      1q depolarization a stochastic X/Y/Z after each drive pulse, and
      2q depolarization (``depol2_per_pulse``) a stochastic two-qubit
      Pauli after each coupling pulse.  Shot-averaged statistics
      reproduce the ensemble channels; draws are deterministic per
      (shot, step) given the run key.
    * **Measurement projects jointly.**  Readouts collapse the full
      vector (sequential conditioning across cores within a step gives
      the exact joint distribution), so GHZ parity correlations survive
      into the sampled bits and through the readout DSP chain.

    **Ordering**: cores advance per *instruction step*, not per clock,
    so cross-core application order would not match trigger-time order
    on its own.  With couplings configured, the interpreter adds a
    conservative discrete-event gate (sim/interpreter.py ``_step``
    stall mask): a pulse trigger fires only once no other live core
    could still produce an earlier-time op, making application order =
    schedule order by construction.  Pulses with *equal* trigger times
    co-fire and apply in a fixed stage order (1q rotations, couplings,
    measurements) — a genuine physical overlap either way.  See
    docs/PHYSICS.md "Entangling model".

The model evolves *inside* the execution loop (sim/interpreter.py
``_step`` physics block) because feedback makes it stateful: an active
reset's conditional X180 must see the post-measurement collapsed state,
and mid-circuit measurement outcomes condition later rotations.  A
post-hoc pass over recorded pulses could not close that loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

DEVICE_KINDS = ('parity', 'bloch', 'statevec')

# default two-qubit interaction reference amplitudes: the amp word that
# produces a pi/2 ZX (cross-resonance) / ZZ (ef-drive) rotation, matched
# to the default qchip's CNOT/CZ calibrations (models/default_qchip.py:
# CR_AMP = 0.35, CZ_AMP = 0.42 on the 16-bit amp scale)
ZX90_AMP_DEFAULT = 22937     # round(0.35 * (2^16 - 1))
ZZ90_AMP_DEFAULT = 27525     # round(0.42 * (2^16 - 1))

# statevec state is [shots, 2^n_cores]: cap the exponential axis
STATEVEC_MAX_CORES = 12


@dataclass(frozen=True)
class DeviceModel:
    """Device-physics parameters for :class:`~.physics.ReadoutPhysics`.

    ``detuning_hz``: qubit-minus-drive-frame frequency offset (Hz) —
    the Ramsey fringe frequency.  ``t1_s`` / ``t2_s``: relaxation and
    total transverse-coherence times (seconds; ``inf`` disables).
    ``depol_per_pulse``: depolarizing contraction applied per drive
    pulse.  ``clk_period_s``: FPGA clock period used to convert to
    per-clock rates (reference: python/distproc/hwconfig.py:102, 2 ns).
    Scalars broadcast over cores; sequences are per-core.
    """
    kind: str = 'bloch'
    detuning_hz: float | tuple = 0.0
    t1_s: float | tuple = math.inf
    t2_s: float | tuple = math.inf
    depol_per_pulse: float = 0.0
    clk_period_s: float = 2e-9
    # -- statevec-only fields (ignored by 'parity'/'bloch') -------------
    # two-qubit couplings: ((ctrl_core, freq_idx, target_core, kind),
    # ...) with kind 'zx' (cross-resonance: a drive pulse on ctrl at the
    # target's frequency applies exp(-i theta/2 Z_c (cos phi X_t +
    # sin phi Y_t))) or 'zz' (ef-frequency drive: exp(-i theta/2
    # Z_c Z_t), phase-word-independent since ZZ is diagonal).  Derive
    # from a compiled program + qchip with
    # models.coupling.couplings_from_qchip.
    couplings: tuple = ()
    zx90_amp: int = ZX90_AMP_DEFAULT   # amp word of a pi/2 ZX rotation
    zz90_amp: int = ZZ90_AMP_DEFAULT   # amp word of a pi/2 ZZ rotation
    # two-qubit depolarization per coupling pulse: with this
    # probability, one of the 15 non-identity two-qubit Paulis (uniform)
    # is applied to the coupled pair after the interaction — the
    # injectable error rate two-qubit RB recovers, distinct from the
    # single-qubit ``depol_per_pulse`` channel (which statevec applies
    # as a trajectory-sampled X/Y/Z after each 1q drive pulse).
    depol2_per_pulse: float = 0.0
    # Leakage out of the computational subspace, trajectory-unraveled
    # with an absorbing classical flag (the standard approximation for
    # a |2> level without a 3^C state space): after each 1q drive pulse
    # on core c, with probability ``leak_per_pulse * P(|1>_c)`` the
    # trajectory jumps — the state projects onto the core's |1>
    # component (collapsing entangled partners consistently, the
    # unraveling of L = |2><1|) and the core is marked leaked.  Leaked
    # cores are frozen: later drives, couplings involving them, and
    # T1/T2 no-op; their readouts return ``leak_readout_bit``
    # (|2> discriminates near |1> on most devices).  Absorbing — no
    # seepage back — and 1q-drive-induced only (CR-pulse leakage is a
    # known omission).  The run output gains a ``leaked`` [B, C] flag.
    leak_per_pulse: float = 0.0
    leak_readout_bit: int = 1
    # Coupling-pulse-induced leakage (round 5): after each coupling
    # pulse, the CONTROL core (the strongly-driven one — the dominant
    # hardware mechanism for 2q gates) leaks with probability
    # ``leak2_per_pulse * P(|1>_ctrl)``, with the same CPTP unraveling
    # (jump -> project + mark leaked; no-jump -> damp |1| amplitude) as
    # the 1q channel.  Interleaved 2q RB sees it as CZ error
    # (tests/test_leakage.py).
    leak2_per_pulse: float = 0.0
    # Seepage |2> -> |1| (round 5): a drive pulse (1q or coupling) on a
    # LEAKED core returns it to the computational subspace with this
    # probability — the core re-enters in |1> (its psi slot is exactly
    # the frozen |1> bookkeeping state) starting from the NEXT
    # instruction step; the seeping pulse itself still no-ops
    # (documented simplification).  0 keeps leakage absorbing.
    seep_per_pulse: float = 0.0

    def __post_init__(self):
        if self.kind not in DEVICE_KINDS:
            raise ValueError(f'unknown device kind {self.kind!r}; '
                             f'one of {DEVICE_KINDS}')
        for cp in self.couplings:
            if len(cp) != 4 or cp[3] not in ('zx', 'zz'):
                raise ValueError(
                    f'coupling entries are (ctrl_core, freq_idx, '
                    f'target_core, "zx"|"zz"); got {cp!r}')
            if cp[0] == cp[2]:
                raise ValueError(f'coupling {cp!r} pairs a core with itself')
        if self.leak_readout_bit not in (0, 1):
            raise ValueError('leak_readout_bit must be 0 or 1')
        for name in ('leak_per_pulse', 'leak2_per_pulse',
                     'seep_per_pulse'):
            v = np.asarray(getattr(self, name), np.float64)
            if v.ndim != 0:
                raise ValueError(
                    f'{name} must be a scalar (per-core rates are not '
                    f'supported yet)')
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f'{name} must be in [0, 1]')
        if np.asarray(self.seep_per_pulse, np.float64) > 0 and not (
                np.asarray(self.leak_per_pulse, np.float64) > 0
                or np.asarray(self.leak2_per_pulse, np.float64) > 0):
            raise ValueError(
                'seep_per_pulse needs a leakage channel (leak_per_pulse '
                'or leak2_per_pulse > 0) — nothing can seep back')

    def statevec_static(self) -> tuple:
        """Hashable compile-time facts for the statevec step body:
        ``(couplings, has_detuning, has_decay, has_depol1, has_depol2,
        has_leak, leak_readout_bit, has_leak1, has_leak2, has_seep)`` —
        zero-rate channels are dropped from the traced step entirely
        (changing a rate between zero and nonzero recompiles; sweeping
        nonzero values does not, since the rates themselves are traced
        arrays).  ``has_leak`` is the any-leakage flag (freeze/readout
        logic); ``has_leak1``/``has_leak2`` gate the 1q- and
        coupling-induced exposure blocks separately."""
        def nz(v):
            return bool(np.any(np.asarray(v, np.float64) != 0.0))
        def finite(v):
            return bool(np.any(np.isfinite(np.asarray(v, np.float64))))
        has_leak1 = nz(self.leak_per_pulse)
        has_leak2 = nz(self.leak2_per_pulse)
        has_leak = has_leak1 or has_leak2
        return (tuple(tuple(cp) for cp in self.couplings),
                nz(self.detuning_hz),
                finite(self.t1_s) or finite(self.t2_s),
                nz(self.depol_per_pulse), nz(self.depol2_per_pulse),
                # leak_readout_bit is dead without leakage: pin it so a
                # bit-only model change can't force a spurious recompile
                has_leak,
                int(self.leak_readout_bit) if has_leak else 1,
                has_leak1, has_leak2, nz(self.seep_per_pulse))

    def per_clock_rates(self, n_cores: int):
        """Per-core per-clock rate arrays ``(det_cyc, inv_t1, inv_t2)``:
        detuning in cycles/clock, decay in 1/clocks (0 = disabled)."""
        def bc(v):
            return np.broadcast_to(np.asarray(v, np.float64),
                                   (n_cores,)).astype(np.float64)
        det = bc(self.detuning_hz) * self.clk_period_s
        with np.errstate(divide='ignore'):
            inv_t1 = np.where(np.isinf(bc(self.t1_s)), 0.0,
                              self.clk_period_s / bc(self.t1_s))
            inv_t2 = np.where(np.isinf(bc(self.t2_s)), 0.0,
                              self.clk_period_s / bc(self.t2_s))
        return (det.astype(np.float32), inv_t1.astype(np.float32),
                inv_t2.astype(np.float32))
