"""Fleet: replica process manager + shared warm tiers + front door.

The top of the serving stack (docs/FLEET.md): a :class:`Fleet` spawns N
:mod:`.replica_main` processes (each one :class:`ExecutionService` on
the :mod:`.transport` wire), registers them with a
:class:`~.router.FleetRouter`, and keeps the population at N — a
monitor thread detects dead replica processes (SIGKILL, OOM, crash) and
respawns them with the SAME replica id, so the router sees a
``replica_down`` followed by a ``replica_up`` on a fresh connection.

Every replica of a fleet shares two warm tiers under ``shared_dir``:

* ``compile/`` — the serve-tier content-addressed
  :class:`~..compilecache.PersistentStore`,
* ``catalog.json`` — the learned warm-up :class:`~.catalog.
  BucketCatalog` (flock-guarded, merge-on-write, so concurrent
  replicas interleave safely).

A respawned replica therefore replays its warm-up from what its PEERS
served: its first served request counts zero cold dispatches — the
fleet's answer to the cold-start problem the single-service warm-up
solved in-process.  The third tier, the built CUDA kernels, needs no
configuration: ``ops/_cuda.py`` builds each kernel source once into the
checkout's build directory, keyed on the source's hash, so a replica
whose parent (or a peer) has built the kernels runs no ``nvcc``.

Replicas are started with ``subprocess.Popen`` of a fresh interpreter,
never with ``fork``: a CUDA context does not survive a fork.

Chaos hooks (``kill`` / ``wedge`` / ``unwedge``) drive the fleet soak:
SIGKILL exercises connection-loss failover, SIGSTOP exercises the
gossip-staleness path (the TCP connection stays open while the process
makes no progress), SIGCONT exercises heartbeat re-admission.

SLO-driven elasticity (docs/FLEET.md "Autoscaling",
docs/SERVING.md "Tenants"): with ``autoscale=`` configured, the
monitor thread closes the loop from the router's SLO watch — replica
count scales UP on sustained breach (fleet-wide stage or per-tenant
``'tenant:<name>'`` budget) and DOWN on sustained slack, through
:class:`AutoscalePolicy`'s hysteresis band (sustain windows + action
cooldown) so a noisy p99 cannot flap the population.  Scale-up lands
warm because new replicas replay the shared tiers; scale-down fails
the victim's in-flight work over through the ordinary
``remove_replica`` path before the process dies.
"""

from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import sys
import tempfile
import threading
import time

from ..utils import profiling
from .router import ROUTER_THREAD_PREFIX, FleetRouter

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class AutoscalePolicy:
    """Hysteresis band between the SLO level signal and scaling acts.

    Pure decision logic (no threads, no clock of its own) so tests
    drive it with synthetic time: feed ``decide(breached, n, now)``
    the router's current breach level and population each tick; it
    answers ``'up'`` / ``'down'`` / ``None``.  An action requires the
    signal to SUSTAIN (``breach_s`` of continuous breach, ``slack_s``
    of continuous slack) AND the cooldown since the last action to
    have elapsed — two independent anti-flap guards, so one noisy p99
    sample can neither scale up nor immediately undo a scale-up.
    Population stays inside ``[min_replicas, max_replicas]``.
    """

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 breach_sustain_s: float = 1.0,
                 slack_sustain_s: float = 5.0,
                 cooldown_s: float = 2.0):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f'need 1 <= min_replicas <= max_replicas; got '
                f'[{min_replicas}, {max_replicas}]')
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.breach_sustain_s = float(breach_sustain_s)
        self.slack_sustain_s = float(slack_sustain_s)
        self.cooldown_s = float(cooldown_s)
        self._breach_since = None
        self._slack_since = None
        self._last_action_t = None

    def decide(self, breached: bool, n: int, now: float):
        if breached:
            self._slack_since = None
            if self._breach_since is None:
                self._breach_since = now
            if (now - self._breach_since >= self.breach_sustain_s
                    and self._cool(now) and n < self.max_replicas):
                self._act(now)
                return 'up'
            return None
        self._breach_since = None
        if self._slack_since is None:
            self._slack_since = now
        if (now - self._slack_since >= self.slack_sustain_s
                and self._cool(now) and n > self.min_replicas):
            self._act(now)
            return 'down'
        return None

    def _cool(self, now: float) -> bool:
        return self._last_action_t is None \
            or now - self._last_action_t >= self.cooldown_s

    def _act(self, now: float) -> None:
        # an action consumes the sustained window: the signal must
        # re-sustain before the NEXT action, on top of the cooldown
        self._last_action_t = now
        self._breach_since = None
        self._slack_since = None

    def snapshot(self) -> dict:
        return {'min_replicas': self.min_replicas,
                'max_replicas': self.max_replicas,
                'breach_sustain_s': self.breach_sustain_s,
                'slack_sustain_s': self.slack_sustain_s,
                'cooldown_s': self.cooldown_s}


class _ReplicaProc:
    __slots__ = ('rid', 'proc', 'address', 'log_path', 'spawned_t',
                 'wedged', 'respawns')

    def __init__(self, rid):
        self.rid = rid
        self.proc = None
        self.address = None
        self.log_path = None
        self.spawned_t = 0.0
        self.wedged = False
        self.respawns = 0


class Fleet:
    """N supervised replica processes behind one FleetRouter.

    ``submit`` / ``submit_source`` / ``stats`` mirror the service API;
    handles resolve bit-identical-or-typed across replica loss.  The
    ``service`` dict is passed to every replica's ExecutionService
    (JSON-able kwargs only: ``devices``, ``max_est_wait_ms``,
    ``breaker_*``, ...); without ``devices`` each replica runs one
    executor on the card (every replica on the same card when the host
    has one), and ``service={'devices': ['cpu']}`` runs them on the CPU.
    ``interp_cfg`` likewise for the default InterpreterConfig.  ``env``
    overrides the replicas' environment (applied before torch imports,
    so ``CUDA_VISIBLE_DEVICES`` and ``OMP_NUM_THREADS`` take effect).
    """

    def __init__(self, n_replicas: int = 2, *, shared_dir: str = None,
                 service: dict = None, interp_cfg: dict = None,
                 env: dict = None, respawn: bool = True,
                 respawn_backoff_s: float = 0.25,
                 monitor_interval_s: float = 0.05,
                 ready_timeout_s: float = 300.0,
                 name: str = None, router_kwargs: dict = None,
                 trace_sample: float = 0.0, slo_budgets: dict = None,
                 integrity: bool = False, tenants: dict = None,
                 autoscale=None):
        if n_replicas < 1:
            raise ValueError('n_replicas must be >= 1')
        self.name = name or 'fleet'
        self._tmp = None
        if shared_dir is None:
            self._tmp = tempfile.TemporaryDirectory(
                prefix='dproc-fleet-')
            shared_dir = self._tmp.name
        self.shared_dir = shared_dir
        os.makedirs(os.path.join(shared_dir, 'logs'), exist_ok=True)
        self._service = dict(service or {})
        self._interp_cfg = dict(interp_cfg) if interp_cfg else None
        self._env = dict(env or {})
        self._respawn = bool(respawn)
        self._respawn_backoff_s = respawn_backoff_s
        self._monitor_interval_s = monitor_interval_s
        self._ready_timeout_s = ready_timeout_s
        # fleet observability: the ROUTER samples (its decision rides
        # the wire, so replicas trace exactly the sampled set without
        # their own sampling rate); trace_sample also reaches replicas
        # so locally-originated diagnostics share the same knob
        router_kwargs = dict(router_kwargs or {})
        if trace_sample:
            router_kwargs.setdefault('trace_sample', trace_sample)
            self._service.setdefault('trace_sample', trace_sample)
        if slo_budgets:
            router_kwargs.setdefault('slo_budgets', dict(slo_budgets))
        if integrity:
            # end-to-end digests across the wire (docs/ROBUSTNESS.md
            # "Integrity"): submit-time program CRC verified by the
            # replica, replica-stamped result digest verified here
            router_kwargs.setdefault('integrity', True)
        if tenants:
            # one tenant config for the whole fleet: every replica
            # enforces the same weights/quotas, so a tenant cannot
            # route around its limits by landing on another replica
            # (docs/SERVING.md "Tenants")
            self._service.setdefault('tenants', dict(tenants))
        # SLO-driven elasticity: dict of AutoscalePolicy kwargs, an
        # AutoscalePolicy instance, or True for defaults; None = off
        if autoscale is True:
            autoscale = AutoscalePolicy()
        elif isinstance(autoscale, dict):
            autoscale = AutoscalePolicy(**autoscale)
        self._autoscale = autoscale
        self._scale_ups = 0
        self._scale_downs = 0
        self.router = FleetRouter(name=self.name, **router_kwargs)
        self._lock = threading.Lock()
        self._closing = False
        self._replicas = [_ReplicaProc(f'r{i}')
                          for i in range(n_replicas)]
        try:
            self._spawn_all()
        except BaseException:
            self.shutdown()
            raise
        self._monitor = threading.Thread(
            target=self._monitor_loop,
            name=f'{ROUTER_THREAD_PREFIX}-monitor-{self.name}',
            daemon=True)
        self._monitor.start()

    # -- spawning --------------------------------------------------------

    def _replica_config(self, rid: str) -> dict:
        cfg = {
            'rid': rid,
            'env': self._env,
            'service': dict(self._service),
        }
        cfg['service'].setdefault(
            'compile_cache_dir', os.path.join(self.shared_dir,
                                              'compile'))
        cfg['service'].setdefault(
            'warmup_catalog', os.path.join(self.shared_dir,
                                           'catalog.json'))
        if self._interp_cfg:
            cfg['interp_cfg'] = self._interp_cfg
        return cfg

    def _spawn(self, slot: _ReplicaProc) -> None:
        env = dict(os.environ)
        env['PYTHONPATH'] = _PKG_ROOT + os.pathsep \
            + env.get('PYTHONPATH', '')
        env.update({k: str(v) for k, v in self._env.items()})
        slot.log_path = os.path.join(
            self.shared_dir, 'logs',
            f'{slot.rid}.{slot.respawns}.log')
        log = open(slot.log_path, 'wb')
        try:
            proc = subprocess.Popen(
                [sys.executable, '-m',
                 'distributed_processor_tpu_torch.serve.replica_main',
                 json.dumps(self._replica_config(slot.rid))],
                stdout=subprocess.PIPE, stderr=log, env=env,
                cwd=_PKG_ROOT)
        finally:
            log.close()
        ready = self._read_ready(slot, proc)
        slot.proc = proc
        slot.address = (ready['host'], ready['port'])
        slot.spawned_t = time.monotonic()
        slot.wedged = False
        self.router.add_replica(slot.rid, slot.address)

    def _read_ready(self, slot, proc) -> dict:
        """Block (bounded) for the replica's JSON ready line.  A fleet
        shutting down abandons the wait within a second and kills the
        booting replica, so a respawn racing ``shutdown`` leaves no
        process behind."""
        deadline = time.monotonic() + self._ready_timeout_s
        buf = b''
        fd = proc.stdout.fileno()
        while b'\n' not in buf:
            remain = deadline - time.monotonic()
            if remain <= 0 or proc.poll() is not None or self._closing:
                proc.kill()
                proc.wait()
                proc.stdout.close()
                raise RuntimeError(
                    f'replica {slot.rid} failed to become ready '
                    f'(exit={proc.poll()}): {self._log_tail(slot)}')
            r, _, _ = select.select([fd], [], [], min(remain, 1.0))
            if r:
                chunk = os.read(fd, 4096)
                if not chunk:
                    continue
                buf += chunk
        return json.loads(buf.split(b'\n', 1)[0])

    def _log_tail(self, slot, n: int = 2000) -> str:
        try:
            with open(slot.log_path, 'rb') as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode('utf-8', 'replace')
        except OSError:
            return '<no log>'

    def _spawn_all(self) -> None:
        # replicas import torch independently — spawn concurrently so
        # fleet startup is one replica's boot time, not the sum
        errs = []

        def boot(slot):
            try:
                self._spawn(slot)
            except BaseException as exc:   # noqa: BLE001
                errs.append((slot.rid, exc))

        threads = [threading.Thread(
            target=boot, args=(s,),
            name=f'{ROUTER_THREAD_PREFIX}-spawn-{s.rid}', daemon=True)
            for s in self._replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise RuntimeError(
                f'fleet spawn failed: {errs[0][0]}: {errs[0][1]}')

    # -- supervision -----------------------------------------------------

    def _monitor_loop(self) -> None:
        while True:
            with self._lock:
                if self._closing:
                    return
                slots = list(self._replicas)
            for slot in slots:
                proc = slot.proc
                # proc None = a scale-up slot whose first spawn
                # failed; retry it like a death
                if proc is not None and proc.poll() is None:
                    continue
                if self._closing or not self._respawn:
                    continue
                time.sleep(self._respawn_backoff_s)
                with self._lock:
                    if self._closing:
                        return
                    if slot not in self._replicas:
                        continue    # scaled away during the backoff
                slot.respawns += 1
                try:
                    self._spawn(slot)
                except RuntimeError:
                    # spawn failed (e.g. mid-shutdown): retry next tick
                    pass
            self._autoscale_tick()
            time.sleep(self._monitor_interval_s)

    def _autoscale_tick(self) -> None:
        """One elasticity decision on the monitor cadence: integrate
        the router's SLO level signal through the policy's hysteresis
        and apply at most one single-step scaling action."""
        policy = self._autoscale
        if policy is None or self._closing:
            return
        with self._lock:
            n = len(self._replicas)
        act = policy.decide(self.router.slo_breached(), n,
                            time.monotonic())
        if act == 'up':
            self.scale_to(n + 1, reason='slo-breach')
        elif act == 'down':
            self.scale_to(n - 1, reason='slo-slack')

    def scale_to(self, n: int, reason: str = 'manual') -> int:
        """Set the replica population to ``n``: spawn fresh replicas
        (they land warm off the shared tiers) or retire the
        highest-index ones — a retired replica's in-flight work fails
        over through :meth:`~.router.FleetRouter.remove_replica`
        BEFORE its process dies, so scale-down loses nothing.  Returns
        the new population.  Edge-triggered ``autoscale_up`` /
        ``autoscale_down`` flight events make every scaling act
        visible in the incident timeline."""
        n = max(1, int(n))
        with self._lock:
            if self._closing:
                return len(self._replicas)
            cur = len(self._replicas)
            if n == cur:
                return cur
            if n > cur:
                grown = [_ReplicaProc(f'r{i}') for i in range(cur, n)]
                self._replicas.extend(grown)
                victims = []
                self._scale_ups += 1
            else:
                grown = []
                victims = self._replicas[n:]
                del self._replicas[n:]
                self._scale_downs += 1
        direction = 'up' if grown else 'down'
        profiling.counter_inc(f'fleet.autoscale_{direction}')
        self.router.flight_recorder.record(
            f'autoscale_{direction}', reason=reason,
            n_from=cur, n_to=n)
        for slot in grown:
            try:
                self._spawn(slot)
            except RuntimeError:
                pass            # monitor retries on its next tick
        for slot in victims:
            self.router.remove_replica(slot.rid)
            proc = slot.proc
            if proc is None:
                continue
            try:
                os.kill(proc.pid, signal.SIGCONT)   # unwedge first
            except OSError:
                pass
            proc.terminate()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
            if proc.stdout is not None:
                proc.stdout.close()
        return n

    # -- chaos hooks -----------------------------------------------------

    def pid(self, idx: int) -> int:
        return self._replicas[idx].proc.pid

    def kill(self, idx: int) -> None:
        """SIGKILL a replica process: connection-loss failover (the
        monitor respawns it when ``respawn=True``)."""
        self._replicas[idx].proc.kill()

    def wedge(self, idx: int) -> None:
        """SIGSTOP a replica: it stops making progress while its TCP
        connection stays open — only gossip staleness can catch it."""
        os.kill(self._replicas[idx].proc.pid, signal.SIGSTOP)
        self._replicas[idx].wedged = True

    def unwedge(self, idx: int) -> None:
        """SIGCONT a wedged replica: its next heartbeat re-admits it."""
        os.kill(self._replicas[idx].proc.pid, signal.SIGCONT)
        self._replicas[idx].wedged = False

    # -- serving API -----------------------------------------------------

    def submit(self, *args, **kw):
        return self.router.submit(*args, **kw)

    def submit_source(self, *args, **kw):
        return self.router.submit_source(*args, **kw)

    # streaming sessions (docs/SERVING.md "Streaming sessions"):
    # process-backed streams route exactly like the router's — the
    # fleet adds supervised respawn of a session's home replica
    def open_stream(self, *args, **kw):
        return self.router.open_stream(*args, **kw)

    def submit_rounds(self, *args, **kw):
        return self.router.submit_rounds(*args, **kw)

    def close_stream(self, sid: int) -> bool:
        return self.router.close_stream(sid)

    def replica_ids(self) -> list:
        return [s.rid for s in self._replicas]

    def replica_stats(self, idx_or_rid) -> dict:
        rid = idx_or_rid if isinstance(idx_or_rid, str) \
            else self._replicas[idx_or_rid].rid
        return self.router.call_replica(rid, 'stats')

    # -- fleet observability (docs/OBSERVABILITY.md) ---------------------

    def set_trace_sample(self, sample: float) -> None:
        self.router.set_trace_sample(sample)

    def prometheus_text(self) -> str:
        """Merged fleet exposition: every replica's metrics with a
        ``replica`` label + rollups + the router's own fleet metrics."""
        return self.router.prometheus_text()

    def merged_flight(self, pull: bool = True) -> dict:
        """Federated flight-recorder timeline (router + replicas)."""
        return self.router.merged_flight(pull=pull)

    def dump_trace(self, path: str) -> int:
        """Write the stitched fleet Chrome Trace; returns event count."""
        return self.router.dump_trace(path)

    def stats(self) -> dict:
        snap = self.router.stats()
        with self._lock:
            snap['processes'] = {
                s.rid: {
                    'pid': s.proc.pid if s.proc else None,
                    'running': s.proc is not None
                    and s.proc.poll() is None,
                    'wedged': s.wedged,
                    'respawns': s.respawns,
                } for s in self._replicas}
            snap['autoscale'] = {
                'enabled': self._autoscale is not None,
                'scale_ups': self._scale_ups,
                'scale_downs': self._scale_downs,
                'policy': self._autoscale.snapshot()
                if self._autoscale is not None else None,
            }
        snap['shared_dir'] = self.shared_dir
        return snap

    # -- teardown --------------------------------------------------------

    def shutdown(self, timeout_s: float = 20.0) -> None:
        """Stop the monitor, gracefully stop every replica (escalating
        to SIGKILL), shut the router down, clean the temp shared dir.
        Idempotent; after it returns no fleet thread or process
        remains."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        if getattr(self, '_monitor', None) is not None:
            self._monitor.join(timeout=5.0)
        deadline = time.monotonic() + timeout_s
        for slot in self._replicas:
            proc = slot.proc
            if proc is None or proc.poll() is not None:
                continue
            try:
                os.kill(proc.pid, signal.SIGCONT)   # unwedge first
            except OSError:
                pass
            try:
                self.router.call_replica(slot.rid, 'shutdown',
                                         timeout_s=2.0)
            except Exception:          # noqa: BLE001 - escalate below
                pass
            proc.terminate()
        for slot in self._replicas:
            proc = slot.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
            if proc.stdout is not None:
                proc.stdout.close()
        self.router.shutdown()
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.shutdown()
