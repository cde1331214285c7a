"""The readers of the port's host spans (``obs/trace.py``) on synthetic
spans: each new metric from a known taxonomy, only the spans inside the
traced window, and nothing (``None``) where there are no spans, the ring
dropped any, or the port has no host spans at all."""

from __future__ import annotations

import sys

import pytest

from benchmark.harness.cell import read_metric

trace = pytest.importorskip('distributed_processor_tpu_torch.obs.trace')

CAMPAIGN = ('exec_enqueue_ms_per_batch.campaign',
            'host_syncs_per_batch.campaign', 'idle_port_host_pct.campaign')
EVERY = CAMPAIGN + ('enqueue_ms_per_batch.tenants',
                    'rounds_host_ms_per_call.stream',
                    'idle_port_host_pct.tenants',
                    'idle_port_host_pct.stream')


class Spans:
    """Synthetic spans in the port's ring, each with its parent."""

    def __init__(self, ring):
        self.ring, self.n = ring, 0

    def add(self, name, t0, t1, parent=None, thread=1, **args):
        self.n += 1
        self.ring.append(dict(name=name, t0=t0, t1=t1, args=args, id=self.n,
                              parent=parent, thread=thread))
        return self.n


@pytest.fixture
def spans(monkeypatch):
    ring = trace.HostSpanRing()
    monkeypatch.setattr(trace, 'HOST_SPANS', ring)
    return Spans(ring)


def rec(window=(0, 10_000_000), device=()):
    return dict(events=dict(window=window, device=list(device), spans=[],
                            outside=0),
                work={}, window={}, layers=lambda layer: [])


def physics_batch(sp, t):
    """One 1 ms batch of two epochs (the second only checks) and its
    0.1 ms reduction, from ``t``: exec 0.3 ms, of which a copy to the
    device waits 0.02 ms, waits 0.05 and 0.08 ms."""
    b = sp.add('physics.batch', t, t + 1_000_000, shots=64,
               engine='straightline')
    sp.add('physics.prepare', t, t + 100_000, b)
    e0 = sp.add('physics.epoch', t + 100_000, t + 600_000, b, ep=0)
    sp.add('physics.wait', t + 100_000, t + 150_000, e0)
    x = sp.add('physics.exec', t + 150_000, t + 450_000, e0)
    sp.add('h2d.wait', t + 200_000, t + 220_000, x)
    sp.add('physics.resolve', t + 450_000, t + 600_000, e0)
    e1 = sp.add('physics.epoch', t + 600_000, t + 700_000, b, ep=1)
    sp.add('physics.wait', t + 600_000, t + 680_000, e1)
    sp.add('physics.finalize', t + 700_000, t + 1_000_000, b)
    sp.add('sweep.stats', t + 1_000_000, t + 1_100_000)


def test_campaign_readers(spans):
    for k in range(3):
        physics_batch(spans, 2_000_000 * k)
    physics_batch(spans, 20_000_000)          # outside the window
    r = rec(device=[('k', 0, 150_000), ('k', 2_000_000, 2_500_000)])
    assert read_metric('exec_enqueue_ms_per_batch.campaign', r) == \
        pytest.approx(0.28)
    assert read_metric('host_syncs_per_batch.campaign', r) == 3.0
    # the host works but for the waits (0.15 ms a batch) over 1.1 ms a
    # batch; the device covers 0.1 ms of batch 0's work and 0.5 ms of
    # batch 1's
    work = 3 * (1_100_000 - 150_000) - 100_000 - (500_000 - 50_000 - 20_000)
    assert read_metric('idle_port_host_pct.campaign', r) == \
        pytest.approx(100.0 * work / 10_000_000)


def test_a_wait_outside_the_batch_is_no_sync_of_it(spans):
    physics_batch(spans, 0)
    spans.add('rounds.wait', 1_200_000, 1_300_000)
    b = spans.add('other', 1_400_000, 1_500_000)
    spans.add('other.wait', 1_400_000, 1_450_000, b)
    assert read_metric('host_syncs_per_batch.campaign', rec()) == 3.0


def test_tenants_readers(spans):
    for k, ms in enumerate((2, 4)):
        t = 3_000_000 * k
        spans.add('serve.pack', t, t + 100_000, thread=9)
        e = spans.add('serve.enqueue', t + 100_000,
                      t + 100_000 + ms * 1_000_000, thread=9)
        # the step loop's settle test waits 0.5 ms
        spans.add('step.wait', t + 600_000, t + 1_100_000, e, thread=9)
    r = rec()
    assert read_metric('enqueue_ms_per_batch.tenants', r) == \
        pytest.approx(2.5)
    # no device activity: all 5.2 ms of the dispatcher's work but its
    # waits is idle
    assert read_metric('idle_port_host_pct.tenants', r) == \
        pytest.approx(100.0 * 5_200_000 / 10_000_000)


def test_stream_readers(spans):
    for k in range(4):
        t = 1_000_000 * k
        c = spans.add('rounds.call', t, t + 900_000)
        spans.add('rounds.prepare', t, t + 100_000, c)
        spans.add('rounds.exec', t + 100_000, t + 300_000, c)
        spans.add('rounds.decode', t + 300_000, t + 400_000, c)
        spans.add('rounds.wait', t + 400_000, t + 900_000, c)
    r = rec(window=(0, 4_000_000), device=[('k', 0, 4_000_000)])
    assert read_metric('rounds_host_ms_per_call.stream', r) == \
        pytest.approx(0.4)
    assert read_metric('idle_port_host_pct.stream', r) == 0.0


def test_two_threads_count_once_where_they_overlap(spans):
    spans.add('serve.enqueue', 0, 2_000_000, thread=1)
    spans.add('physics.exec', 1_000_000, 3_000_000, thread=2)
    assert read_metric('idle_port_host_pct.tenants', rec()) == \
        pytest.approx(30.0)


@pytest.mark.parametrize('name', EVERY)
def test_nothing_without_spans(spans, name):
    assert read_metric(name, rec()) is None


@pytest.mark.parametrize('name', EVERY)
def test_nothing_where_the_ring_dropped_spans(monkeypatch, name):
    ring = trace.HostSpanRing(capacity=12)
    monkeypatch.setattr(trace, 'HOST_SPANS', ring)
    sp = Spans(ring)
    for k in range(2):
        physics_batch(sp, 2_000_000 * k)
        sp.add('serve.enqueue', 0, 1000)
        c = sp.add('rounds.call', 0, 1000)
        sp.add('rounds.exec', 0, 1000, c)
    assert ring.dropped > 0
    assert read_metric(name, rec()) is None


@pytest.mark.parametrize('name', EVERY)
def test_nothing_from_a_port_without_host_spans(spans, monkeypatch, name):
    physics_batch(spans, 0)
    monkeypatch.setitem(sys.modules,
                        'distributed_processor_tpu_torch.obs.trace', None)
    assert read_metric(name, rec()) is None


@pytest.mark.parametrize('name', CAMPAIGN[:2])
def test_campaign_readers_need_a_batch(spans, name):
    spans.add('sweep.stats', 0, 1000)
    assert read_metric(name, rec()) is None
