"""The port's plain readout resolver against the JAX fused resolver.

``resolve_windows_reference`` (the plain torch version of the CUDA
kernel ``csrc/resolve.cu``) is held against the JAX package's
``ops/resolve_pallas.resolve_windows_fused`` run as the JAX tests run it
on the CPU: Pallas interpret mode with the streamed noise generator.
Inputs are made from a seed with numpy; ring-up on and off; static-row
and full-table envelope modes.  At sigma > 0 the JAX streamed normals are
regenerated chunk by chunk and handed to the port as ``noise``.

Tolerance: rtol 1e-5 with atol 1e-5 * max|energy| — the two sum the
window in different orders (the JAX kernel per 128-lane tile and chunk,
torch per chunk), so the float32 sums agree to rounding, not bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_processor_tpu.ops import resolve_pallas as jres
from distributed_processor_tpu.ops import waveform as jwave
from distributed_processor_tpu.sim import physics as jphys

from distributed_processor_tpu_torch.ops import resolve as tres
from distributed_processor_tpu_torch.ops import waveform as twave
from distributed_processor_tpu_torch.sim import physics as tphys

B, C, L, F, W, CK = 40, 3, 20, 2, 256, 128
INTERPS = (4, 2, 1)
ROWS = (0, 8, 28)


def _inputs(seed: int, rows):
    rng = np.random.default_rng(seed)
    env = rng.uniform(-1, 1, (C, L, 2)).astype(np.float32)
    freq = rng.uniform(-0.2, 0.2, (C, F)).astype(np.float32)
    if rows is not None:
        addr = np.asarray(rows)[rng.integers(len(rows), size=(B, C, 1))]
    else:
        # full-table mode clips the address into the table: cover
        # negative and past-the-end addresses too
        addr = rng.integers(-8, L + 48, (B, C, 1))
    sc = dict(
        amp=rng.uniform(0, 1, (B, C, 1)).astype(np.float32),
        cosA=None, sinA=None,
        f_idx=rng.integers(0, F, (B, C, 1)).astype(np.int32),
        addr=addr.astype(np.int32),
        n_samp=rng.integers(0, W + 40, (B, C, 1)).astype(np.int32))
    angle = rng.uniform(0, 2 * np.pi, (B, C, 1)).astype(np.float32)
    sc['cosA'], sc['sinA'] = np.cos(angle), np.sin(angle)
    gs = rng.uniform(-1, 1, (2, B, C)).astype(np.float32)
    return env, freq, sc, gs


def _jax_tables(env, freq, rows):
    pad = jphys._aligned_chunk(CK, W, INTERPS)
    env_pads = jphys._pad_env_planes(jnp.asarray(env), pad)
    basis = jphys._carrier_basis(jnp.asarray(freq), W)
    return jres.build_fused_tables(env_pads, basis, W, INTERPS, CK,
                                   rows=rows), env_pads[0].shape[1]


def _torch_tables(env, freq, rows):
    pad = tphys._aligned_chunk(CK, W, INTERPS)
    env_pads = tphys._pad_env_planes(torch.as_tensor(env), pad)
    basis = tphys._carrier_basis(torch.as_tensor(freq), W)
    return tres.build_fused_tables(env_pads, basis, W, INTERPS, rows=rows), \
        env_pads[0].shape[1]


def _jax_streamed_noise(key, sigma):
    """The streamed normals the JAX kernel draws chunk by chunk
    (``resolve_pallas._resolve_call``), at the tile-padded batch, cut
    back to ``[2, C, B, W]``."""
    b_pad = -(-B // 256) * 256
    chunks = [jnp.float32(sigma) * jax.random.normal(
        jax.random.fold_in(key, k), (2, C, b_pad, CK), jnp.float32)
        for k in range(-(-W // CK))]
    return np.asarray(jnp.concatenate(chunks, -1))[:, :, :B, :W].copy()


@pytest.mark.parametrize('sigma', [0.0, 0.3])
@pytest.mark.parametrize('rows', [ROWS, None], ids=['rows', 'full'])
@pytest.mark.parametrize('ring', [False, True])
def test_reference_matches_jax_fused(ring, rows, sigma):
    env, freq, sc_np, gs = _inputs(11, rows)
    inv_ring = 1.0 / 30.0
    key = jax.random.PRNGKey(5)
    jt, lp_j = _jax_tables(env, freq, rows)
    want = jres.resolve_windows_fused(
        {k: jnp.asarray(v) for k, v in sc_np.items()}, jt,
        jnp.asarray(gs[0]), jnp.asarray(gs[1]), sigma, inv_ring, key, W,
        lp_j, ck=CK, ring=ring, native_rng=False, rows=rows,
        interpret=True)
    want = [np.asarray(a)[..., 0] for a in want]
    tt, lp_t = _torch_tables(env, freq, rows)
    assert lp_t == lp_j
    noise = None if sigma == 0 else torch.as_tensor(
        _jax_streamed_noise(key, sigma))
    got = tres.resolve_windows_reference(
        {k: torch.as_tensor(v) for k, v in sc_np.items()}, tt,
        torch.as_tensor(gs[0]), torch.as_tensor(gs[1]), sigma, inv_ring,
        0, W, lp_t, ring=ring, noise=noise, ck=CK)
    scale = float(np.abs(want[2]).max())
    assert scale > 1.0
    for name, g, w in zip(('acc_i', 'acc_q', 'energy'), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_wrapper_takes_plain_version_on_cpu():
    env, freq, sc_np, gs = _inputs(3, ROWS)
    tt, lp = _torch_tables(env, freq, ROWS)
    sc = {k: torch.as_tensor(v) for k, v in sc_np.items()}
    args = (sc, tt, torch.as_tensor(gs[0]), torch.as_tensor(gs[1]), 0.2,
            0.0, 9, W, lp)
    before = tres.resolve_windows_fused.launches
    got = tres.resolve_windows_fused(*args, epoch=2, ck=CK)
    want = tres.resolve_windows_reference(*args, epoch=2, ck=CK)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the CPU path is no kernel launch
    assert tres.resolve_windows_fused.launches == before
    # the plain version's own noise: seeded by (seed, epoch)
    again = tres.resolve_windows_reference(*args, epoch=2, ck=CK)
    other = tres.resolve_windows_reference(*args, epoch=3, ck=CK)
    assert torch.equal(again[0], want[0])
    assert not torch.equal(other[0], want[0])


def test_wrapper_rejects_other_devices():
    env, freq, sc_np, gs = _inputs(3, ROWS)
    tt, lp = _torch_tables(env, freq, ROWS)
    sc = {k: torch.as_tensor(v, device='meta') for k, v in sc_np.items()}
    with pytest.raises(ValueError, match='device'):
        tres.resolve_windows_fused(sc, tt, torch.as_tensor(gs[0]),
                                   torch.as_tensor(gs[1]), 0.0, 0.0, 0, W,
                                   lp)


def test_fused_chunk_rule_matches_jax():
    for chunk, w in ((256, 1024), (512, 1024), (None, 300), (100, 64)):
        assert tres.fused_chunk(chunk, w) == jres.fused_chunk(chunk, w)


def test_carrier_phase_matches_jax():
    """The split-precision NCO: the head's wrapping int32 product (the
    port takes it in int64 and keeps the low 16 bits) gives the JAX
    phase, out to sample counts that overflow int32 products."""
    rng = np.random.default_rng(4)
    f = rng.uniform(-0.5, 0.5, 64).astype(np.float32)
    n = np.concatenate([rng.integers(0, 2**31 - 1, 48),
                        [0, 1, 2**31 - 1, 2**30, 65535, 65536] * 2 + [7] * 4
                        ]).astype(np.int32)
    ph = rng.uniform(0, 6, 64).astype(np.float32)
    want = np.asarray(jwave.carrier_phase(jnp.asarray(f), jnp.asarray(n),
                                          jnp.asarray(ph)))
    got = twave.carrier_phase(torch.as_tensor(f), torch.as_tensor(n),
                              torch.as_tensor(ph)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the integer head alone is exact
    inc = np.round(f.astype(np.float32) * 65536.0).astype(np.int32)
    head = ((inc.astype(np.int64) * n) & 0xffff)
    head_jax = np.asarray((jnp.asarray(inc) * jnp.asarray(n)) & 0xffff)
    np.testing.assert_array_equal(head, head_jax)
    assert twave.PHASE_BITS == jwave.PHASE_BITS
    assert twave.AMP_SCALE == jwave.AMP_SCALE
