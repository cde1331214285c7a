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


# ---------------------------------------------------------------------------
# the rows-mode kernel's prefix tables (ops/resolve.build_prefix_tables)


def _chain_z2(tt, lp):
    """The plain chain's per-sample window, sample by sample in float64
    numpy: ``|z|^2 [C, R, F, W]`` and ``z``, with
    ``z = env[min(row + s // interp, Lp - 1)] * (cos + i sin)[f, s]``."""
    env = tt['env'].double().numpy()
    bas = tt['bas'].double().numpy()
    rows = tt['rows'].tolist()
    z = np.zeros((C, len(rows), F, W), complex)
    for c in range(C):
        for r, row in enumerate(rows):
            for s in range(W):
                k = min(row + s // INTERPS[c], lp - 1)
                e = env[c, 0, k] + 1j * env[c, 1, k]
                z[c, r, :, s] = e * (bas[c, 0, :, s] + 1j * bas[c, 1, :, s])
    return np.abs(z) ** 2, z


def _cumsum0(x):
    return np.concatenate([np.zeros(x.shape[:-1] + (1,)),
                           np.cumsum(x, -1)], -1)


@pytest.mark.parametrize('ring', [False, True])
def test_prefix_tables_are_cumsums_of_the_chain(ring):
    env, freq, _sc, _gs = _inputs(11, ROWS)
    tt, lp = _torch_tables(env, freq, ROWS)
    inv_ring = float(np.float32(1.0 / 30.0))
    pre = tres.build_prefix_tables(tt, inv_ring if ring else None)
    z2, z = _chain_z2(tt, lp)
    w = 1.0 - np.exp(-np.arange(1, W + 1) * inv_ring) if ring else 1.0
    for name, want in (('p1', _cumsum0(z2)), ('pw', _cumsum0(w * z2))):
        got = pre[name]
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (C, len(ROWS), F, W + 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * want.max(), err_msg=name)
    assert float(pre['p1'][..., 0].abs().max()) == 0.0
    np.testing.assert_allclose(pre['z'].numpy(),
                               np.stack([z.real, z.imag], -1), rtol=1e-6,
                               atol=1e-6)
    # and they are what the plain chain sums: energy at amp 1, A = 0 over
    # a window of n samples is P1[n] of its (core, row, frequency)
    rng = np.random.default_rng(2)
    n = rng.integers(0, W + 1, (B, C))
    ri = rng.integers(0, len(ROWS), (B, C))
    fi = rng.integers(0, F, (B, C))
    ones = torch.ones((B, C, 1))
    sc = dict(amp=ones, cosA=ones, sinA=0 * ones,
              f_idx=torch.as_tensor(fi[..., None], dtype=torch.int32),
              addr=torch.as_tensor(np.asarray(ROWS)[ri][..., None],
                                   dtype=torch.int32),
              n_samp=torch.as_tensor(n[..., None], dtype=torch.int32))
    g = torch.ones((B, C))
    acc_i, _acc_q, energy = tres.resolve_windows_reference(
        sc, tt, g, 0 * g, 0.0, inv_ring, 0, W, lp, ring=ring, ck=CK)
    c_idx = np.arange(C)[None, :]
    np.testing.assert_allclose(
        energy.numpy(), pre['p1'].numpy()[c_idx, ri, fi, n], rtol=1e-5,
        atol=1e-5 * float(energy.max()))
    np.testing.assert_allclose(
        acc_i.numpy(), pre['pw'].numpy()[c_idx, ri, fi, n], rtol=1e-5,
        atol=1e-5 * float(energy.max()))


def test_prefix_tables_built_once_per_ring():
    env, freq, _sc, _gs = _inputs(11, ROWS)
    tt, _lp = _torch_tables(env, freq, ROWS)
    a = tres._prefix_tables(tt, 1.0 / 30.0, ring=True)
    assert tres._prefix_tables(tt, np.float32(1.0 / 30.0), ring=True) is a
    b = tres._prefix_tables(tt, 1.0 / 30.0, ring=False)
    assert b is not a and b['pw'] is b['p1']
    assert tres._prefix_tables(tt, 0.5, ring=False) is b
    assert set(tt['prefix']) == {None, float(np.float32(1.0 / 30.0))}
    full, _ = _torch_tables(env, freq, None)
    with pytest.raises(ValueError, match='static row'):
        tres.build_prefix_tables(full)


def _factored(sc, tt, gs_i, gs_q, sigma, inv_ring, ring, noise):
    """The rows-mode kernel's arithmetic in torch (test only): the
    deterministic sums read from the prefix tables at ``n = min(nsamp,
    W)``, plus the streamed noise's projection ``a e^{-iA} sum_{s<n}
    noise(s) conj(z(s))`` over the window's z row."""
    pre = tres.build_prefix_tables(tt, inv_ring if ring else None)
    amp, ca, sa = (sc[k][..., 0] for k in ('amp', 'cosA', 'sinA'))
    n = sc['n_samp'][..., 0].clamp(0, W).long()
    r = torch.zeros_like(n)
    for i, row in enumerate(tt['rows'].tolist()):
        r = torch.where(sc['addr'][..., 0] == row, i, r)
    f = sc['f_idx'][..., 0].long()
    c = torch.arange(C)[None, :]
    k = amp * amp * (ca * ca + sa * sa)
    energy = k * pre['p1'][c, r, f, n]
    kw = k * pre['pw'][c, r, f, n]
    acc_i, acc_q = gs_i * kw, gs_q * kw
    if noise is not None:
        z = pre['z'][c, r, f]                                # [B, C, W, 2]
        live = torch.arange(W)[None, None, :] < n[..., None]
        n_i = torch.where(live, noise[0].transpose(0, 1), 0.0)
        n_q = torch.where(live, noise[1].transpose(0, 1), 0.0)
        x = (n_i * z[..., 0] + n_q * z[..., 1]).sum(-1)
        y = (n_q * z[..., 0] - n_i * z[..., 1]).sum(-1)
        acc_i = acc_i + amp * (x * ca + y * sa)
        acc_q = acc_q + amp * (y * ca - x * sa)
    return acc_i, acc_q, energy


@pytest.mark.parametrize('nsamp', ['short', 'overlong'])
@pytest.mark.parametrize('sigma', [0.0, 0.3])
@pytest.mark.parametrize('ring', [False, True])
def test_factored_form_matches_reference_and_jax(ring, sigma, nsamp):
    """The rows-mode kernel's factored form (prefix tables plus the noise
    projection) against the plain chain and JAX ``resolve_pallas`` in
    interpret mode, on the same streamed noise."""
    env, freq, sc_np, gs = _inputs(13, ROWS)
    rng = np.random.default_rng(14)
    sc_np['n_samp'] = (rng.integers(0, W // 2, (B, C, 1)) if nsamp == 'short'
                       else rng.integers(W, W + 40, (B, C, 1))
                       ).astype(np.int32)
    inv_ring = float(np.float32(1.0 / 30.0))
    key = jax.random.PRNGKey(6)
    jt, lp_j = _jax_tables(env, freq, ROWS)
    want_j = jres.resolve_windows_fused(
        {k: jnp.asarray(v) for k, v in sc_np.items()}, jt,
        jnp.asarray(gs[0]), jnp.asarray(gs[1]), sigma, inv_ring, key, W,
        lp_j, ck=CK, ring=ring, native_rng=False, rows=ROWS,
        interpret=True)
    want_j = [np.asarray(a)[..., 0] for a in want_j]
    tt, lp = _torch_tables(env, freq, ROWS)
    sc = {k: torch.as_tensor(v) for k, v in sc_np.items()}
    noise = None if sigma == 0 else torch.as_tensor(
        _jax_streamed_noise(key, sigma))
    g_i, g_q = torch.as_tensor(gs[0]), torch.as_tensor(gs[1])
    got = _factored(sc, tt, g_i, g_q, sigma, inv_ring, ring, noise)
    want_t = tres.resolve_windows_reference(
        sc, tt, g_i, g_q, sigma, inv_ring, 0, W, lp, ring=ring, noise=noise,
        ck=CK)
    scale = float(np.abs(want_j[2]).max())
    assert scale > 1.0
    for name, g, wt, wj in zip(('acc_i', 'acc_q', 'energy'), got, want_t,
                               want_j):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(g.numpy(), wj, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
