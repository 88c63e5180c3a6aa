"""K3's bodies as the card runs them (csrc/anti_alias_snake_tmajor.cu),
emulated in numpy on the CPU against their plain versions and the JAX kernel.

The kernels run only on the card (tests/test_torch_cuda_kernels.py). What can
go wrong in them without the compiler noticing is arithmetic on indices. For
the tensor-core body (1) that is: the band fragments in mma.sync's B layout,
the x words of each lane's A fragment, the C fragments of two consecutive up
n-blocks taken as the A fragment of the down product, the bf16 rounding of
the phase samples, the quad shuffles of the row-end clamp and the quad
transpose of the 16-byte stores, the steps that skip the clamp, and the walk
of a warp along its run and the split of the rows into runs. The emulation below follows the
kernel step by step, for the 32 lanes of a warp at once; each mma builds its
16 x 16 and 16 x 8 operands from the lanes' fragments and hands the product
back in the C layout. The carried so[T - 1] starts as NaN here, so an output
that read it before the kernel sets it would not be finite. The CUDA-core
body (0) and the pass-through (2) are the lane scheme of aa_lanes.cuh, run
through tests/test_torch_aa_lanes.py's emulation at K3's shapes."""

import numpy as np
import pytest
import torch

from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3
from tests.test_torch_aa_lanes import CHUNK, LANE_F, F, emulate, poly_sin, split, to_bf16

ROWS, NB, STEP = 16, 8, 2  # mx:: of the kernel
MX_WARPS, MX_MIN_BLOCKS = 4, 5
LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3
QUAD = LANE & ~3


def split_units(nrows: int, units: int, wave: int, warps: int):
    """aa_lanes::split_units: (units per warp, warps per row, blocks)."""
    cpw = min(units, max(1, -(-(nrows * units) // wave)))
    waves = -(-(nrows * -(-units // cpw)) // wave)
    fit = wave // max(nrows, 1)
    if waves > 1 and fit >= 1 and -(-units // fit) < waves * cpw:
        cpw = -(-units // fit)
    segs = -(-units // cpw)
    return cpw, segs, -(-(nrows * segs) // warps)


def mma_split(nrows: int, t_len: int, sms: int, step: int = STEP):
    """launch_mma's split: row tiles of 16 rows, steps of 8 step output frames."""
    return split_units(-(-nrows // ROWS), -(-t_len // (NB * step)), sms * MX_WARPS * MX_MIN_BLOCKS, MX_WARPS)


def band_fragments() -> np.ndarray:
    """band_fragments: [8, 32, 2], frag[2p + h][lane] = (B[k][g], B[k + 1][g]) of
    p = E, O, Ye, Yo at k = 2q + 8h, rounded to bf16."""
    at = lambda j: F[j] if 0 <= j < 12 else 0.0
    fr = np.zeros((8, 32, 2), np.float32)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for h in range(2):
            k = 2 * q + 8 * h
            fr[0 + h, lane] = 2 * at(13 - 2 * k + 2 * g), 2 * at(11 - 2 * k + 2 * g)
            fr[2 + h, lane] = 2 * at(14 - 2 * k + 2 * g), 2 * at(12 - 2 * k + 2 * g)
            fr[4 + h, lane] = at(2 * k - 2 * g - 3), at(2 * k - 2 * g - 1)
            fr[6 + h, lane] = at(2 * k - 2 * g - 2), at(2 * k - 2 * g)
    return to_bf16(fr)


def mma(a, b0, b1) -> np.ndarray:
    """mma.sync m16n8k16 on the lanes' fragments: a = (a0, a1, a2, a3), each
    [32, 2]; b0, b1 [32, 2]. Returns the C fragments [32, 4] (float32)."""
    am = np.zeros((16, 16), np.float32)
    bm = np.zeros((16, 8), np.float32)
    cols = 2 * Q[:, None] + np.arange(2)
    am[G[:, None], cols], am[G[:, None] + 8, cols] = a[0], a[1]
    am[G[:, None], cols + 8], am[G[:, None] + 8, cols + 8] = a[2], a[3]
    bm[cols, G[:, None]], bm[cols + 8, G[:, None]] = b0, b1
    cm = am @ bm
    return np.stack([cm[G, 2 * Q], cm[G, 2 * Q + 1], cm[G + 8, 2 * Q], cm[G + 8, 2 * Q + 1]], axis=1)


def quad_transpose(v: np.ndarray) -> np.ndarray:
    """quad_transpose on v [32, 4, ...]: the two butterfly stages of
    __shfl_xor_sync, literally."""
    v = v.copy()
    for m in (1, 2):
        upper = (Q & m) != 0
        for s in range(4):
            if s & m:
                continue
            sel = upper.reshape((32,) + (1,) * (v.ndim - 2))
            send = np.where(sel, v[:, s], v[:, s | m])
            got = send[LANE ^ m]
            v[:, s], v[:, s | m] = np.where(sel, got, v[:, s]), np.where(sel, v[:, s | m], got)
    return v


def emulate_mma(x: np.ndarray, a: np.ndarray, bt: np.ndarray, poly: bool, sms: int, step: int = STEP):
    """tmajor_mma_kernel with mx::STEP = step on x [B, C, T] (bf16 values in
    float32), a and bt [C] as the kernel reads them: the outputs (float32,
    bf16 values) and how often each was stored."""
    step_f = NB * step
    b, c, t_len = x.shape
    nrows = b * c
    xr = x.reshape(nrows, t_len)
    out = np.full((nrows, t_len), np.nan, np.float32)
    stores = np.zeros((nrows, t_len), np.int32)
    fr = band_fragments()
    sin = poly_sin if poly else np.sin
    tiles, steps = -(-nrows // ROWS), -(-t_len // step_f)
    cpw, segs, blocks = mma_split(nrows, t_len, sms, step)
    for w in range(blocks * MX_WARPS):
        tile = w // segs
        if tile >= tiles:
            continue
        k0 = (w - tile * segs) * cpw
        n_steps = min(k0 + cpw, steps) - k0
        if n_steps <= 0:
            continue
        rows = tile * ROWS + G[:, None] + 8 * np.arange(2)  # [32, 2]: rows g, g + 8
        rc = np.minimum(rows, nrows - 1)
        al = a[rc % c]
        ib = np.float32(1.0) / (bt[rc % c] + np.float32(1e-9))

        def load_group(fg):  # [32, 2 rows, 2 halves]: frames fg + 2q, + 1, clamped
            return xr[rc[:, :, None], np.clip(fg + 2 * Q[:, None, None] + np.arange(2), 0, t_len - 1)]

        def load_step(fs):  # the step's groups
            return [load_group(fs + NB * k) for k in range(step)]

        def up_block(lo, hi):
            frag = (lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1])
            pe, po = np.empty((32, 2, 2), np.float32), np.empty((32, 2, 2), np.float32)
            for dst, b0, b1 in ((pe, fr[0], fr[1]), (po, fr[2], fr[3])):
                cf = mma(frag, b0, b1)
                for h in range(2):
                    for half in range(2):
                        y = cf[:, 2 * h + half]
                        s = sin(y * al[:, h]).astype(np.float32)
                        dst[:, h, half] = y + ib[:, h] * (s * s)
            return to_bf16(pe), to_bf16(po)

        def clamp_ends(pe, po, i0, tail):
            if i0 < 0:
                s0 = pe[QUAD | 2, :, 0]  # se[0]: n = 4, lane q = 2, low half
                low = Q < 2
                pe[low], po[low] = s0[low][:, :, None], s0[low][:, :, None]
            if i0 + NB >= t_len:  # this n-block holds sample T - 1 (nl = 7 included) or lies past it
                nl = t_len - 1 - i0
                if nl >= 0:
                    tail[:] = po[QUAD | (nl >> 1), :, nl & 1]
                for half in range(2):
                    past = 2 * Q + half > nl
                    pe[past, :, half], po[past, :, half] = tail[past], tail[past]

        def down_block(prev, cur):
            ae = (prev[0][:, 0], prev[0][:, 1], cur[0][:, 0], cur[0][:, 1])
            ao = (prev[1][:, 0], prev[1][:, 1], cur[1][:, 0], cur[1][:, 1])
            acc = to_bf16(mma(ae, fr[4], fr[5]) + mma(ao, fr[6], fr[7]))
            return acc[:, 0:2], acc[:, 2:4]  # rows g, g + 8 at n = 2q, 2q + 1

        tr = k0 * step_f
        tail = np.full((32, 2), np.nan, np.float32)
        carry = load_group(tr)
        prev = up_block(load_group(tr - 8), carry)
        clamp_ends(*prev, tr - 4, tail)
        xn = load_step(tr + 8)
        for s in range(n_steps):
            xc = xn
            if s + 1 < n_steps:
                xn = load_step(tr + 8 + step_f * (s + 1))
            ov = np.zeros((step // 2, 32, 4, 2), np.float32)
            f0 = tr + step_f * s
            edge = f0 + step_f + 4 >= t_len  # only such steps clamp (no branch in the others)
            for bb in range(step):
                cur = up_block(carry if bb == 0 else xc[bb - 1], xc[bb])
                if edge:
                    clamp_ends(*cur, f0 + 4 + NB * bb, tail)
                ov[bb >> 1][:, 2 * (bb & 1)], ov[bb >> 1][:, 2 * (bb & 1) + 1] = down_block(prev, cur)
                prev = cur
            carry = xc[step - 1]
            for p in range(step // 2):
                v = quad_transpose(ov[p]).reshape(32, NB)
                for ln in range(32):
                    row = rows[ln, Q[ln] & 1]
                    f = tr + step_f * s + NB * (2 * p + (Q[ln] >> 1))
                    if row >= nrows:
                        continue
                    keep = f + np.arange(NB) < t_len
                    out[row, f + np.arange(NB)[keep]] = v[ln, keep]
                    stores[row, f + np.arange(NB)[keep]] += 1
    return out.reshape(b, c, t_len), stores.reshape(b, c, t_len)


def _inputs(b, c, t_len, seed, beta=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c, t_len)).astype(np.float32)).to(torch.bfloat16)
    alpha = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    bt = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32)) if beta else None
    return x, alpha, bt


def _check_mma(x, alpha, beta, logscale, z, stores):
    assert (stores == 1).all() and np.isfinite(z).all()
    ref = k3.anti_alias_snake_tmajor_plain(x, alpha, beta, logscale, mxu=True)
    bound = k3.anti_alias_snake_tmajor_bound(x, alpha, beta, ref, logscale, mxu=True)
    ratio = (torch.from_numpy(z) - ref.float()).abs() / bound
    assert ratio.max().item() <= 1.0, ratio.max().item()


@pytest.mark.parametrize("step", [STEP, 4])
@pytest.mark.parametrize("t_len,sms", [(5, 132), (7, 132), (8, 132), (241, 1), (1003, 1), (1003, 132), (4, 132),
                                         (12, 132), (244, 1), (1004, 132)])
def test_mma_chain_matches_plain(t_len, sms, step):
    """B = 2, C = 9: 18 rows, so the second row tile lies mostly past the
    last row; log-scale SnakeBeta; the kernel's step of 2 n-blocks and one
    of 4. sms = 1 makes each warp walk several steps (the carried n-block,
    groups and so[T - 1]); T = 5, 7 and 1003 are
    odd (element-wise loads and stores), 241 is not a multiple of 8 and 8 is
    one n-block; at T = 4, 12, 244 and 1004 (4 mod 8) an up n-block ends at
    sample T - 1 exactly, and the next one takes so[T - 1] from it. Every output stored once, finite, within the card tests'
    bound of the tensor-core body's plain version."""
    x, alpha, beta = _inputs(2, 9, t_len, seed=t_len)
    a, bt = (torch.exp(p).numpy() for p in (alpha, beta))
    z, stores = emulate_mma(x.float().numpy(), a, bt, poly=True, sms=sms, step=step)
    _check_mma(x, alpha, beta, True, z, stores)


def test_mma_chain_snake_without_beta_and_exact_sin():
    """Snake (beta None, alpha plain) with sinf; T a multiple of 8, so the
    16-byte stores and the 4-byte loads take every step."""
    x, alpha, _ = _inputs(1, 20, 256, seed=11, beta=False)
    alpha = alpha.abs() + 0.1
    a = alpha.numpy()
    z, stores = emulate_mma(x.float().numpy(), a, a, poly=False, sms=1)
    assert (stores == 1).all() and np.isfinite(z).all()
    ref = k3.anti_alias_snake_tmajor_plain(x, alpha, None, False, mxu=True, poly_sin=False)
    bound = k3.anti_alias_snake_tmajor_bound(x, alpha, None, ref, False, mxu=True, poly_sin=False)
    assert ((torch.from_numpy(z) - ref.float()).abs() / bound).max().item() <= 1.0


def test_mma_chain_matches_jax_kernel():
    """Once against the JAX kernel's tensor-core body in interpret mode, on its
    [B, T, C] layout (C = 130: one row tile past the last row), within two
    bf16 ulps of the largest output, test_torch_tmajor.py's tolerance for the
    plain version against the same kernel."""
    import jax.numpy as jnp

    from indextts_tpu.ops.pallas.antialias_tmajor import fused_anti_alias_snake_tmajor as jax_k3

    x, alpha, beta = _inputs(1, 130, 200, seed=5)
    a, bt = (torch.exp(p).numpy() for p in (alpha, beta))
    z, stores = emulate_mma(x.float().numpy(), a, bt, poly=True, sms=132)
    assert (stores == 1).all()
    xj = jnp.asarray(x.float().transpose(1, 2).numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jax_k3(xj, jnp.asarray(alpha.numpy()), jnp.asarray(beta.numpy()), True, tile_t=128,
                            interpret=True, mxu=True).astype(jnp.float32)).transpose(0, 2, 1)
    scale = np.abs(ref).max()
    assert np.abs(z - ref).max() <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def test_quad_transpose_and_band_fragments():
    """The butterfly sends slot s of lane q to slot q of lane s, in every
    quad; the fragments hold the tap bands of the plain version's products
    (up: E @ x over a 16-frame K block, 4 frames before the n-block)."""
    v = (LANE[:, None] * 4 + np.arange(4)).astype(np.float32)
    t = quad_transpose(v)
    assert np.array_equal(t, (QUAD[:, None] + np.arange(4)) * 4 + Q[:, None])
    fr = band_fragments()
    e = np.zeros((16, 8), np.float32)
    cols = 2 * Q[:, None] + np.arange(2)
    e[cols, G[:, None]], e[cols + 8, G[:, None]] = fr[0], fr[1]
    up = to_bf16(2.0 * F)
    for n in range(8):  # ue[i0 + n] = sum_o 2 f[5 - 2o] x[i0 + n + o], frame i0 + n + o at k = n + o + 4
        want = np.zeros(16, np.float32)
        for o in range(-3, 3):
            want[n + o + 4] = up[5 - 2 * o]
        assert np.array_equal(e[:, n], want)


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("nrows,t_len", [(768, 1600), (3072, 1600), (384, 6400), (1536, 6400), (192, 12800),
                                         (768, 12800), (130, 1003), (8, 5)])
def test_mma_split_covers_every_step_once(nrows, t_len, sms):
    """The tensor-core body's grid at K3's shapes (the wide stages at B = 1
    and 4, the odd ones): each step of each row tile taken exactly once, runs
    of cpw consecutive steps, about one resident wave."""
    tiles, steps = -(-nrows // ROWS), -(-t_len // (NB * STEP))
    cpw, segs, blocks = mma_split(nrows, t_len, sms)
    taken = np.zeros((tiles, steps), np.int32)
    w = np.arange(blocks * MX_WARPS)
    tile = w // segs
    for ww, r in zip(w[tile < tiles], tile[tile < tiles]):
        k0 = (ww - r * segs) * cpw
        taken[r, k0:min(k0 + cpw, steps)] += 1
    assert (taken == 1).all()
    wave = sms * MX_WARPS * MX_MIN_BLOCKS
    assert cpw == 1 if tiles * steps <= wave else tiles * segs <= wave + tiles


def emulate_copy(x: np.ndarray, sms: int = 132):
    """aa_lanes::copy on x [B, C, T]: the stored values and how often each was
    stored."""
    b, c, t_len = x.shape
    nrows = b * c
    xr = x.reshape(nrows, t_len)
    out = np.full((nrows, t_len), np.nan, np.float32)
    stores = np.zeros((nrows, t_len), np.int32)
    cpw, segs, blocks = split(nrows, t_len, sms)
    chunks = -(-t_len // CHUNK)
    for w in range(blocks * 4):
        row = w // segs
        if row >= nrows:
            continue
        k0 = (w - row * segs) * cpw
        for j in range(k0, min(k0 + cpw, chunks)):
            for ln in range(1, 31):
                frames = j * CHUNK - LANE_F + LANE_F * ln + np.arange(LANE_F)
                frames = frames[frames < t_len]
                out[row, frames] = xr[row, np.clip(frames, 0, t_len - 1)]
                stores[row, frames] += 1
    return out.reshape(b, c, t_len), stores.reshape(b, c, t_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t_len", [(1, 130, 1000), (2, 130, 1003), (1, 8, 5)])
def test_lane_bodies_at_k3_shapes(b, c, t_len, dtype):
    """Body 0 (the lane scheme with K1's rounding points) within
    anti_alias_snake_tmajor_bound of the CUDA-core body's plain version, and
    the pass-through equal to x, each output stored once, at K3's odd card
    test shapes."""
    x, alpha, beta = _inputs(b, c, t_len, seed=c + t_len)
    x = x.to(dtype)
    a, bt = (torch.exp(p).numpy() for p in (alpha, beta))
    bf16 = dtype == torch.bfloat16
    z, stores = emulate(x.float().numpy(), a, bt, 2.0 * F, F, round_samples=False, poly=bf16)
    assert (stores == 1).all() and np.isfinite(z).all()
    out = torch.from_numpy(z).to(dtype)
    ref = k3.anti_alias_snake_tmajor_plain(x, alpha, beta, True)
    assert ((out.float() - ref.float()).abs() / k3.anti_alias_snake_tmajor_bound(x, alpha, beta, ref, True)).max() <= 1.0
    copied, stored = emulate_copy(x.float().numpy())
    assert (stored == 1).all() and torch.equal(torch.from_numpy(copied).to(dtype), x)
