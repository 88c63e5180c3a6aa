"""The lane scheme K1 and K4 share (csrc/aa_lanes.cuh), emulated in numpy on
the CPU against their plain versions; and the wrappers' derived parameters.

The kernels run only on the card (tests/test_torch_cuda_kernels.py). What
can go wrong in them without the compiler noticing is arithmetic on indices:
which frames a lane holds, where each shuffle reads from, which lanes store,
how a row is cut into chunks and the chunks into warps, and the two clamps at
a row's ends. The emulation below follows aa_lanes.cuh step by step (chunk,
run, split), for every lane of every chunk at once, in float32. What the
outermost lanes read around the warp (lane 0 from lane 31 and back) is set
to NaN here, so an output that depended on it would not be finite. Each case
runs with K1's rounding points (float32 taps, samples not rounded) and K4's
(taps and samples rounded to x's dtype), held to the tolerances the card
tests use."""

import numpy as np
import pytest
import torch

from indextts_tpu_torch.ops.antialias import kaiser_sinc_filter1d
from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2
from indextts_tpu_torch.ops.cuda import antialias as k1
from indextts_tpu_torch.ops.cuda import antialias_folded as k4
from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3
from indextts_tpu_torch.ops.cuda import common

LANE_F, WINDOW = 8, 256  # aa_lanes.cuh
CHUNK = WINDOW - 2 * LANE_F
WARPS, MIN_BLOCKS = 4, 8
RESIDENT_WARPS = WARPS * MIN_BLOCKS
F = kaiser_sinc_filter1d(0.25, 0.3, 12).astype(np.float32)


def poly_sin(u: np.ndarray) -> np.ndarray:
    """approx_sin.cuh in float32."""
    f = np.float32
    k = np.rint(u * f(0.15915494309189535))
    r = u - k * f(6.283185307179586)
    r2 = r * r
    p = f(9.9999728997e-01) + r2 * (f(-1.6665146137e-01) + r2 * (f(8.3198438631e-03) + r2 * (
        f(-1.9424185428e-04) + r2 * f(2.2248903691e-06))))
    return r * p


def to_bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16).float().numpy()


def split(nrows: int, t_len: int, sms: int):
    """aa_lanes::split: (chunks per warp, warps per row, blocks)."""
    chunks = -(-t_len // CHUNK)
    total = nrows * chunks
    wave = max(sms, 1) * RESIDENT_WARPS
    cpw = min(chunks, max(1, -(-total // wave)))
    waves = -(-(nrows * -(-chunks // cpw)) // wave)
    fit = wave // max(nrows, 1)
    if waves > 1 and fit >= 1 and -(-chunks // fit) < waves * cpw:
        cpw = -(-chunks // fit)
    segs = -(-chunks // cpw)
    return cpw, segs, -(-(nrows * segs) // WARPS)


def emulate(x: np.ndarray, a: np.ndarray, bt: np.ndarray, up: np.ndarray, dn: np.ndarray, round_samples: bool,
            poly: bool, sms: int = 132) -> np.ndarray:
    """aa_lanes::run on x [B, C, T] (float32 values), a and bt [C] as the
    kernel reads them: the float32 outputs, and how often each was stored."""
    b, c, t_len = x.shape
    nrows = b * c
    xr = x.reshape(nrows, t_len)
    out = np.full((nrows, t_len), np.nan, np.float32)
    stores = np.zeros((nrows, t_len), np.int32)
    cpw, segs, blocks = split(nrows, t_len, sms)
    chunks = -(-t_len // CHUNK)
    lane = np.arange(32)
    prev, nxt = (lane + 31) & 31, (lane + 1) & 31
    sin = poly_sin if poly else np.sin
    for w in range(blocks * WARPS):  # the warps of the grid; those past the last row return
        row = w // segs
        if row >= nrows:
            continue
        k0 = (w - row * segs) * cpw
        k1_ = min(k0 + cpw, chunks)
        ch = row % c
        inv_b = np.float32(1.0) / (bt[ch] + np.float32(1e-9))
        for j in range(k0, k1_):
            c0 = j * CHUNK
            f0 = c0 - LANE_F + LANE_F * lane  # [32] each lane's first frame
            xc = xr[row, np.clip(f0[:, None] + np.arange(LANE_F), 0, t_len - 1)]  # load8, clamped
            xw = np.concatenate([xc[prev, LANE_F - 3:], xc, xc[nxt, :3]], axis=1)  # frames f0-3 .. f0+10
            xw[0, :3] = np.nan  # lane 0 reads lane 31 around the warp
            xw[31, LANE_F + 3:] = np.nan  # lane 31 reads lane 0
            act = np.empty((32, 2 * LANE_F), np.float32)
            for q in range(LANE_F):
                ye = (up[1] * xw[:, q + 5] + up[3] * xw[:, q + 4] + up[5] * xw[:, q + 3] + up[7] * xw[:, q + 2]
                      + up[9] * xw[:, q + 1] + up[11] * xw[:, q])
                yo = (up[0] * xw[:, q + 6] + up[2] * xw[:, q + 5] + up[4] * xw[:, q + 4] + up[6] * xw[:, q + 3]
                      + up[8] * xw[:, q + 2] + up[10] * xw[:, q + 1])
                for e, y in ((2 * q, ye), (2 * q + 1, yo)):
                    s = sin(y * a[ch]).astype(np.float32)
                    act[:, e] = y + inv_b * (s * s)
            if round_samples:
                act = to_bf16(act)
            if c0 == 0:  # lane 0's samples are m < 0: a[0], lane 1's first
                act[0, :] = act[1, 0]
            if c0 + WINDOW - LANE_F > t_len:  # samples past 2T - 1: a[2T - 1] from the lane of frame T - 1
                rel = t_len - 1 - (c0 - LANE_F)
                last = act[rel >> 3, 2 * (rel & (LANE_F - 1)) + 1]
                m = 2 * f0[:, None] + np.arange(2 * LANE_F)
                act = np.where(m > 2 * t_len - 1, last, act)
            wv = np.concatenate([act[prev, 2 * LANE_F - 5:], act, act[nxt, :5]], axis=1)  # samples 2f0-5 .. 2f0+20
            wv[0, :5] = np.nan
            wv[31, 2 * LANE_F + 5:] = np.nan
            z = np.zeros((32, LANE_F), np.float32)
            for q in range(LANE_F):
                for jj in range(12):
                    z[:, q] += dn[jj] * wv[:, 2 * q + jj]
            for ln in range(1, 31):  # lanes 0 and 31 hold the halo and store nothing
                frames = f0[ln] + np.arange(LANE_F)
                keep = frames < t_len
                out[row, frames[keep]] = z[ln, keep]
                stores[row, frames[keep]] += 1
    return out.reshape(b, c, t_len), stores


def bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7) if v > 0 else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["k1", "k4"])
@pytest.mark.parametrize("t_len", [1, 5, 11, 255, 256, 257, 1003, 1600])
def test_lane_scheme_matches_plain(t_len, kernel, dtype):
    """B = 4, C = 3 (no multiple of anything), log-scale SnakeBeta; every
    output stored exactly once, finite (no halo value from around the warp),
    and within the card tests' tolerance of the plain version."""
    rng = np.random.default_rng(t_len)
    x = torch.from_numpy(rng.standard_normal((4, 3, t_len)).astype(np.float32)).to(dtype)
    alpha = torch.from_numpy((0.3 * rng.standard_normal(3)).astype(np.float32))
    beta = torch.from_numpy((0.3 * rng.standard_normal(3)).astype(np.float32))
    a, bt = (torch.exp(p).numpy() for p in (alpha, beta))
    bf16 = dtype == torch.bfloat16
    if kernel == "k1":
        up, dn = 2.0 * F, F
    else:
        up, dn = (np.asarray(list(taps), np.float32) for taps in k4._taps(dtype))
    z, stores = emulate(x.float().numpy(), a, bt, up, dn, round_samples=kernel == "k4" and bf16, poly=bf16)
    assert (stores == 1).all() and np.isfinite(z).all()
    out = torch.from_numpy(z).to(dtype)
    if kernel == "k1":
        ref = k1.anti_alias_snake_plain(x, alpha, beta, True).float()
        scale = ref.abs().max().item()
        bound = 1e-5 * scale if not bf16 else 2 * bf16_ulp(scale)
        assert (out.float() - ref).abs().max().item() <= bound
    else:
        ref = k4.fused_folded_aa_plain(x, alpha, beta, True)
        ratio = (out.float() - ref.float()).abs() / k4.fused_folded_aa_bound(x, alpha, beta, ref, True)
        assert ratio.max().item() <= 1.0


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("nrows,t_len", [(768, 1600), (384, 6400), (96, 25600), (24, 102400), (96, 102400),
                                         (3072, 1600), (1536, 6400), (768, 12800), (12, 1), (3, 1003), (130, 517)])
def test_split_covers_every_chunk_once(nrows, t_len, sms):
    """aa_lanes::split: the grid's warps take each chunk of each row exactly
    once, runs of cpw consecutive chunks; about one resident wave, and no
    more than one chunk a warp while a wave holds them all. A split past one
    wave takes no more chunk rounds than the least run that fits one wave
    (B = 4 at stages 1-3 on 132 SMs: one wave of runs of 7, 14, 11)."""
    cpw, segs, blocks = split(nrows, t_len, sms)
    chunks = -(-t_len // CHUNK)
    taken = np.zeros((nrows, chunks), np.int32)
    w = np.arange(blocks * WARPS)
    row = w // segs
    for ww, r in zip(w[row < nrows], row[row < nrows]):
        k0 = (ww - r * segs) * cpw
        taken[r, k0:min(k0 + cpw, chunks)] += 1
    assert (taken == 1).all()
    wave = sms * RESIDENT_WARPS
    if nrows * chunks <= wave:
        assert cpw == 1
    else:
        assert nrows * segs <= wave + nrows  # each row's last run may be short
    waves = -(-(nrows * segs) // wave)
    if waves > 1 and wave >= nrows:
        assert waves * cpw <= -(-chunks // (wave // nrows))
    expect = {(3072, 1600): 7, (1536, 6400): 14, (768, 12800): 11}
    if sms == 132 and (nrows, t_len) in expect:
        assert cpw == expect[(nrows, t_len)] and nrows * segs <= wave


def test_window_frames_and_shuffle_sources():
    """Lane l of the chunk at c0 holds frames c0 - 8 + 8 l .. + 7; lanes 1-30
    store c0 .. c0 + 239. A storing lane's outputs need samples 2 f0 - 5 ..
    2 f0 + 20, which it and its two neighbours hold; each of those samples
    needs frames that its own lane and that lane's neighbours hold, on the
    same side of the warp (lane 0 never needs lane 31's, nor 31 lane 0's)."""
    c0 = 3 * CHUNK
    f0 = c0 - LANE_F + LANE_F * np.arange(32)
    stored = np.concatenate([f0[ln] + np.arange(LANE_F) for ln in range(1, 31)])
    assert np.array_equal(stored, np.arange(c0, c0 + CHUNK))
    owner = lambda frame: (frame - (c0 - LANE_F)) // LANE_F
    for ln in range(1, 31):
        for m in range(2 * f0[ln] - 5, 2 * f0[ln] + 21):
            o = owner(m // 2)
            assert ln - 1 <= o <= ln + 1
            i = m // 2
            frames = range(i - 3, i + 3) if m % 2 == 0 else range(i - 2, i + 4)
            assert all(max(o - 1, 0) <= owner(fr) <= min(o + 1, 31) for fr in frames), (ln, m)


def test_snake_parameters_are_derived_once_per_parameter():
    """The wrappers' alpha and beta: the same tensor on a second call, made
    again after copy_, after load_state_dict and for another tensor; Snake
    (beta None) reads alpha twice."""
    m = torch.nn.Module()
    m.alpha = torch.nn.Parameter(torch.randn(16), requires_grad=False)
    m.beta = torch.nn.Parameter(torch.randn(16), requires_grad=False)
    a, b = common.snake_parameters(m.alpha, m.beta, True)
    a2, b2 = common.snake_parameters(m.alpha, m.beta, True)
    assert a2 is a and b2 is b and torch.equal(a, torch.exp(m.alpha)) and torch.equal(b, torch.exp(m.beta))
    with torch.no_grad():
        m.alpha.copy_(torch.randn(16))
    a3, b3 = common.snake_parameters(m.alpha, m.beta, True)
    assert a3 is not a and torch.equal(a3, torch.exp(m.alpha)) and b3 is b
    m.load_state_dict({"alpha": torch.randn(16), "beta": torch.randn(16)})
    a4, b4 = common.snake_parameters(m.alpha, m.beta, True)
    assert a4 is not a3 and b4 is not b and torch.equal(a4, torch.exp(m.alpha)) and torch.equal(b4, torch.exp(m.beta))
    plain_a, same = common.snake_parameters(m.alpha, None, False)
    assert same is plain_a and torch.equal(plain_a, m.alpha.detach())
    other = torch.randn(16)
    assert torch.equal(common.snake_parameters(other, None, True)[0], torch.exp(other))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_taps_are_rounded_once_per_dtype(dtype):
    """K4's taps: 2 f up and f down rounded to x's dtype, the values its
    wrapper built on every call before; now one pair of arrays per dtype."""
    up, dn = k4._taps(dtype)
    assert k4._taps(dtype) == (up, dn) and k4._taps(dtype)[0] is up
    f = torch.as_tensor(kaiser_sinc_filter1d(0.25, 0.3, 12))
    assert list(up) == (2.0 * f).to(dtype).float().tolist()
    assert list(dn) == f.to(dtype).float().tolist()
    if dtype == torch.bfloat16:
        assert list(dn) != f.float().tolist()


def test_wrappers_share_one_derivation():
    """K1-K4's wrappers all read alpha and beta through common.snake_parameters
    (an exp per parameter, not per call); the plain versions keep their own."""
    for mod in (k1, k2, k3, k4):
        assert mod.snake_parameters is common.snake_parameters
