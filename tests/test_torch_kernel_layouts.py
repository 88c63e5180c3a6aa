"""The index arithmetic of the K5 and K2 CUDA kernels, emulated on the CPU
against their plain versions.

The kernels themselves run only on the card (tests/test_torch_cuda_kernels.py).
What can go wrong in them without the compiler noticing is arithmetic on
indices: K5's permuted k order inside an mma step, its 64-k steps, split-K and
rank-order reduction, its int8 -> bf16 bit trick and its tails; K2's packed
weight, the activation buffer's planes and rows, the wgmma descriptors' start
addresses and strides (the tap shift), its runs of 16 frames with the two
replicate pads, and the zero rows outside the signal. Each emulation below
follows the kernel's source (csrc/int8_matmul.cu, csrc/aa_snake_dconv.cu) lane
by lane or descriptor by descriptor, and is held to the tolerance the card
tests use: k5_bound and aa_snake_dconv_bound."""

import numpy as np
import pytest
import torch

from indextts_tpu_torch.ops.antialias import activation1d, kaiser_sinc_filter1d
from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2
from indextts_tpu_torch.ops.cuda import common
from indextts_tpu_torch.ops.cuda import qmatmul as k5

# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

NB, STEP = 64, 64  # channels per block, k per warp step (csrc/int8_matmul.cu)


def k5_bound(x, wq, scale, ref):
    """chip_smoke.k5_bound: the order of the float32 sum, and the two bf16 roundings."""
    xb, w = x.to(torch.bfloat16).float(), wq.float()
    bound = 1e-5 * (xb.abs() @ w.abs().t()) * scale
    if ref.dtype == torch.bfloat16:
        ulp = lambda v: torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)
        bound = bound + ulp((xb @ w.t()) * scale) + 2 * ulp(ref.float())
    return bound


def bf16_bits_to_float(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def int8x4_to_bf16(word: int):
    """The kernel's conversion of four int8 (one 32-bit word, bytes 0..3) into
    two bf16 pairs, on the bits. Returns the four values as floats."""
    u = np.uint32(word) ^ np.uint32(0x80808080)
    out = []
    for sel in ((0, 1), (2, 3)):
        t = ((u >> np.uint32(8 * sel[0])) & np.uint32(0xFF)) | (((u >> np.uint32(8 * sel[1])) & np.uint32(0xFF)) << np.uint32(16))
        w = (t & np.uint32(0x007F007F)) | np.uint32(0x43004300)
        c = (t & np.uint32(0x00800080)) ^ np.uint32(0x43804380)
        for half in (0, 16):
            wf = bf16_bits_to_float(np.array([(w >> np.uint32(half)) & np.uint32(0xFFFF)]))[0]
            cf = bf16_bits_to_float(np.array([(c >> np.uint32(half)) & np.uint32(0xFFFF)]))[0]
            out.append(float(wf - cf))
    return out


def test_k5_int8_to_bf16_bit_trick_is_exact():
    for v in range(-128, 128):
        word = sum(((v + j) % 256 if v + j < 128 else (v + j - 256) % 256) << (8 * j) for j in range(4))
        want = [((v + j + 128) % 256) - 128 for j in range(4)]
        assert int8x4_to_bf16(word) == [float(w) for w in want]


def emulate_k5(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias, split: int) -> torch.Tensor:
    """int8_matmul_kernel, lane by lane: blocks of 64 channels x a slice of K
    (`split` slices), warps of 16 channels, steps of 64 k in which lane (g, q)
    holds bytes 16q .. 16q+15 of rows g and g+8; word s of those bytes is mma
    step s with the permuted k order; two accumulator sets by the parity of s;
    partial tiles summed over the slices in rank order; then the epilogue."""
    m_rows, k_dim = x.shape
    n_dim = wq.shape[0]
    xs = x.to(torch.bfloat16).float().numpy()
    w = wq.numpy().astype(np.float32)
    steps = -(-k_dim // STEP)
    kb = -(-steps // split) * STEP
    out = torch.empty(m_rows, n_dim, dtype=x.dtype)
    sc = scale.float().numpy()
    for m0 in range(0, m_rows, 16):
        mt = 8 if m_rows <= 8 else 16
        for n0 in range(0, n_dim, NB):
            parts = np.zeros((split, NB, mt), np.float32)
            for sp in range(split):
                k0 = sp * kb
                kend = min(k_dim, k0 + kb)
                nsteps = max(0, -(-(kend - k0) // STEP))
                for warp in range(4):
                    acc = np.zeros((2, 16, mt), np.float32)  # [set][channel][row of x]
                    for st in range(nsteps):
                        for s in range(4):
                            a = np.zeros((16, 16), np.float32)   # the mma's A: channel x logical k
                            b = np.zeros((16, mt), np.float32)   # the mma's B: logical k x row of x
                            for g in range(8):
                                for q in range(4):
                                    kbase = k0 + st * STEP + 16 * q + 4 * s  # the lane's word s
                                    for j, col in ((0, 2 * q), (1, 2 * q + 1), (2, 2 * q + 8), (3, 2 * q + 9)):
                                        kk = kbase + j
                                        for half in (0, 8):
                                            n = n0 + warp * 16 + g + half
                                            if n < n_dim and kk < k_dim:
                                                a[g + half, col] = w[n, kk]
                                        for tile in range(mt // 8):
                                            m = m0 + 8 * tile + g
                                            if m < m_rows and kk < k_dim:
                                                b[col, 8 * tile + g] = xs[m, kk]
                            acc[s & 1] += a @ b
                    parts[sp, warp * 16:(warp + 1) * 16] = acc[0] + acc[1]
            total = np.zeros((NB, mt), np.float32)
            for sp in range(split):  # rank order
                total = total + parts[sp]
            for c in range(min(NB, n_dim - n0)):
                for m in range(min(mt, m_rows - m0)):
                    y = torch.tensor(total[c, m] * sc[n0 + c], dtype=torch.float32).to(x.dtype)
                    o = y if bias is None else y + bias[n0 + c].to(x.dtype)
                    out[m0 + m, n0 + c] = o
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,split", [(3, 48, 70, 1), (4, 50, 70, 1), (1, 130, 70, 2), (15, 200, 20, 2), (17, 64, 66, 1),
                                          (4, 300, 40, 4)])
def test_k5_emulation_matches_plain(dtype, m, k, n, split):
    """Tails like the mel head's (N = 8194: not a multiple of 16 or 64), K of no
    whole step and not a multiple of 16, M of one and two x tiles and more
    than 16, split-K with an empty last slice (k = 130: 3 steps over 2)."""
    rng = np.random.default_rng(m * 1000 + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    scale = torch.from_numpy((rng.random(n) * 1e-3 + 1e-4).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32)).to(dtype)
    ref = k5.int8_matmul_plain(x, wq, scale, bias)
    out = emulate_k5(x, wq, scale, bias, split)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= k5_bound(x, wq, scale, ref)).all()), err.max().item()
    # the reduction's order is fixed: a second pass gives the same bits
    assert torch.equal(out, emulate_k5(x, wq, scale, bias, split))


def test_k5_split_changes_only_the_order_of_the_sum():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (24, 256)).astype(np.int8))
    scale = torch.from_numpy((rng.random(24) * 1e-3 + 1e-4).astype(np.float32))
    ref = k5.int8_matmul_plain(x, wq, scale, None)
    for split in (1, 2, 4):
        out = emulate_k5(x, wq, scale, None, split)
        assert bool(((out - ref).abs() <= k5_bound(x, wq, scale, ref)).all())


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

WT, CK, RUN = 64, 64, 16  # packed tile, channels per chunk, frames per producer run (csrc/aa_snake_dconv.cu)


def emulate_activation_run(xrow: np.ndarray, t: int, a: float, inv_b: float, taps: np.ndarray) -> np.ndarray:
    """activation_run: 16 output frames t .. t+15 of one channel from the 32
    frames around them, the 42 samples u (2x-rate index 2t - 5 + u) with the
    pad below the signal (t = 0: u < 5 take u = 5) and above it (u > u_hi take
    u_hi), exact sin. float64 throughout: the arithmetic's order is the
    card's business, the indices are this test's."""
    t_len = xrow.shape[0]
    xr = np.array([xrow[min(max(t - 8 + i, 0), t_len - 1)] for i in range(32)], np.float64)
    f = taps.astype(np.float64)
    v = np.zeros(2 * RUN + 10)
    for u in range(2 * RUN + 10):
        if u & 1:
            n = (u + 11) // 2
            y = f[1] * xr[n + 2] + f[3] * xr[n + 1] + f[5] * xr[n] + f[7] * xr[n - 1] + f[9] * xr[n - 2] + f[11] * xr[n - 3]
        else:
            n = (u + 10) // 2
            y = f[0] * xr[n + 3] + f[2] * xr[n + 2] + f[4] * xr[n + 1] + f[6] * xr[n] + f[8] * xr[n - 1] + f[10] * xr[n - 2]
        y *= 2.0
        v[u] = y + inv_b * np.sin(y * a) ** 2
    if t == 0:
        v[:5] = v[5]
    u_hi = 2 * (t_len - t) + 4
    if u_hi < 2 * RUN + 9:
        v[u_hi + 1:] = v[u_hi]
    z = np.zeros(RUN)
    for u in range(2 * RUN + 10):
        for q in range(RUN):
            j = u - 2 * q
            if 0 <= j < 12:
                z[q] += f[j] * v[u]
    return z


@pytest.mark.parametrize("t_len", [1, 5, 9, 16, 30, 47, 64])
def test_k2_activation_runs_match_the_composed_path(t_len):
    """Runs of 16 frames from t = 0 to past T, both pads inside one run for
    short T: equal to activation1d (exact sin) at every frame of the signal."""
    rng = np.random.default_rng(t_len)
    x = torch.from_numpy(rng.standard_normal((1, 3, t_len)).astype(np.float32))
    alpha = torch.from_numpy((0.3 * rng.standard_normal(3)).astype(np.float32))
    beta = torch.from_numpy((0.3 * rng.standard_normal(3)).astype(np.float32))
    want = activation1d(x, alpha, beta, True, approx_sin_=False)[0].numpy()
    taps = np.asarray(kaiser_sinc_filter1d(0.25, 0.3, 12)).reshape(-1)
    a, b = np.exp(alpha.numpy().astype(np.float64)), np.exp(beta.numpy().astype(np.float64))
    for c in range(3):
        got = np.concatenate([emulate_activation_run(x[0, c].numpy(), t, a[c], 1.0 / (b[c] + 1e-9), taps)
                              for t in range(0, t_len, RUN)])[:t_len]
        np.testing.assert_allclose(got, want[c], atol=2e-5, rtol=0)


def emulate_k2(x, alpha, beta, weight, bias, dil, tn, logscale=True):
    """aa_snake_dconv_wgmma_kernel's data movement for bf16: the packed weight
    as a flat buffer read through the A descriptors, the activation buffer (8
    planes of KGS rows of 16 bytes per 64-channel chunk, row 0 at frame t0 -
    h16, zeros outside the signal and past C) read through the B descriptors,
    whose start moves by j * dil rows for tap j. Offsets are in bf16 elements
    (2 bytes). The activation itself is the plain version's, rounded; the
    sums are float32."""
    bsz, c_dim, t_len = x.shape
    k = weight.shape[-1]
    h = (k - 1) * dil // 2
    h16 = -(-h // RUN) * RUN
    text, kgs = tn + 2 * h16, tn + 2 * h16 + 1
    ntiles = -(-c_dim // WT)
    wp = k2.pack_weight(weight).reshape(-1).float().numpy()
    act_all = k2.anti_alias_snake_plain(x, alpha, beta, logscale).float().numpy()  # rounded to x's dtype
    out = torch.zeros_like(x)
    bias_f = bias.float().numpy()
    rowoff = h16 - h
    n_idx, kk_idx = np.meshgrid(np.arange(tn), np.arange(16), indexing="ij")
    m_idx, ka_idx = np.meshgrid(np.arange(WT), np.arange(16), indexing="ij")
    for b in range(bsz):
        for t0 in range(0, t_len, tn):
            tb = t0 - h16
            acc = np.zeros((ntiles, WT, tn), np.float32)
            for c in range(ntiles):  # chunks of 64 input channels
                buf = np.zeros(8 * kgs * 8, np.float32)  # the activation buffer, in elements
                for r in range(text // RUN):       # the producers' runs
                    t = tb + RUN * r
                    for cil in range(CK):
                        ci = c * CK + cil
                        for q in range(RUN):
                            live = ci < c_dim and 0 <= t and t + q < t_len
                            buf[((cil >> 3) * kgs + RUN * r + q) * 8 + (cil & 7)] = act_all[b, ci, t + q] if live else 0.0
                for ct in range(ntiles):  # every consumer warpgroup's output tile
                    for j in range(k):
                        tile = ((j * ntiles + ct) * ntiles + c) * WT * WT  # the bulk copy's source
                        for ks in range(CK // 16):
                            # A: start + ks * 2 planes; LBO = 64 rows * 8 elements, SBO = 8 rows * 8 elements
                            a_off = tile + ks * 2 * WT * 8 + (m_idx // 8) * 64 + (m_idx % 8) * 8 + (ka_idx // 8) * (WT * 8) + ka_idx % 8
                            # B: start = (2 ks planes + rowoff + j * dil rows) * 8 elements; LBO = KGS rows, SBO = 8 rows
                            b_start = (ks * 2 * kgs + rowoff + j * dil) * 8
                            b_off = b_start + (n_idx // 8) * 64 + (n_idx % 8) * 8 + (kk_idx // 8) * (kgs * 8) + kk_idx % 8
                            acc[ct] += wp[a_off] @ buf[b_off].T
            for ct in range(ntiles):
                for row in range(WT):
                    co = ct * WT + row
                    if co < c_dim:
                        n_valid = min(tn, t_len - t0)
                        out[b, co, t0:t0 + n_valid] = torch.from_numpy(acc[ct, row, :n_valid] + bias_f[co]).to(x.dtype)
    return out


K2_KD = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]


@pytest.mark.parametrize("t_len,tn", [(1, 64), (9, 64), (30, 64), (150, 128)])
@pytest.mark.parametrize("k,d", K2_KD)
def test_k2_emulation_matches_plain(k, d, t_len, tn):
    """C = 128 (two packed tiles, one idle consumer warpgroup), all nine (k,
    d), T shorter than a run, than the halo and than a tile, and T of two
    128-frame tiles, in bf16 within aa_snake_dconv_bound."""
    rng = np.random.default_rng(100 * k + 10 * d + t_len)
    c = 128
    x = torch.from_numpy((0.5 * rng.standard_normal((1, c, t_len))).astype(np.float32)).to(torch.bfloat16)
    alpha = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    beta = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, c, k)) / np.sqrt(c * k)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(torch.bfloat16)
    ref = k2.aa_snake_dconv_plain(x, alpha, beta, w, bias, d, True)
    out = emulate_k2(x, alpha, beta, w, bias, d, tn)
    bound = k2.aa_snake_dconv_bound(x, alpha, beta, w, d, ref, alpha_logscale=True)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= bound).all()), (err / bound).max().item()


def test_k2_emulation_odd_channels_and_batch():
    """C = 70 (no multiple of 8 or of the tile: zero rows of the packed weight
    and of the activation), B = 2, k = 7, d = 3."""
    rng = np.random.default_rng(3)
    c, t_len, k, d = 70, 40, 7, 3
    x = torch.from_numpy((0.5 * rng.standard_normal((2, c, t_len))).astype(np.float32)).to(torch.bfloat16)
    alpha = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, c, k)) / np.sqrt(c * k)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(torch.bfloat16)
    ref = k2.aa_snake_dconv_plain(x, alpha.abs() + 0.1, None, w, bias, d, False)
    out = emulate_k2(x, alpha.abs() + 0.1, None, w, bias, d, 64, logscale=False)
    bound = k2.aa_snake_dconv_bound(x, alpha.abs() + 0.1, None, w, d, ref, alpha_logscale=False)
    assert bool(((out.float() - ref.float()).abs() <= bound).all())


def test_k2_pack_weight_layout():
    """Element (tap j, out co, in ci) of the packed weight sits where the
    float32 kernel's packed_index and the bulk copies expect it."""
    w = torch.arange(130 * 130 * 3, dtype=torch.float32).reshape(130, 130, 3)
    p = k2.pack_weight(w)
    assert p.shape == (3, 3, 3, 8, 64, 8) and p.is_contiguous()
    flat, nt = p.reshape(-1), 3
    rng = np.random.default_rng(0)
    for j, co, ci in zip(rng.integers(0, 3, 200), rng.integers(0, 192, 200), rng.integers(0, 192, 200)):
        idx = ((j * nt + (co >> 6)) * nt + (ci >> 6)) * 4096 + ((ci & 63) >> 3) * 512 + (co & 63) * 8 + (ci & 7)
        want = w[co, ci, j].item() if co < 130 and ci < 130 else 0.0
        assert flat[idx].item() == want


def test_k2_packed_weight_cache():
    """One packed copy per weight: the same tensor for an unchanged weight, a
    fresh one after an in-place update, after new storage, after a dtype
    change and for another tensor; the entry goes with the weight."""
    w = torch.nn.Parameter(torch.randn(128, 128, 3), requires_grad=False)
    first = k2.packed_weight(w)
    assert k2.packed_weight(w) is first and torch.equal(first, k2.pack_weight(w))
    with torch.no_grad():
        w.copy_(torch.randn(128, 128, 3))  # load_state_dict, the weight bridge
    second = k2.packed_weight(w)
    assert second is not first and torch.equal(second, k2.pack_weight(w)) and k2.packed_weight(w) is second
    with torch.no_grad():
        w.mul_(2.0)
    third = k2.packed_weight(w)
    assert third is not second and torch.equal(third, k2.pack_weight(w))
    w.data = torch.randn(128, 128, 3)  # new storage behind the same Parameter
    fourth = k2.packed_weight(w)
    assert fourth is not third and torch.equal(fourth, k2.pack_weight(w))
    w.data = w.data.to(torch.bfloat16)  # module.to(dtype)
    fifth = k2.packed_weight(w)
    assert fifth.dtype == torch.bfloat16 and torch.equal(fifth, k2.pack_weight(w))
    # the snake parameters as the kernel reads them go through the same cache
    alpha = torch.nn.Parameter(torch.randn(128), requires_grad=False)
    ea = common._snake_parameter(alpha, True)
    assert common._snake_parameter(alpha, True) is ea and torch.equal(ea, torch.exp(alpha))
    assert torch.equal(common._snake_parameter(alpha, False), alpha.detach())
    with torch.no_grad():
        alpha.add_(1.0)
    assert torch.equal(common._snake_parameter(alpha, True), torch.exp(alpha))
    other = torch.randn(128, 128, 3)
    assert k2.packed_weight(other) is not fifth
    key = (id(w), "packed")
    assert key in common._derived
    del w
    assert key not in common._derived


@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("tn,h16", [(64, 16), (64, 32), (128, 16), (128, 32), (128, 0)])
def test_k2_cluster_units_cover_a_chunk_once(cs, tn, h16):
    """The producers' work split: a unit is 32 channels of one run of 16
    frames; unit u belongs to block u mod CS of the cluster and goes round
    that block's 8 producer warps. Every (channel, row) of a chunk's buffer
    is written by exactly one warp of one block."""
    text = tn + 2 * h16
    units = 2 * (text // RUN)
    written = np.zeros((CK, text), np.int32)
    for rank in range(cs):
        for pwarp in range(8):
            for u in range(rank + cs * pwarp, units, cs * 8):
                for lane in range(32):
                    cil, r = (u & 1) * 32 + lane, u >> 1
                    written[cil, RUN * r:RUN * (r + 1)] += 1
    assert (written == 1).all()
