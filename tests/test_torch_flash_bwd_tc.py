"""The arithmetic and the operand layouts of the flash backward kernels
(``csrc/flash_mha_bwd.cu``), emulated on the CPU.

The kernels multiply float32 on the TF32 tensor cores at float32 accuracy,
as the forward does (``tests/test_torch_flash_tc.py``): each operand x is
split into hi = rna(x) and lo = rna(x - hi) by bit masks, and a product
becomes lo·hi + hi·lo + hi·hi (three TF32 products) or also lo·lo (four).
``emulate`` mirrors the kernels: S and dP (four products each) over the
head dim in fresh chains of 32 columns summed in software; the dQ kernel
over 32-key tiles, skipping tiles whose keys are all padded; the dK/dV
kernel over blocks of 64 keys, writing zeros for a block whose keys are
all padded, and over every 32-query tile, where dS takes P as its staged
hi + lo; each tile's dq, dk, dv product (three) in a fresh accumulator
added to the running sum. It is held
against float64 ``flash_mha_bwd_plain`` at 1e-4·max|ref| (the card's bound)
and at least as close to float64 as float32 plain is, and against
``jax.grad`` of the JAX package's TPU kernel in Pallas interpret mode at
the valid rows. Fewer products miss the bound, which is what each product
the kernels spend is for.

The layout tests pin the index arithmetic the kernels do per thread: the A
fragments read from swizzled tiles (row-wise for S and dP, column-wise for
the transposed third products), the accumulators written to the staged B
tiles, and the transposed store of dq, dk, dv.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from expressive_fastspeech2_mandarin_tpu.ops.pallas.flash_mha import (
    flash_mha as jax_flash_mha,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fm

torch.set_num_threads(2)
SCALE = 128 ** -0.5
# csrc/flash_mha_bwd.cu: kTile (flash_mha_bwd_stream_tile()), kRows
# (flash_mha_bwd_block_rows()), kChain k-steps of 8 columns per S/dP chain.
TILE, ROWS, CHAIN_COLS = 32, 64, 32
REL_BOUND = 1e-4   # chip_smoke.py: FLASH_BWD_REL_BOUND
KERNEL = {"s": 4, "dp": 4, "third": 3}

# Valid keys of each batch row as [start, stop) spans, per T.
MASKS = {
    # A full row, a row with one valid key, a row with none, a ragged one.
    "lengths": {40: ([(0, 40)], [(0, 1)], [], [(0, 29)]),
                300: ([(0, 300)], [(0, 1)], [], [(0, 211)])},
    # Not a prefix: at T = 300 row 0 leaves four 32-key tiles wholly padded
    # (at the start and in the middle) and the 64-key block [192, 256).
    "holes": {40: ([(5, 6), (11, 16)], [(0, 40)], [(39, 40)], []),
              300: ([(40, 70), (130, 192), (256, 300)], [(0, 300)],
                    [(299, 300)], [(64, 128)])},
}


def tf32(x):
    """float32 rounded to TF32, to nearest with ties away from zero, by bit
    masks (csrc/tf32_wgmma.cuh: tf32_rna)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, n):
    """a @ b from TF32 parts, the small products first, then hi·hi: n = 4
    lo·lo + lo·hi + hi·lo, n = 3 lo·hi + hi·lo, n = 2 lo·hi alone, n = 1
    none."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    small = None
    if n == 4:
        small = a_lo @ b_lo
    if n >= 2:
        small = a_lo @ b_hi if small is None else small + a_lo @ b_hi
    if n >= 3:
        small = small + a_hi @ b_lo
    big = a_hi @ b_hi
    return big if small is None else small + big


def rows_product(a, b, n):
    """a @ bᵀ over the head dim as the kernels sum S and dP: fresh chains
    of 32 columns, each its small products plus its hi·hi, then added."""
    out = None
    for c0 in range(0, a.shape[-1], CHAIN_COLS):
        part = product(a[..., c0:c0 + CHAIN_COLS],
                       b[..., c0:c0 + CHAIN_COLS].swapaxes(-1, -2), n)
        out = part if out is None else out + part
    return out


def _rows(x, r0, n, fill=0.0):
    """Rows [r0, r0 + n) of x's axis -2 (heads first), ``fill`` past T."""
    t = x.shape[-2]
    out = np.full(x.shape[:-2] + (n,) + x.shape[-1:], fill, np.float32)
    out[..., :max(0, min(n, t - r0)), :] = x[..., r0:r0 + n, :]
    return out


def emulate(q, k, v, mask, out, dout, lse, scale, products=KERNEL):
    """The kernels' float32 arithmetic on (B, H, T, D) numpy arrays, a
    (B, T) bool mask (True at padding), the forward's out and lse. Returns
    (dq, dk, dv, key_tiles, key_blocks): the key tiles the dQ kernel
    computes and the key blocks the dK/dV kernel computes, per batch row."""
    n_s, n_dp, n_3 = products["s"], products["dp"], products["third"]
    b_, h_, t_, d_ = q.shape
    scale = np.float32(scale)
    delta = (dout * out).sum(-1, dtype=np.float32)
    dq, dk, dv = (np.zeros(q.shape, np.float32) for _ in range(3))
    key_tiles, key_blocks = [], []
    for b in range(b_):
        valid = ~mask[b]
        # dQ kernel: the live 32-key tiles.
        acc, n = np.zeros((h_, t_, d_), np.float32), 0
        for k0 in range(0, t_, TILE):
            kv = np.zeros(TILE, bool)
            kv[:min(TILE, t_ - k0)] = valid[k0:k0 + TILE]
            if not kv.any():
                continue
            n += 1
            kt, vt = _rows(k[b], k0, TILE), _rows(v[b], k0, TILE)
            s = rows_product(q[b], kt, n_s)
            dp = rows_product(dout[b], vt, n_dp)
            p = np.where(kv, np.exp(s * scale - lse[b][..., None]),
                         np.float32(0))
            ds = p * (dp - delta[b][..., None])
            acc = acc + product(ds, kt, n_3)
        dq[b] = acc * scale
        key_tiles.append(n)
        # dK/dV kernel: blocks of 64 keys, every 32-query tile.
        n = 0
        for k0 in range(0, t_, ROWS):
            kv = np.zeros(ROWS, bool)
            kv[:min(ROWS, t_ - k0)] = valid[k0:k0 + ROWS]
            if not kv.any():
                continue  # dk and dv stay 0
            n += 1
            kb, vb = _rows(k[b], k0, ROWS), _rows(v[b], k0, ROWS)
            acc_k = np.zeros((h_, ROWS, d_), np.float32)
            acc_v = np.zeros((h_, ROWS, d_), np.float32)
            for q0 in range(0, t_, TILE):
                qt, dot = _rows(q[b], q0, TILE), _rows(dout[b], q0, TILE)
                # lse and Δ read as 0 past T, where Q and dO are 0.
                lse_t = _rows(lse[b][..., None], q0, TILE)[..., 0]
                dlt_t = _rows(delta[b][..., None], q0, TILE)[..., 0]
                st = rows_product(kb, qt, n_s)
                dpt = rows_product(vb, dot, n_dp)
                p = np.where(kv[:, None],
                             np.exp(st * scale - lse_t[:, None, :]),
                             np.float32(0))
                # The dS warpgroup reads P back from its staged parts.
                p_hi, p_lo = split(p)
                ds = (p_hi + p_lo) * (dpt - dlt_t[:, None, :])
                acc_v = acc_v + product(p, dot, n_3)
                acc_k = acc_k + product(ds, qt, n_3)
            stop = min(ROWS, t_ - k0)
            dk[b, :, k0:k0 + stop] = (acc_k * scale)[:, :stop]
            dv[b, :, k0:k0 + stop] = acc_v[:, :stop]
        key_blocks.append(n)
    return dq, dk, dv, key_tiles, key_blocks


def _inputs(t, kind, seed):
    rng = np.random.default_rng(seed)
    rows = MASKS[kind][t]
    q, k, v, dout = (rng.normal(size=(len(rows), 2, t, 128)).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((len(rows), t), bool)
    for row, spans in enumerate(rows):
        for start, stop in spans:
            mask[row, start:stop] = False
    return q, k, v, dout, mask


def _forward(q, k, v, mask):
    """out and lse in float32, as the forward kernel stores them."""
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    return (fm.flash_mha_plain(tq, tk, tv, tm, SCALE).numpy(),
            fm.flash_mha_lse_plain(tq, tk, tm, SCALE).numpy())


def _plain(q, k, v, mask, dout, dtype):
    args = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    out = fm.flash_mha_plain(*args, tm, SCALE)
    return [g.numpy() for g in fm.flash_mha_bwd_plain(
        *args, tm, out, torch.from_numpy(dout).to(dtype), SCALE)]


def _errors(grads, q, k, v, mask, dout):
    """Per gradient: (max|g - f32 plain|, its bound, max|g - f64 plain|,
    the float64 criterion: 2·max|f32 plain - f64| + 1e-6·max|f64|)."""
    ref32 = _plain(q, k, v, mask, dout, torch.float32)
    ref64 = _plain(q, k, v, mask, dout, torch.float64)
    out = []
    for g, r32, r64 in zip(grads, ref32, ref64):
        top = np.abs(r64).max()
        out.append((np.abs(g - r32).max(), REL_BOUND * np.abs(r32).max(),
                    np.abs(g - r64).max(),
                    2 * np.abs(r32 - r64).max() + 1e-6 * top))
    return out


def _live(mask, width):
    t = mask.shape[1]
    return [sum(bool((~row[i:i + width]).any()) for i in range(0, t, width))
            for row in mask]


@pytest.mark.parametrize("kind", sorted(MASKS))
@pytest.mark.parametrize("t", [40, 300])
def test_kernel_emulation_matches_plain(t, kind):
    q, k, v, dout, mask = _inputs(t, kind, seed=t)
    out, lse = _forward(q, k, v, mask)
    dq, dk, dv, tiles, blocks = emulate(q, k, v, mask, out, dout, lse, SCALE)
    for diff, bound, diff64, bound64 in _errors((dq, dk, dv), q, k, v, mask,
                                                 dout):
        assert diff <= bound
        assert diff64 <= bound64
    for row, spans in enumerate(MASKS[kind][t]):
        if not spans:  # no valid key: exactly 0 everywhere
            assert not (dq[row].any() or dk[row].any() or dv[row].any())
    # Padded keys get no dk or dv.
    assert not dk[np.broadcast_to(mask[:, None], dk.shape[:3])].any()
    # Only tiles and blocks with a valid key are computed.
    assert tiles == _live(mask, TILE) and blocks == _live(mask, ROWS)
    if (kind, t) == ("holes", 300):
        assert tiles[0] == -(-t // TILE) - 4 and blocks[0] == -(-t // ROWS) - 1


@pytest.mark.parametrize("stage,products", [
    ("s", 3), ("dp", 3), ("dp", 2), ("third", 2), ("all", 1)])
def test_fewer_products_miss_the_bound(stage, products):
    """Three products are needed: two for dP or the third products (lo·hi
    without hi·lo), or one TF32 product throughout, leave an error past
    the float64 criterion that the card checks. The fourth, lo·lo, is
    below it at these sizes: S keeps it for the forward's reason (PERF.md,
    PR 5: a ReLU input near 0 in training takes the side float32 plain
    gives it), and S and dP get it from the same m64n64 instruction as
    lo·hi."""
    q, k, v, dout, mask = _inputs(300, "lengths", seed=300)
    out, lse = _forward(q, k, v, mask)
    counts = dict(KERNEL)
    for key in counts:
        if stage in (key, "all"):
            counts[key] = products
    grads = emulate(q, k, v, mask, out, dout, lse, SCALE, counts)[:3]
    errors = _errors(grads, q, k, v, mask, dout)
    missed = any(diff > bound or diff64 > bound64
                 for diff, bound, diff64, bound64 in errors)
    assert missed == (products < 3)


def test_kernel_emulation_matches_jax_tpu_kernel_at_valid_rows():
    lens = (300, 1, 173)
    rng = np.random.default_rng(7)
    q, k, v, dout = (rng.normal(size=(3, 2, 300, 128)).astype(np.float32)
                     for _ in range(4))
    mask = np.arange(300)[None, :] >= np.asarray(lens)[:, None]
    dout[np.broadcast_to(mask[:, None, :, None], dout.shape)] = 0.0

    def loss(q, k, v):
        o = jax_flash_mha(q, k, v, jnp.asarray(mask), SCALE)
        return jnp.sum(o * jnp.asarray(dout))

    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))]
    out, lse = _forward(q, k, v, mask)
    dq, dk, dv, _, _ = emulate(q, k, v, mask, out, dout, lse, SCALE)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(dq[i, :, :n], ref[0][i, :, :n], atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(dk, ref[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dv, ref[2], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Layouts, per thread, as csrc/flash_mha_bwd.cu and csrc/tf32_wgmma.cuh
# compute them. Lane = 4g + t; warp w of the consumer warpgroup.


def sw128(row, chunk):
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def tile_offset(row, col, chunk):
    """tf32_wgmma.cuh: tile_offset (TMA's 128-byte swizzle, 32-column
    chunks `chunk` bytes apart)."""
    return (col >> 5) * chunk + sw128(row, (col & 31) >> 2) + 4 * (col & 3)


def decode(off, chunk):
    """(row, col) of the float at byte `off` of a swizzled tile."""
    c, within = divmod(off, chunk)
    row = within // 128
    c16 = ((within % 128) // 16) ^ (row & 7)
    return row, 32 * c + 4 * c16 + (within % 16) // 4


def frag_offsets(w, lane, row0, col0, chunk, transposed):
    """tf32_wgmma.cuh: load_frag, the byte offsets of a[0..3]."""
    g, t = lane >> 2, lane & 3
    offs = []
    for r in range(4):
        m, kk = 16 * w + g + 8 * (r & 1), t + 4 * (r >> 1)
        offs.append(tile_offset(row0 + kk, col0 + m, chunk) if transposed
                    else tile_offset(row0 + m, col0 + kk, chunk))
    return offs


def a_coords(w, lane, r):
    """(m, k) of A register r of the TF32 m64nNk8 fragment."""
    g, t = lane >> 2, lane & 3
    return 16 * w + g + 8 * (r & 1), t + 4 * (r >> 1)


def acc_coords(w, lane, i):
    """(row, col) of accumulator register i of an m64nN wgmma."""
    g, t = lane >> 2, lane & 3
    j, h, e = i // 4, (i // 2) % 2, i % 2
    return 16 * w + g + 8 * h, 8 * j + 2 * t + e


def stage_offset(w, lane, i):
    """flash_mha_bwd.cu: stage_parts, the byte offset of register i."""
    g, t = lane >> 2, lane & 3
    j, h, e = i // 4, (i // 2) % 2, i % 2
    return sw128(16 * w + g + 8 * h, 2 * j + (t >> 1)) + 8 * (t & 1) + 4 * e


def test_fragments_read_the_rows_and_columns_of_their_tiles():
    # Resident tile (64 rows, 8 KB chunks) row-wise: A(m, k) = tile(m, 8kk
    # + k); streamed tile (32 hi rows per 8 KB chunk) column-wise:
    # A(m, k) = tile(8kk + k, 64 half + m).
    for w in range(4):
        for lane in range(32):
            for kk in range(16):
                for r, off in enumerate(frag_offsets(w, lane, 0, 8 * kk,
                                                     8192, False)):
                    m, k = a_coords(w, lane, r)
                    assert decode(off, 8192) == (m, 8 * kk + k)
            for kk in range(4):
                for half in range(2):
                    for r, off in enumerate(frag_offsets(
                            w, lane, 8 * kk, 64 * half, 8192, True)):
                        m, k = a_coords(w, lane, r)
                        row, col = decode(off, 8192)
                        assert (row, col) == (8 * kk + k, 64 * half + m)
                        assert row < TILE  # the hi rows of the chunk


def test_staged_accumulators_are_the_b_operand_as_it_stands():
    # An m64n32 accumulator written by stage_parts lands at its own (row,
    # column) of the swizzled 64 x 32 tile, which a K-major B descriptor
    # reads as B(k, n) = tile(n, k): rows n, columns k.
    seen = set()
    for w in range(4):
        for lane in range(32):
            for i in range(16):
                off = stage_offset(w, lane, i)
                assert off % 8 == 4 * (i % 2)  # float2 pairs
                assert decode(off, 8192) == acc_coords(w, lane, i)
                seen.add(off)
    assert seen == set(range(0, 64 * 128, 4))


def _wgmma_rs(a_tile, a_args, b_tile, n):
    """D = A B of one m64nNk8 wgmma, A from each thread's registers as the
    kernel loads them, B(k, n) = b_tile[n, k]."""
    d = np.zeros((64, n))
    a = np.full((64, 8), np.nan)
    for w in range(4):
        for lane in range(32):
            for r, off in enumerate(frag_offsets(w, lane, *a_args)):
                a[a_coords(w, lane, r)] = a_tile[off // 4]
    return d + a @ b_tile[:n, :8].T


def test_transposed_third_product_composes():
    # dv^T = dO^T P for one 32-query tile and one d-half: dO in the
    # streamed tile's layout (TMA), P written by stage_parts from the S^T
    # accumulator's registers; four k-steps of wgmma as the kernel issues
    # them give rows [64 half, 64 half + 64) of dO^T P.
    rng = np.random.default_rng(0)
    do = rng.normal(size=(TILE, 128))
    p = rng.normal(size=(ROWS, TILE))   # P^T: keys x queries
    do_img = np.zeros(4 * 8192 // 4)
    for r in range(TILE):
        for c in range(128):
            do_img[tile_offset(r, c, 8192) // 4] = do[r, c]
    p_img = np.zeros(8192 // 4)
    for w in range(4):
        for lane in range(32):
            for i in range(16):
                row, col = acc_coords(w, lane, i)
                p_img[stage_offset(w, lane, i) // 4] = p[row, col]
    b = np.zeros((ROWS, TILE))
    for off in range(0, 8192, 4):
        b[decode(off, 8192)] = p_img[off // 4]
    np.testing.assert_array_equal(b, p)
    for half in range(2):
        d = sum(_wgmma_rs(do_img, (8 * kk, 64 * half, 8192, True),
                          b[:, 8 * kk:8 * kk + 8], 64) for kk in range(4))
        np.testing.assert_allclose(d, (do.T @ p.T)[64 * half:64 * half + 64],
                                   rtol=1e-12, atol=1e-12)


def test_transposed_store_writes_each_row_once():
    # store_transposed: acc[half][4j + 2h + e] = (dim 64 half + 16w + g +
    # 8h, row 8j + 2t + e); row[0] takes h = 0, row[8] h = 1.
    seen = {}
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for half in range(2):
                for j in range(8):
                    for e in range(2):
                        r = 8 * j + 2 * t + e
                        for h, reg in ((0, 4 * j + e), (1, 4 * j + 2 + e)):
                            dim = 64 * half + 16 * w + g + 8 * h
                            m, n = acc_coords(w, lane, reg)
                            assert (n, 64 * half + m) == (r, dim)
                            seen[(r, dim)] = seen.get((r, dim), 0) + 1
    assert len(seen) == 64 * 128 and set(seen.values()) == {1}
