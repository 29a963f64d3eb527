"""The arithmetic of the flash forward kernel (``csrc/flash_mha.cu``),
emulated on the CPU.

The kernel multiplies float32 on the TF32 tensor cores at float32 accuracy:
every operand x is split into hi = rna(x) and lo = rna(x - hi), rna rounding
to TF32 (10 explicit mantissa bits) to nearest, ties away from zero, and
each product a·b becomes lo·hi + hi·lo + hi·hi (3xTF32, for P·V) or also
lo·lo (four, for S = QKᵀ, summed over the two halves of D). ``emulate``
below mirrors the kernel: the split with bit masks on float32, the products
(each exact in float32: 11 by 11 mantissa bits), the online softmax over key
tiles of the kernel's width with each tile's P·V added to the rescaled
output, and the skipping of tiles whose keys are all padded. It is held
against the plain version in float64 with the card's bound, 1e-5 · max|ref|,
and against the JAX package's TPU kernel in Pallas interpret mode at the
valid rows; a single TF32 product misses the bound on a row with one valid
key, which is why the kernel takes three or more.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from expressive_fastspeech2_mandarin_tpu.ops.pallas.flash_mha import (
    flash_mha as jax_flash_mha,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fm

SCALE = 128 ** -0.5
# Keys per tile: csrc/flash_mha.cu's kBk, which the built library reports as
# flash_mha_fwd_key_tile() (chip_smoke.py reads it there on the card).
KEY_TILE = 32
REL_BOUND = 1e-5   # chip_smoke.py: FLASH_REL_BOUND and LSE_REL_BOUND

# Valid keys of each batch row as [start, stop) intervals, per T.
MASKS = {
    # A row with one valid key and a row with none.
    "lengths": {20: ([(0, 1)], []), 300: ([(0, 1)], [])},
    # Not a prefix: at T = 300, tiles [0, 32) and [96, 128) are wholly
    # padded (the first tile and one in the middle); a full row beside it.
    "holes": {20: ([(5, 6), (11, 16)], [(0, 20)]),
              300: ([(40, 70), (130, 300)], [(0, 300)])},
}


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32, to nearest with ties away from zero, by bit
    masks (csrc/tf32_wgmma.cuh: tf32_rna)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """a @ b from TF32 parts, the small products first: n = 4 adds lo·lo to
    the three lo·hi + hi·lo + hi·hi; n = 1 is hi·hi alone."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    if n == 1:
        return a_hi @ b_hi
    small = a_lo @ b_hi + a_hi @ b_lo
    if n == 4:
        small = a_lo @ b_lo + small
    return small + a_hi @ b_hi


def scores(q: np.ndarray, kt: np.ndarray, n: int) -> np.ndarray:
    """Q Kᵀ as the kernel sums it: each half of D on its own, then added."""
    d = q.shape[-1] // 2
    return (product(q[..., :d], kt[..., :d, :], n)
            + product(q[..., d:], kt[..., d:, :], n))


def emulate(q, k, v, mask, scale, products=(4, 3)):
    """The kernel's float32 arithmetic on (B, H, T, D) numpy arrays and a
    (B, T) bool mask (True at padding), with ``products`` TF32 products per
    product in S and in P·V: (4, 3) is the kernel, (1, 1) single TF32.
    Returns (out, lse, tiles), tiles the number of key tiles computed per
    batch row."""
    b_, h_, t_, d_ = q.shape
    out = np.zeros(q.shape, np.float32)
    lse = np.zeros((b_, h_, t_), np.float32)
    tiles = []
    n_s, n_pv = products
    for b in range(b_):
        m = np.full((h_, t_), -np.inf, np.float32)
        l = np.zeros((h_, t_), np.float32)
        o = np.zeros((h_, t_, d_), np.float32)
        n = 0
        for k0 in range(0, t_, KEY_TILE):
            width = min(KEY_TILE, t_ - k0)
            valid = np.zeros(KEY_TILE, bool)
            valid[:width] = ~mask[b, k0:k0 + width]
            if not valid.any():
                continue  # a wholly padded tile: neither loaded nor computed
            n += 1
            kt = np.zeros((h_, KEY_TILE, d_), np.float32)  # rows past T: 0
            vt = np.zeros((h_, KEY_TILE, d_), np.float32)
            kt[:, :width], vt[:, :width] = (k[b, :, k0:k0 + width],
                                            v[b, :, k0:k0 + width])
            s = scores(q[b], kt.transpose(0, 2, 1), n_s)
            s = np.where(valid, s * np.float32(scale), np.float32(-np.inf))
            m_new = np.maximum(m, s.max(-1))
            shift = np.where(m_new == -np.inf, np.float32(0), m_new)
            alpha = np.exp(m - shift)
            p = np.exp(s - shift[..., None])
            l = l * alpha + p.sum(-1, dtype=np.float32)
            m = m_new
            o = o * alpha[..., None] + product(p, vt, n_pv)
        out[b] = o / np.where(l == 0, np.float32(1), l)[..., None]
        lse[b] = np.where(l == 0, np.float32(np.inf),
                          m + np.log(np.where(l == 0, np.float32(1), l)))
        tiles.append(n)
    return out, lse, tiles


def _inputs(t: int, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, 2, t, 128)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, t), bool)
    for row, spans in enumerate(MASKS[kind][t]):
        for start, stop in spans:
            mask[row, start:stop] = False
    return q, k, v, mask


def _plain64(q, k, v, mask):
    q64, k64, v64 = (torch.from_numpy(a).double() for a in (q, k, v))
    m = torch.from_numpy(mask)
    return (fm.flash_mha_plain(q64, k64, v64, m, SCALE).numpy(),
            fm.flash_mha_lse_plain(q64, k64, m, SCALE).numpy())


def _live_tiles(mask) -> list[int]:
    t = mask.shape[1]
    return [sum(bool((~row[k0:k0 + KEY_TILE]).any())
                for k0 in range(0, t, KEY_TILE)) for row in mask]


@pytest.mark.parametrize("kind", sorted(MASKS))
@pytest.mark.parametrize("t", [20, 300])
def test_kernel_emulation_matches_float64_plain(t, kind):
    q, k, v, mask = _inputs(t, kind, seed=t)
    out, lse, tiles = emulate(q, k, v, mask, SCALE)
    ref, ref_lse = _plain64(q, k, v, mask)
    bound = REL_BOUND * np.abs(ref).max()
    assert np.abs(out - ref).max() <= bound
    finite = np.isfinite(ref_lse)
    np.testing.assert_array_equal(np.isposinf(lse), ~finite)
    assert (np.abs(lse[finite] - ref_lse[finite]).max()
            <= REL_BOUND * np.abs(ref_lse[finite]).max())
    for row, spans in enumerate(MASKS[kind][t]):
        if not spans:  # no valid key: exactly 0
            assert not out[row].any()
    # Only the tiles with a valid key are computed; at T = 300 the holes
    # mask leaves two tiles of row 0 out.
    assert tiles == _live_tiles(mask)
    if (kind, t) == ("holes", 300):
        assert tiles[0] == -(-t // KEY_TILE) - 2


@pytest.mark.parametrize("t", [20, 300])
def test_single_tf32_misses_the_bound_on_a_one_key_row(t):
    # A row with one valid key returns that key's v; one TF32 product
    # rounds v to 11 significant bits (2^-11 relative), far past 1e-5.
    q, k, v, mask = _inputs(t, "lengths", seed=t)
    ref, _ = _plain64(q, k, v, mask)
    bound = REL_BOUND * np.abs(ref).max()
    one, _, _ = emulate(q, k, v, mask, SCALE, products=(1, 1))
    kernel, _, _ = emulate(q, k, v, mask, SCALE)
    assert np.abs(one[0] - ref[0]).max() > 10 * bound
    assert np.abs(kernel[0] - ref[0]).max() <= bound


def test_kernel_emulation_matches_jax_tpu_kernel_at_valid_rows():
    lens = (300, 1)
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 2, 300, 128)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(300)[None, :] >= np.asarray(lens)[:, None]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_flash_mha(
            *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), SCALE))
    out, _, _ = emulate(q, k, v, mask, SCALE)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(out[i, :, :n], ref[i, :, :n], atol=1e-5,
                                   rtol=0)


def _vt_column(key: int) -> int:
    """csrc/flash_mha.cu: vt_column."""
    return (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1)


def test_p_fragments_meet_their_keys_in_permuted_v():
    # The kernel feeds the S accumulator's registers to the P·V product as
    # A fragments, {d[4j], d[4j+2], d[4j+1], d[4j+3]} for k-step j, and
    # stores V transposed with the keys of each 8 permuted (vt_column). For
    # every thread and register, the (row, key) the accumulator holds must
    # be the (row, column) the A fragment stands for, column read as a key.
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(4):
            # m64nN accumulator: d[4j + 2h + e] = (row g + 8h, col 8j+2t+e).
            acc = {4 * j + 2 * h + e: (g + 8 * h, 8 * j + 2 * t + e)
                   for h in range(2) for e in range(2)}
            # tf32 A fragment: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
            # a3 (g+8, t+4), columns of V^T 8j + c.
            frag = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
            for (row, col), reg in zip(frag, (4 * j, 4 * j + 2, 4 * j + 1,
                                              4 * j + 3)):
                acc_row, key = acc[reg]
                assert acc_row == row
                assert _vt_column(key) == 8 * j + col
    assert sorted(_vt_column(c) for c in range(KEY_TILE)) == list(
        range(KEY_TILE))
