"""The bf16 flash forward kernel (``csrc/flash_mha_bf16.cu``): its
arithmetic and its ring of stages, emulated on the CPU.

A block of the kernel holds 128 query rows of one (batch, head). Its
producer warp scans the key mask once and streams the 64-key tiles with a
valid key (K and V) into a ring of stages, each slot's tile and key bits
beside the stage, then one end slot with no key bits. Its two consumer
warpgroups own 64 of the rows each and both read every slot, so each row's
online softmax sees the live 64-key tiles in order:

    m' = max(m, max_valid(s) · scale·log2e)            (log2 units)
    P  = 2^(s·scale·log2e − m')  (one fma, ex2), 0 at padded keys
    α  = 2^(m − m'),  l' = l·α + Σ P  (the unrounded P)
    O' = O·α + bf16(P) V   (P V a fresh float32 sum, added by one fma)
    out = bf16(O / l),  lse = m·ln2 + log l  (natural units)

* ``emulate`` does that in plain torch, block by block and consumer by
  consumer, from the producer's slots (``producer_slots``). It is held
  against ``flash_mha_blocked_plain`` on the kernel's 64-key tiles (the
  card's reference, 2⁻⁷·max|ref|, and bit-equal at most elements: the
  rounding points are the same), the LSE against ``torch.logsumexp``
  (1e-5), and against the JAX package's TPU kernel in Pallas interpret
  mode at ``test_bf16_op_matches_jax_tpu_kernel``'s bound.
* The ring: the producer and the two consumers run in random interleavings
  on tests/ring_model.py's mbarriers (empty barriers of eight warp
  arrivals) and the two named barriers by which the consumers take turns
  at issuing; every consumer must read every slot in order, no stage may
  be loaded while either consumer reads it, the ring must not stall, and
  the turns must balance (no arrival left over when the block ends).
* The constants (stages, consumers, tile rows) are read from the sources.
"""

import math
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from expressive_fastspeech2_mandarin_tpu.ops.pallas.flash_mha import (
    flash_mha as jax_flash_mha,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fm

from .ring_model import (
    MBarrier,
    NamedBarrier,
    empty_parity,
    full_parity,
    interleave,
    source_int,
    stage,
)
from .test_torch_flash_bf16 import OUT_REL, SCALE, _inputs

torch.set_num_threads(2)

SRC = "flash_mha_bf16.cu"
TILE = source_int("bf16_wgmma.cuh", r"constexpr int kTileRows = (\d+);")
CONSUMERS = source_int(SRC, r"constexpr int kConsumers = (\d+);")
STAGES = source_int(SRC, r"constexpr int kStages = (\d+);")
PRODUCER_REGS = source_int(SRC, r"constexpr int kProducerRegs = (\d+);")
CONSUMER_REGS = source_int(SRC, r"constexpr int kConsumerRegs = (\d+);")
ROWS = CONSUMERS * TILE  # query rows a block
WARPS = 4  # a warpgroup's warps: each arrives once on a stage's empty barrier
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fma(a, b, c):
    """float32 a·b + c rounded once (a·b is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def producer_slots(keys: torch.Tensor) -> list[tuple[int, int]]:
    """The producer's slots for one mask row (``keys`` True at valid keys):
    (tile, key bits) of every 64-key tile with a valid key, in order, then
    the end slot (the tile count, no bits)."""
    t = keys.shape[0]
    n_tiles = -(-t // TILE)
    slots = []
    for i in range(n_tiles):
        part = keys[TILE * i:TILE * (i + 1)]
        bits = sum(1 << c for c in range(part.shape[0]) if part[c])
        if bits:
            slots.append((i, bits))
    return slots + [(n_tiles, 0)]


def _tile(x, i):
    """Rows [64 i, 64 i + 64) of (..., T, D), zero past T (TMA's fill)."""
    part = x[..., TILE * i:TILE * (i + 1), :]
    pad = TILE - part.shape[-2]
    if pad:
        part = torch.cat([part, part.new_zeros(part.shape[:-2] + (pad,)
                                               + part.shape[-1:])], dim=-2)
    return part


def consumer_rows(q_rows, k, v, slots, scale, sum_rounded_p=False):
    """One consumer's 64 query rows (H, 64, D) over the slots: (o, l, m),
    o unnormalised float32, m in log2 units."""
    h = q_rows.shape[0]
    scale2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    o = torch.zeros(h, TILE, q_rows.shape[-1])
    m = torch.full((h, TILE, 1), -math.inf)
    l = torch.zeros(h, TILE, 1)
    for tile, bits in slots[:-1]:  # the end slot's S is dropped
        keep = torch.tensor([(bits >> c) & 1 for c in range(TILE)],
                            dtype=torch.bool)
        s = q_rows @ _tile(k, tile).transpose(-1, -2)
        mx = torch.where(keep, s, torch.tensor(-math.inf)).amax(-1, True)
        m_new = torch.maximum(m, mx * scale2)
        shift = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                            m_new)
        alpha = torch.where(m_new == m, torch.ones_like(m),
                            torch.exp2(m - shift))
        p = torch.where(keep, torch.exp2(fma(s, scale2, -shift)),
                        torch.zeros_like(s))
        total = (bf16(p) if sum_rounded_p else p).sum(-1, keepdim=True)
        l = fma(l, alpha, total)
        o = fma(o, alpha, bf16(p) @ _tile(v, tile))  # P V a fresh sum
        m = m_new
    return o, l, m


def emulate(q, k, v, mask, scale, **kw):
    """(out, lse) as the kernel computes them, on float32 tensors holding
    bf16 values: out bf16 values as float32, lse float32 (+inf at a row of
    no valid key)."""
    b, h, t, d = q.shape
    n_blocks = -(-t // ROWS)
    out = torch.zeros(b, h, n_blocks * ROWS, d)
    lse = torch.zeros(b, h, n_blocks * ROWS)
    for bi in range(b):
        slots = producer_slots(~mask[bi])
        for blk in range(n_blocks):
            for c in range(CONSUMERS):
                r0 = blk * ROWS + c * TILE
                o, l, m = consumer_rows(_tile(q[bi], r0 // TILE), k[bi],
                                        v[bi], slots, scale, **kw)
                inv = 1.0 / torch.where(l == 0, torch.ones_like(l), l)
                out[bi, :, r0:r0 + TILE] = bf16(o * inv)
                lse[bi, :, r0:r0 + TILE] = torch.where(
                    l == 0, torch.tensor(math.inf),
                    fma(m, torch.tensor(LN2), torch.log(l)))[..., 0]
    return out[..., :t, :], lse[..., :t]


def _case(t, lens, seed):
    q, k, v, _, mask = _inputs(t, lens, seed)
    return (*(torch.from_numpy(a) for a in (q, k, v, mask)),
            (q, k, v, mask))


def _blocked(q, k, v, mask, block):
    return fm.flash_mha_blocked_plain(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16(), mask, SCALE,
                                      block).float()


# Ragged lengths past one block (T = 300: three blocks, the last one's
# second consumer wholly past T), a row of one live tile, a row with none
# (the producer streams it the end slot alone); a mask that is not a
# prefix, with a wholly padded tile mid-row; T = 130, one valid key last.
CASES = [(300, (300, 64, 0, 257)), (192, (100, 192)), (130, (130, 1))]


@pytest.mark.parametrize("t,lens", CASES)
def test_emulation_matches_the_blocked_plain_forward(t, lens):
    q, k, v, mask, _ = _case(t, lens, seed=t + 5)
    if t == 192:  # a wholly padded 64-key tile in the middle of row 1
        mask[1, 64:128] = True
    if t == 130:  # row 1: one valid key, the last
        mask[1] = True
        mask[1, t - 1] = False
    out, lse = emulate(q, k, v, mask, SCALE)
    ref = _blocked(q, k, v, mask, TILE)
    assert torch.equal(out, bf16(out))  # stored in bf16
    assert float((out - ref).abs().max()) <= OUT_REL * float(ref.abs().max())
    # The same rounding points: almost every element bit-equal.
    assert float((out == ref).float().mean()) >= 0.99
    lse_ref = fm.flash_mha_lse_plain(q, k, mask, SCALE)
    finite = torch.isfinite(lse_ref)
    assert torch.equal(torch.isposinf(lse), ~finite)
    assert (float((lse - lse_ref)[finite].abs().max())
            <= 1e-5 * float(lse_ref[finite].abs().max()))
    for i in range(len(lens)):
        if bool(mask[i].all()):  # no valid key: exactly 0
            assert torch.count_nonzero(out[i]) == 0


def test_emulation_rounds_p_on_its_64_key_tiles():
    """P is rounded per 64-key tile after that tile's running max: the
    blocked plain version on 64-key tiles agrees with the emulation at more
    elements than on the TPU kernel's 128-key blocks, and summing the
    rounded P instead of the unrounded one moves more elements still."""
    q, k, v, mask, _ = _case(640, (640, 333), seed=17)
    out, _ = emulate(q, k, v, mask, SCALE)
    same = {block: float((out == _blocked(q, k, v, mask, block)).float()
                         .mean()) for block in (TILE, 2 * TILE)}
    rounded_sum, _ = emulate(q, k, v, mask, SCALE, sum_rounded_p=True)
    ref = _blocked(q, k, v, mask, TILE)
    assert same[TILE] >= 0.99 and same[TILE] > same[2 * TILE]
    assert float((rounded_sum == ref).float().mean()) < same[TILE]


def test_emulation_matches_jax_tpu_kernel():
    """At (2, 2, 256, 128) with the key lengths of
    test_bf16_op_matches_jax_tpu_kernel: the valid rows within
    2⁻⁷·max|ref| of the TPU kernel in interpret mode."""
    t, lens = 256, (256, 100)
    q, k, v, mask, arrays = _case(t, lens, seed=t)
    jq, jk, jv, jmask = arrays
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_mha(*(jnp.asarray(a, jnp.bfloat16)
                              for a in (jq, jk, jv)),
                            jnp.asarray(jmask), SCALE)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    out, _ = emulate(q, k, v, mask, SCALE)
    worst = max(float((out[i, :, :n] - ref[i, :, :n]).abs().max())
                for i, n in enumerate(lens))
    assert worst <= OUT_REL * float(ref.abs().max())


def test_ex2_of_the_folded_argument_is_exp():
    """P = 2^(s·scale·log2e − m·log2e) by one fma, against exp(s·scale − m)
    in float64: within 2⁻²⁰ relative (the card's ex2.approx adds ~2⁻²²),
    far below bf16's 2⁻⁹."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.normal(0, 12, 4096).astype(np.float32))
    scale2 = torch.tensor(SCALE, dtype=torch.float32) * LOG2E
    m2 = s.max() * scale2
    p = torch.exp2(fma(s, scale2, -m2))
    exact = torch.exp(s.double() * SCALE - s.double().max() * SCALE)
    assert float(((p.double() - exact).abs() / exact).max()) <= 2.0 ** -20


@pytest.mark.parametrize("t", [20, 128, 130, 300])
def test_the_block_is_two_consumers_of_64_rows(t):
    """Row r of a head lies in block r // 128 and consumer (r % 128) // 64:
    the consumers' rows cover each row once. A consumer whose rows all lie
    past T (TMA reads its Q as zero) still reads every slot, so the
    block's turns and empty barriers balance; its sums stay finite and are
    not stored."""
    n_blocks = -(-t // ROWS)
    owners = [(r // ROWS, (r % ROWS) // TILE) for r in range(t)]
    rows = {(blk, c): [r for r in range(n_blocks * ROWS)
                       if (r // ROWS, (r % ROWS) // TILE) == (blk, c)]
            for blk in range(n_blocks) for c in range(CONSUMERS)}
    assert sorted(owners) == owners and len(rows) == CONSUMERS * n_blocks
    assert all(len(r) == TILE and r == list(range(r[0], r[0] + TILE))
               for r in rows.values())
    q, k, v, mask, _ = _case(t, (t, t // 2), seed=t)
    ghost = torch.zeros(2, TILE, 128)  # rows past T, as TMA lands them
    o, l, m = consumer_rows(ghost, k[0], v[0], producer_slots(~mask[0]),
                            SCALE)
    assert bool(torch.isfinite(o).all() and (l > 0).all())


def test_producer_streams_only_tiles_with_a_valid_key():
    t = 300  # five tiles, the last of 44 keys
    keys = torch.zeros(t, dtype=torch.bool)
    assert producer_slots(keys) == [(5, 0)]  # no valid key: the end slot
    keys[299] = True
    assert producer_slots(keys) == [(4, 1 << 43), (5, 0)]
    keys[:] = True
    keys[64:128] = False  # a wholly padded tile mid-row is skipped
    slots = producer_slots(keys)
    assert [s[0] for s in slots] == [0, 2, 3, 4, 5]
    assert slots[0][1] == (1 << 64) - 1 and slots[3][1] == (1 << 44) - 1


def window_slots(keys: torch.Tensor) -> list[tuple[int, int]]:
    """``producer_slots`` as the producer's warp forms them: lane l's byte
    of window w holds keys 256 w + 8 l + j (bit j), and tile t of the window
    gathers the bytes of lanes 8t .. 8t + 7."""
    t = keys.shape[0]
    n_tiles = -(-t // TILE)
    slots = []
    for w in range(-(-n_tiles // 4)):
        byte = [sum(1 << j for j in range(8)
                    if 256 * w + 8 * lane + j < t
                    and keys[256 * w + 8 * lane + j])
                for lane in range(32)]
        for tt in range(4):
            tile = 4 * w + tt
            bits = sum(byte[8 * tt + i] << (8 * i) for i in range(8))
            if tile < n_tiles and bits:
                slots.append((tile, bits))
    return slots + [(n_tiles, 0)]


@pytest.mark.parametrize("t", [20, 300, 1000, 1030])
def test_mask_windows_give_each_tiles_key_bits(t):
    rng = np.random.default_rng(t)
    for density in (0.0, 0.02, 0.5, 1.0):
        keys = torch.from_numpy(rng.random(t) < density)
        assert window_slots(keys) == producer_slots(keys)


def test_registers_and_shared_memory_of_the_split():
    """setmaxnreg 24 / 240 fills the 64,512 registers a 384-thread block of
    one block an SM is given (168 a thread); the ring's shared memory fits
    a block's 232,448 bytes."""
    threads = (1 + CONSUMERS) * 128
    assert 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <= (
        65536 // threads // 8 * 8 * threads)
    smem = (CONSUMERS + 2 * STAGES) * TILE * 256 + STAGES * 16 \
        + (2 * STAGES + 1) * 8 + 1024
    assert STAGES >= 2 and smem <= 232448


def run_forward_ring(slots, seed):
    """The producer and the two consumers of one block over ``slots`` (the
    producer's, end slot last) in a random interleaving, as the kernel's
    loops run them. Returns each consumer's slots as read, the loads and
    the two turn barriers."""
    n_live = len(slots) - 1
    full = [MBarrier(1) for _ in range(STAGES)]
    empty = [MBarrier(CONSUMERS * WARPS) for _ in range(STAGES)]
    turn = [NamedBarrier(CONSUMERS * 128) for _ in range(CONSUMERS)]
    content = [None] * STAGES
    readers = [set() for _ in range(STAGES)]
    loads, seen = [], {c: [] for c in range(CONSUMERS)}

    def producer():
        for n, slot in enumerate(slots):
            s = stage(n, STAGES)
            while not empty[s].passes(empty_parity(n, STAGES)):
                yield
            assert not readers[s], f"slot {n} loads stage {s} while read"
            content[s] = (n, slot)
            loads.append(n)
            full[s].arrive()
            yield

    def read(c, n):
        s = stage(n, STAGES)
        while not full[s].passes(full_parity(n, STAGES)):
            yield
        readers[s].add(c)
        assert content[s] == (n, slots[n])
        seen[c].append(n)

    def consumer(c):
        yield from read(c, 0)
        if c == 1 and n_live > 0:
            turn[0].arrive(128)  # consumer 0 issues first
        for n in range(n_live):
            yield from read(c, n + 1)
            done = turn[c].sync(128)  # my turn to issue S and P V
            while not done():
                yield
            turn[1 - c].arrive(128)
            yield  # the softmax of slot n + 1 under P V of slot n
            readers[stage(n, STAGES)].discard(c)
            empty[stage(n, STAGES)].arrive(WARPS)
        if c == 0 and n_live > 0:  # consumer 1's last arrival
            done = turn[0].sync(128)
            while not done():
                yield

    interleave([producer()] + [consumer(c) for c in range(CONSUMERS)],
               random.Random(seed))
    return seen, loads, turn


@pytest.mark.parametrize("n_live", [0, 1, 2, 5, STAGES + 1, 16])
def test_ring_delivers_every_slot_to_both_consumers(n_live):
    slots = [(2 * i, 1) for i in range(n_live)] + [(2 * n_live + 1, 0)]
    for seed in range(20):
        seen, loads, turn = run_forward_ring(slots, seed)
        assert loads == list(range(n_live + 1))
        for c in range(CONSUMERS):
            assert seen[c] == list(range(n_live + 1))
        # The turns balance: each phase had its sync and its arrive.
        assert all(b.arrived == 0 for b in turn)
        assert [b.completed for b in turn] == [n_live + (n_live > 0),
                                               n_live]


def test_ring_parities_of_the_first_rounds():
    # The first round passes the empty barriers at once; the consumers wait
    # for parity 0, then 1, ...
    assert [empty_parity(n, STAGES) for n in range(STAGES)] == [1] * STAGES
    assert [full_parity(n, STAGES) for n in range(3 * STAGES)] == \
        [0] * STAGES + [1] * STAGES + [0] * STAGES
