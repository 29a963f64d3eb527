"""The bf16 flash backward kernels (``csrc/flash_mha_bwd_bf16.cu``): their
split of the work between two consumer warpgroups and their ring of
stages, emulated on the CPU.

Each kernel's block has a producer warpgroup, which brings the streamed
64-row tiles (K and V for dQ, Q and dO for dK/dV) into a ring of stages,
and two consumer warpgroups that share the block's 64 resident rows and
take the streamed tiles in turn: stream slot n lies in stage n % stages
and belongs to consumer n % 2. Each consumer sums its own tiles' products
in float32; at the end consumer 1's sums are added to consumer 0's, so
dq (dk, dv) = bf16(even-slot sum + odd-slot sum). The dQ kernel's slots
are the key tiles with a valid key; the dK/dV kernel's every query tile.
After the last tile each consumer gets an end slot.

* ``emulate`` does that arithmetic in plain torch: S and dP from the bf16
  operands in float32, P = 2^(s·scale·log2e − lse·log2e) (the kernels'
  ex2), dS·scale and Pᵀ rounded to bf16 as operands, each consumer's sum
  over its tiles, the fixed-order sum, bf16 stores. It is held against
  ``flash_mha_bwd_plain`` on bf16 inputs at the card's bound (2⁻⁶·max|ref|)
  and against ``jax.grad`` of the JAX package's TPU kernel in interpret
  mode at ``test_bf16_op_matches_jax_tpu_kernel``'s bounds.
* The ring: a model of the mbarriers (phase parity, arrival counts) runs
  the producer and the two consumers in random interleavings and checks
  that every consumer reads its own slots in order, that no stage is
  loaded while a consumer still reads it, that the ring never stalls, and
  that consumer 1's stages take no load once it is done (it hands its
  sums over in them).
* The constants (stages, consumers, tile rows) are read from the sources,
  so the emulation follows the kernels; the mbarrier model and the random
  interleaving are tests/ring_model.py's, which the forward's test shares.
"""

import random

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

from .ring_model import (
    MBarrier,
    empty_parity,
    full_parity,
    interleave,
    source_int,
    stage,
)
from .test_torch_flash_bf16 import GRAD_REL, SCALE, _inputs

torch.set_num_threads(2)

TILE = source_int("bf16_wgmma.cuh", r"constexpr int kTileRows = (\d+);")
CONSUMERS = source_int("flash_mha_bwd_bf16.cu",
                       r"constexpr int kConsumers = (\d+);")
DQ_STAGES = source_int("flash_mha_bwd_bf16.cu",
                       r"using DqL = Layout<(\d+),")
DKV_STAGES = source_int("flash_mha_bwd_bf16.cu",
                        r"using DkvL = Layout<(\d+),")
LOG2E = np.float32(1.4426950408889634)


# The index maps of the kernels' ring (flash_mha_bwd_bf16.cu): stage,
# full_parity and empty_parity (tests/ring_model.py), and the owner.
def owner(n: int) -> int:
    """The consumer warpgroup that takes stream slot n."""
    return n % CONSUMERS


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _p(s, lse, keep, scale):
    """P as the kernels form it: 2^(s·scale·log2e − lse·log2e) in float32,
    0 where ``keep`` is False (a padded key) or lse is +inf."""
    arg = s * np.float32(scale * LOG2E) - lse * LOG2E
    return torch.where(keep, torch.exp2(arg), torch.zeros_like(s))


def _tile(x, i):
    """Rows [64 i, 64 i + 64) of (..., T, D), zero past T."""
    t = x.shape[-2]
    part = x[..., TILE * i:TILE * (i + 1), :]
    if part.shape[-2] < TILE:
        pad = torch.zeros(part.shape[:-2] + (TILE - part.shape[-2],)
                          + part.shape[-1:], dtype=x.dtype)
        part = torch.cat([part, pad], dim=-2)
    return part if TILE * i < t else torch.zeros_like(part)


def emulate(q, k, v, mask, out, dout, lse, scale, consumers=CONSUMERS):
    """(dq, dk, dv) as the kernels compute them, on float32 tensors holding
    bf16 values; lse (B, H, T) float32 with +inf at rows of no valid key.
    ``consumers`` 1 sums every tile in one chain instead."""
    b, h, t, d = q.shape
    n_tiles = -(-t // TILE)
    keys = ~mask  # (B, T)
    delta = (dout * out).sum(-1)  # float32, as the dQ kernel writes it
    lse_p = torch.cat([lse, torch.full((b, h, n_tiles * TILE - t),
                                       float("inf"))], dim=-1)
    delta_p = torch.cat([delta, torch.zeros(b, h, n_tiles * TILE - t)], -1)
    keys_p = torch.cat([keys, torch.zeros(b, n_tiles * TILE - t,
                                          dtype=torch.bool)], -1)
    dq, dk, dv = (torch.zeros(b, h, n_tiles * TILE, d) for _ in range(3))
    for bi in range(b):
        live = [i for i in range(n_tiles)
                if keys_p[bi, TILE * i:TILE * (i + 1)].any()]
        for r in range(n_tiles):  # the dQ kernel's block r
            qr, dor = _tile(q[bi], r), _tile(dout[bi], r)
            rows = slice(TILE * r, TILE * (r + 1))
            part = [torch.zeros(h, TILE, d) for _ in range(consumers)]
            for n, i in enumerate(live):  # slot n: key tile i
                kt, vt = _tile(k[bi], i), _tile(v[bi], i)
                keep = keys_p[bi, TILE * i:TILE * (i + 1)][None, None, :]
                p = _p(qr @ kt.transpose(-1, -2), lse_p[bi, :, rows, None],
                       keep, scale)
                dp = dor @ vt.transpose(-1, -2)
                ds = bf16((dp - delta_p[bi, :, rows, None]) * p
                          * np.float32(scale))
                part[n % consumers] += ds @ kt
            dq[bi, :, rows] = bf16(sum(part[1:], part[0]))
        for j in range(n_tiles):  # the dK/dV kernel's block j
            kj, vj = _tile(k[bi], j), _tile(v[bi], j)
            rows = slice(TILE * j, TILE * (j + 1))
            keep = keys_p[bi, rows][None, :, None]
            if not keep.any():
                continue  # a block of padded keys writes zeros
            pk = [torch.zeros(h, TILE, d) for _ in range(consumers)]
            pv = [torch.zeros(h, TILE, d) for _ in range(consumers)]
            for n in range(n_tiles):  # slot n: query tile n
                qt, dot = _tile(q[bi], n), _tile(dout[bi], n)
                cols = slice(TILE * n, TILE * (n + 1))
                lse_t = lse_p[bi, :, cols][:, None, :].clone()
                lse_t[:, :, max(0, t - TILE * n):] = 0.0  # cp.async 0 past T
                pt = _p(kj @ qt.transpose(-1, -2), lse_t, keep, scale)
                dpt = vj @ dot.transpose(-1, -2)
                dst = bf16((dpt - delta_p[bi, :, cols][:, None, :]) * pt
                           * np.float32(scale))
                pv[n % consumers] += bf16(pt) @ dot
                pk[n % consumers] += dst @ qt
            dk[bi, :, rows] = bf16(sum(pk[1:], pk[0]))
            dv[bi, :, rows] = bf16(sum(pv[1:], pv[0]))
    return dq[..., :t, :], dk[..., :t, :], dv[..., :t, :]


def _case(t, lens, seed):
    """bf16 inputs as float32 tensors, the bf16 forward output and lse of
    the plain versions, and the (B, T) mask."""
    q, k, v, dout, mask = _inputs(t, lens, seed)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    tmask = torch.from_numpy(mask)
    out = fm.flash_mha_blocked_plain(tq.bfloat16(), tk.bfloat16(),
                                     tv.bfloat16(), tmask, SCALE, TILE)
    lse = fm.flash_mha_lse_plain(tq, tk, tmask, SCALE)
    return tq, tk, tv, tdo, tmask, out, lse, (q, k, v, dout, mask)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# Ragged lengths: an odd number of live tiles (5 at T = 300), a row with
# one live tile and a block of one valid key, a row with none; and a mask
# that is not a prefix, with a wholly padded tile in the middle of a row.
CASES = [(300, (300, 64, 0, 257)), (192, (100, 192))]


@pytest.mark.parametrize("t,lens", CASES)
def test_emulation_matches_the_plain_backward(t, lens):
    q, k, v, dout, mask, out, lse, _ = _case(t, lens, seed=t + 3)
    if t == 192:  # punch a wholly padded 64-key tile into row 1
        mask[1, 64:128] = True
        out = fm.flash_mha_blocked_plain(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), mask, SCALE, TILE)
        lse = fm.flash_mha_lse_plain(q, k, mask, SCALE)
    grads = emulate(q, k, v, mask, out.float(), dout, lse, SCALE)
    refs = fm.flash_mha_bwd_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  mask, out, dout.bfloat16(), SCALE)
    for g, r in zip(grads, refs):
        assert torch.equal(g, bf16(g))  # stored in bf16
        assert _rel(g, r.float()) <= GRAD_REL
    for i, n in enumerate(lens):
        if n == 0 and not (~mask[i]).any():  # no valid key: exactly 0
            assert all(torch.count_nonzero(g[i]) == 0 for g in grads)
    assert all(float(g.abs().max()) > 1e-2 for g in grads)


def test_emulation_matches_jax_tpu_kernel():
    """At (2, 2, 256, 128) with the key lengths of
    test_bf16_op_matches_jax_tpu_kernel: dq at the valid rows, dk and dv at
    every row (dO is 0 at padded query rows) within 2⁻⁶·max|g| of jax.grad
    of the TPU kernel in interpret mode."""
    t, lens = 256, (256, 100)
    q, k, v, dout, mask, out, lse, arrays = _case(t, lens, seed=t)
    jq, jk, jv, jdo, jmask = arrays
    jdout = jnp.asarray(jdo, jnp.bfloat16).astype(jnp.float32)

    def loss(q, k, v):
        o = jax_flash_mha(q, k, v, jnp.asarray(jmask), SCALE)
        return jnp.sum(o.astype(jnp.float32) * jdout)

    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a, jnp.bfloat16) for a in (jq, jk, jv)))
    jgrads = [torch.from_numpy(np.array(g.astype(jnp.float32)))
              for g in jgrads]
    dq, dk, dv = emulate(q, k, v, mask, out.float(), dout, lse, SCALE)
    rows = [(i, n) for i, n in enumerate(lens)]
    assert (max(float((dq[i, :, :n] - jgrads[0][i, :, :n]).abs().max())
                for i, n in rows)
            <= GRAD_REL * float(jgrads[0].abs().max()))
    assert _rel(dk, jgrads[1]) <= GRAD_REL
    assert _rel(dv, jgrads[2]) <= GRAD_REL


def test_the_split_sums_each_consumers_tiles_then_the_two():
    """dq = bf16(even-slot sum + odd-slot sum): not one chain over the
    tiles in order, which rounds differently (the split changes bits, not
    the bound), and fixed, so a rerun gives the same bits."""
    q, k, v, dout, mask, out, lse, _ = _case(640, (640, 600), seed=11)
    split = emulate(q, k, v, mask, out.float(), dout, lse, SCALE)
    chain = emulate(q, k, v, mask, out.float(), dout, lse, SCALE,
                    consumers=1)
    again = emulate(q, k, v, mask, out.float(), dout, lse, SCALE)
    assert all(torch.equal(a, b) for a, b in zip(split, again))
    assert any(not torch.equal(a, b) for a, b in zip(split, chain))
    for a, b in zip(split, chain):
        assert _rel(a, b) <= GRAD_REL


def test_index_maps_of_the_ring():
    assert CONSUMERS == 2 and TILE == 64
    for stages in (DQ_STAGES, DKV_STAGES):
        assert stages % CONSUMERS == 0  # each stage belongs to one consumer
        for n in range(4 * stages):
            assert owner(n) == stage(n, stages) % CONSUMERS
        # The first round passes the empty barriers at once; the consumer
        # waits for parity 0, then 1, ...
        assert [empty_parity(n, stages) for n in range(stages)] == \
            [1] * stages
        assert [full_parity(n, stages) for n in range(3 * stages)] == \
            [0] * stages + [1] * stages + [0] * stages
    # Consumer 1 hands its sums over in its own stage 1 (and 3): owned by it.
    assert owner(1) == owner(3) == 1


def run_ring(n_real, stages, seed, overlap):
    """The producer and the two consumers of one block over ``n_real``
    loaded slots and an end slot for each consumer, in a random
    interleaving. ``overlap``: a consumer waits for its next slot before it
    frees the current one (both kernels do). Returns each consumer's slots
    as read and the log of loads."""
    full = [MBarrier(1) for _ in range(stages)]
    empty = [MBarrier(4) for _ in range(stages)]  # four warps a consumer
    content = [None] * stages
    readers = [set() for _ in range(stages)]
    loads = []
    seen = {0: [], 1: []}
    done = set()

    def producer():
        for n in range(n_real + CONSUMERS):
            s = stage(n, stages)
            while not empty[s].passes(empty_parity(n, stages)):
                yield
            assert not readers[s], f"slot {n} loads stage {s} while read"
            content[s] = n
            loads.append((n, s))
            full[s].arrive()

    def consumer(c):
        n = c
        s = stage(n, stages)
        while not full[s].passes(full_parity(n, stages)):
            yield
        readers[s].add(c)
        while True:
            assert content[s] == n
            seen[c].append(n)
            if n >= n_real:  # the end slot
                break
            nxt = n + CONSUMERS
            sn = stage(nxt, stages)
            if not overlap:
                readers[s].discard(c)
                empty[s].arrive(4)
            while not full[sn].passes(full_parity(nxt, stages)):
                yield
            readers[sn].add(c)
            if overlap:
                readers[s].discard(c)
                empty[s].arrive(4)
            n, s = nxt, sn
            yield
        done.add((c, len(loads)))

    interleave([producer(), consumer(0), consumer(1)], random.Random(seed))
    return seen, loads, done


@pytest.mark.parametrize("stages", sorted({DQ_STAGES, DKV_STAGES}))
@pytest.mark.parametrize("n_real", [0, 1, 2, 5, 16])
def test_ring_delivers_each_consumer_its_slots(stages, n_real):
    for seed in range(20):
        seen, loads, done = run_ring(n_real, stages, seed, overlap=True)
        for c in (0, 1):
            mine = list(range(c, n_real, CONSUMERS))
            end = min(n for n in range(n_real, n_real + CONSUMERS)
                      if owner(n) == c)
            assert seen[c] == mine + [end]
        assert [n for n, _ in loads] == list(range(n_real + CONSUMERS))
        # Once consumer 1 is done, no load lands in its stages.
        (_, at), = [d for d in done if d[0] == 1]
        assert all(owner(s) == 0 for _, s in loads[at:])
