"""The gradient of the port's ``flash_mha`` on the CPU (``FlashMHA``, whose
backward there is ``flash_mha_bwd_plain``).

* Against ``jax.grad`` of the JAX package's ``flash_mha`` — the stock TPU
  Pallas kernel and its custom VJP (the dK/dV and dQ kernels), run in
  interpret mode — at (B, H, D) = (2, 2, 128), T = 256 and a ragged
  T = 640, with dO zero at padded query rows, as the FFT block's
  masked_fill makes it: dq at the valid rows, dk and dv at every row, within
  1e-5 (float32; summation order and ``exp``). At padded query rows dq
  differs by design: the TPU kernel lets them attend to padded keys.
* ``flash_mha_bwd_plain`` against autograd of ``flash_mha_plain`` at every
  row for any dO, with a row of length 0 giving exactly 0.
* ``torch.autograd.gradcheck`` of ``FlashMHA`` in float64 at a small D.

The CUDA kernels' own tests are in tests/test_torch_kernels_gpu.py.
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
ATOL = 1e-5
SCALE = 128 ** -0.5


def _inputs(t: int, lens, seed: int, d: int = 128, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b = len(lens)
    q, k, v, dout = (rng.normal(size=(b, 2, t, d)).astype(dtype)
                     for _ in range(4))
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return q, k, v, dout, mask


def _port_grads(q, k, v, dout, mask, scale=SCALE):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fm.flash_mha(tq, tk, tv, torch.from_numpy(mask), scale)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), \
        tv.grad.numpy()


@pytest.mark.parametrize("t,lens", [(256, (256, 100)), (640, (640, 333))])
def test_grads_match_jax_flash_kernel_vjp(t, lens):
    q, k, v, dout, mask = _inputs(t, lens, seed=t)
    dout[mask[:, None, :, None].repeat(2, 1).repeat(128, 3)] = 0.0

    def loss(q, k, v):
        out = jax_flash_mha(q, k, v, jnp.asarray(mask), SCALE)
        return jnp.sum(out * jnp.asarray(dout))

    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))]
    _, dq, dk, dv = _port_grads(q, k, v, dout, mask)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(dq[i, :, :n], ref[0][i, :, :n], atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(dk, ref[1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(dv, ref[2], atol=ATOL, rtol=0)
    assert np.abs(dk).max() > 1e-2 and np.abs(dq).max() > 1e-2


def test_bwd_plain_matches_autograd_of_plain_at_every_row():
    lens = (77, 0, 5)
    q, k, v, dout, mask = _inputs(77, lens, seed=1)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    out = fm.flash_mha_plain(tq, tk, tv, tmask, SCALE)
    ref = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    grads = fm.flash_mha_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                   tmask, out.detach(),
                                   torch.from_numpy(dout), SCALE)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, atol=ATOL, rtol=0)
    for g in grads:  # the row of length 0: no valid key, exactly 0
        assert torch.count_nonzero(g[1]) == 0
    # Padded keys get no dk or dv.
    assert torch.count_nonzero(grads[1][2, :, 5:]) == 0
    assert torch.count_nonzero(grads[2][2, :, 5:]) == 0
    assert grads[0].abs().max() > 0.1


def test_flash_mha_cpu_gradient_is_the_plain_backward():
    lens = (40, 9)
    q, k, v, dout, mask = _inputs(40, lens, seed=2)
    before = (fm.launch_count, fm.bwd_dq_launch_count,
              fm.bwd_dkv_launch_count)
    out, dq, dk, dv = _port_grads(q, k, v, dout, mask)
    assert (fm.launch_count, fm.bwd_dq_launch_count,
            fm.bwd_dkv_launch_count) == before
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tmask = torch.from_numpy(mask)
    ref = fm.flash_mha_bwd_plain(*args, tmask, torch.from_numpy(out),
                                 torch.from_numpy(dout), SCALE)
    for g, r in zip((dq, dk, dv), ref):
        np.testing.assert_array_equal(g, r.numpy())


def test_gradcheck_float64_small_head_dim():
    lens = (7, 3, 0)
    q, k, v, _, mask = _inputs(7, lens, seed=3, d=8, dtype=np.float64)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: fm.FlashMHA.apply(q, k, v, torch.from_numpy(mask),
                                          0.35),
        args, eps=1e-6, atol=1e-7)


def test_lse_plain_is_logsumexp_with_inf_for_rows_without_keys():
    lens = (9, 0)
    q, k, _, _, mask = _inputs(9, lens, seed=4)
    tq, tk, tmask = (torch.from_numpy(a) for a in (q, k, mask))
    lse = fm.flash_mha_lse_plain(tq, tk, tmask, SCALE)
    scores = torch.matmul(tq, tk.transpose(-1, -2)) * SCALE
    ref = torch.logsumexp(scores, dim=-1)
    torch.testing.assert_close(lse[0], ref[0], atol=1e-6, rtol=0)
    assert torch.isposinf(lse[1]).all()
