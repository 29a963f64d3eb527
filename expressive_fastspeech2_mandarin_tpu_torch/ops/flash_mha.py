"""Masked multi-head attention, forward and backward: the CUDA kernels'
wrappers and their plain versions.

Replaces ``expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py``
(``flash_mha``, which wraps JAX's stock TPU Pallas flash attention and its
custom VJP). On (B, H, T, D) q, k, v and a (B, T) ``key_padding_mask``,
True at padded keys::

    out = softmax(q kᵀ · sm_scale, padded keys at -inf) v

with the scores and the softmax in float32 and 0 for a row whose keys are
all padded (the JAX package's math path, ``ops/attention.py:64-80``). The
gradient, with P the probabilities and dO the output's gradient::

    Δ  = rowsum(dO ∘ out)
    dS = P ∘ (dO vᵀ − Δ)
    dq = dS k · sm_scale,  dk = dSᵀ q · sm_scale,  dv = Pᵀ dO

On CUDA tensors ``flash_mha`` launches ``csrc/flash_mha.cu`` (counted in
``launch_count``); when a gradient is wanted it goes through ``FlashMHA``,
whose forward also stores each row's log-sum-exp and whose backward
launches the dQ kernel (which also writes Δ) and then the dK/dV kernel of
``csrc/flash_mha_bwd.cu`` (counted in ``bwd_dq_launch_count`` and
``bwd_dkv_launch_count``). The kernels take float32, D = 128, contiguous
tensors and a bool mask on the same device, or raise. On CPU tensors the
plain versions run: ``flash_mha_plain`` forward, ``flash_mha_bwd_plain``
backward. Nothing else selects between the two. The kernels mask keys only,
so they equal the plain versions at every query row; the TPU kernel agrees
with both at the valid rows (its segment IDs let padded queries attend to
padded keys, and the FFT block zeroes those rows and their gradients).
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIM = 128
# As in the JAX package (flash_mha.py:supported), the kernel is taken past
# the reference's 2000-frame cap.
MIN_SEQ_LEN = 2048

# Kernel launches on CUDA tensors: the forward, the dQ kernel (with Δ) and
# the dK/dV kernel.
launch_count = 0
bwd_dq_launch_count = 0
bwd_dkv_launch_count = 0

# flash_mha_fwd_f32(q, k, v, mask, out, lse, B, H, T, scale, stream)
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_void_p])
# flash_mha_bwd_dq_f32(q, k, v, mask, out, dout, lse, delta, dq, B, H, T,
#                      scale, stream) and
# flash_mha_bwd_dkv_f32(q, k, v, mask, dout, lse, delta, dk, dv, B, H, T,
#                       scale, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_void_p])
_libs: dict[str, ctypes.CDLL] = {}


def supported(device: torch.device, seq_len: int, head_dim: int) -> bool:
    """Whether ``attention_impl="auto"`` takes the kernel: on the card, with
    the head dim the kernel takes (128), for sequences past 2048. Any other
    head dim stays on the math path, where the JAX package's TPU kernel
    would also take multiples of 128."""
    return (device.type == "cuda" and head_dim == HEAD_DIM
            and seq_len > MIN_SEQ_LEN)


def masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis; rows that are all ``-inf`` → 0."""
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    return e / torch.where(s == 0.0, torch.ones_like(s), s)


def _probabilities(q, k, key_padding_mask, sm_scale, dt):
    scores = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) * sm_scale
    scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                float("-inf"))
    return masked_softmax(scores)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Plain PyTorch attention on (B, H, T, D), the forward kernel's
    reference: float32 scores (float64 for float64 inputs), ``-inf`` at
    padded keys, the probabilities cast to v's dtype before the second
    product."""
    dt = torch.promote_types(q.dtype, torch.float32)
    attn = _probabilities(q, k, key_padding_mask, sm_scale, dt)
    return torch.matmul(attn.to(v.dtype).to(dt), v.to(dt))


def flash_mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_padding_mask: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, sm_scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_mha_plain`` by the explicit formulas, the
    backward kernels' reference, in float32 (float64 for float64 inputs);
    ``out`` is the forward's output. Rows with no valid key, and padded
    keys, get exactly 0."""
    dt = torch.promote_types(q.dtype, torch.float32)
    q, k, v, out, dout = (x.to(dt) for x in (q, k, v, out, dout))
    p = _probabilities(q, k, key_padding_mask, sm_scale, dt)
    dv = torch.matmul(p.transpose(-1, -2), dout)
    dp = torch.matmul(dout, v.transpose(-1, -2))
    delta = (dout * out).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * sm_scale
    return dq, dk, dv


def flash_mha_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        key_padding_mask: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """(B, H, T) log-sum-exp of the masked scaled scores, as the forward
    kernel stores it: ``torch.logsumexp``, and +inf (the kernel's
    sentinel, which makes every recomputed probability 0) for a row with
    no valid key."""
    dt = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) * sm_scale
    scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    return lse.masked_fill(torch.isneginf(lse), float("inf"))


def _library(name: str, fns: dict[str, list]) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        from ..kernels.build import load

        lib = load(name)
        for fn, argtypes in fns.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _check(q, k, v, key_padding_mask, *more):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_mha kernels take D = {HEAD_DIM}, got {d}")
    for x in (q, k, v, *more):
        if x.dtype != torch.float32:
            raise TypeError(f"flash_mha kernels take float32, got {x.dtype}")
        if x.shape != q.shape or x.device != q.device:
            raise ValueError("q, k, v, out and dout must share one shape "
                             "and device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("q, k, v, out and dout must be contiguous and "
                             "16-byte aligned")
    m = key_padding_mask
    if m.dtype != torch.bool or tuple(m.shape) != (b, t):
        raise ValueError(f"key_padding_mask must be bool (B, T) = {(b, t)}, "
                         f"got {m.dtype} {tuple(m.shape)}")
    if m.device != q.device or not m.is_contiguous():
        raise ValueError("key_padding_mask must be contiguous on q's device")
    return b, h, t


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _flash_mha_cuda(q, k, v, key_padding_mask, sm_scale, with_lse):
    """The forward kernel: (out, lse), lse (B, H, T) float32 or None."""
    b, h, t = _check(q, k, v, key_padding_mask)
    out = torch.empty_like(q)
    lse = q.new_empty((b, h, t)) if with_lse else None
    if out.numel() == 0:
        return out, lse
    lib = _library("flash_mha", {"flash_mha_fwd_f32": _FWD_ARGTYPES})
    with torch.cuda.device(q.device):
        err = lib.flash_mha_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_padding_mask.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, h, t, float(sm_scale),
            _stream(q))
    _raise_on(err, "flash_mha forward")
    global launch_count
    launch_count += 1
    return out, lse


def _bwd_library() -> ctypes.CDLL:
    return _library("flash_mha_bwd", {"flash_mha_bwd_dq_f32": _BWD_ARGTYPES,
                                      "flash_mha_bwd_dkv_f32": _BWD_ARGTYPES})


def _flash_mha_bwd_dq_cuda(q, k, v, key_padding_mask, out, dout, lse,
                           sm_scale):
    """The dQ kernel: (dq, delta), delta = rowsum(dout ∘ out) (B, H, T)."""
    b, h, t = _check(q, k, v, key_padding_mask, out, dout)
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError("lse must be (B, H, T) float32")
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    if dq.numel() == 0:
        return dq, delta
    with torch.cuda.device(q.device):
        err = _bwd_library().flash_mha_bwd_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_padding_mask.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, t,
            float(sm_scale), _stream(q))
    _raise_on(err, "flash_mha backward dQ")
    global bwd_dq_launch_count
    bwd_dq_launch_count += 1
    return dq, delta


def _flash_mha_bwd_dkv_cuda(q, k, v, key_padding_mask, dout, lse, delta,
                            sm_scale):
    """The dK/dV kernel, after the dQ kernel wrote ``delta``: (dk, dv)."""
    b, h, t = _check(q, k, v, key_padding_mask, dout)
    for x in (lse, delta):
        if x.shape != (b, h, t) or x.dtype != torch.float32:
            raise ValueError("lse and delta must be (B, H, T) float32")
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if dk.numel() == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        err = _bwd_library().flash_mha_bwd_dkv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_padding_mask.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t,
            float(sm_scale), _stream(q))
    _raise_on(err, "flash_mha backward dK/dV")
    global bwd_dkv_launch_count
    bwd_dkv_launch_count += 1
    return dk, dv


def _flash_mha_bwd_cuda(q, k, v, key_padding_mask, out, dout, lse, sm_scale):
    """The backward kernels in order: (dq, dk, dv)."""
    dq, delta = _flash_mha_bwd_dq_cuda(q, k, v, key_padding_mask, out, dout,
                                       lse, sm_scale)
    dk, dv = _flash_mha_bwd_dkv_cuda(q, k, v, key_padding_mask, dout, lse,
                                     delta, sm_scale)
    return dq, dk, dv


def _device_type(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_mha runs on cuda or cpu, not {q.device}")
    return q.device.type


class FlashMHA(torch.autograd.Function):
    """Differentiable ``flash_mha``: kernels on CUDA tensors, the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, sm_scale):
        if _device_type(q) == "cuda":
            out, lse = _flash_mha_cuda(q, k, v, key_padding_mask, sm_scale,
                                       with_lse=True)
        else:
            out = flash_mha_plain(q, k, v, key_padding_mask, sm_scale)
            lse = None
        ctx.sm_scale = sm_scale
        ctx.lse = lse
        ctx.save_for_backward(q, k, v, key_padding_mask, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_padding_mask, out = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = _flash_mha_bwd_cuda(q, k, v, key_padding_mask, out,
                                        dout.contiguous(), ctx.lse,
                                        ctx.sm_scale)
        else:
            grads = flash_mha_bwd_plain(q, k, v, key_padding_mask, out, dout,
                                        ctx.sm_scale)
        dq, dk, dv = (g.to(x.dtype) for g, x in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_padding_mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Attention on (B, H, T, D) with a (B, T) key mask, True at padding.
    CUDA tensors go through the kernels (or raise); CPU tensors through the
    plain versions. When q, k or v needs a gradient, through ``FlashMHA``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashMHA.apply(q, k, v, key_padding_mask, sm_scale)
    if _device_type(q) == "cuda":
        return _flash_mha_cuda(q, k, v, key_padding_mask, sm_scale,
                               with_lse=False)[0]
    return flash_mha_plain(q, k, v, key_padding_mask, sm_scale)
