"""Masked multi-head attention forward: the CUDA kernel's wrapper and its
plain version.

Replaces ``expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py``
(``flash_mha``, which wraps JAX's stock TPU Pallas flash attention). On
(B, H, T, D) q, k, v and a (B, T) ``key_padding_mask``, True at padded
keys::

    out = softmax(q kᵀ · sm_scale, padded keys at -inf) v

with the scores and the softmax in float32 and 0 for a row whose keys are
all padded (the JAX package's math path, ``ops/attention.py:64-80``).

On a CUDA tensor ``flash_mha`` launches ``csrc/flash_mha.cu`` (counted in
``launch_count``) or raises: it takes float32, D = 128, contiguous q, k, v
and a bool mask on the same device. On a CPU tensor it runs
``flash_mha_plain``. Nothing else selects between the two. The kernel masks
keys only, so it equals the plain version at every query row; the TPU
kernel agrees with both at the valid rows (its segment IDs let padded
queries attend to padded keys, and the FFT block zeroes those rows).
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIM = 128
# As in the JAX package (flash_mha.py:supported), the kernel is taken past
# the reference's 2000-frame cap.
MIN_SEQ_LEN = 2048

# Kernel launches made by ``flash_mha`` on CUDA tensors.
launch_count = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])
_lib = None


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


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Plain PyTorch attention on (B, H, T, D), the kernel's reference:
    float32 scores (float64 for float64 inputs), ``-inf`` at padded keys,
    the probabilities cast to v's dtype before the second product."""
    dt = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) * sm_scale
    scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                float("-inf"))
    attn = masked_softmax(scores)
    return torch.matmul(attn.to(v.dtype).to(dt), v.to(dt))


def _library():
    global _lib
    if _lib is None:
        from ..kernels.build import load

        lib = load("flash_mha")
        lib.flash_mha_fwd_f32.argtypes = _ARGTYPES
        lib.flash_mha_fwd_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _flash_mha_cuda(q, k, v, key_padding_mask, sm_scale):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_mha kernel takes D = {HEAD_DIM}, got {d}")
    for x in (q, k, v):
        if x.dtype != torch.float32:
            raise TypeError(f"flash_mha kernel takes float32, got {x.dtype}")
        if x.device != q.device:
            raise ValueError("q, k and v must be on one device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("q, k and v must be contiguous and 16-byte "
                             "aligned")
    m = key_padding_mask
    if m.dtype != torch.bool or tuple(m.shape) != (b, t):
        raise ValueError(f"key_padding_mask must be bool (B, T) = {(b, t)}, "
                         f"got {m.dtype} {tuple(m.shape)}")
    if m.device != q.device or not m.is_contiguous():
        raise ValueError("key_padding_mask must be contiguous on q's device")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_mha_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    m.data_ptr(), out.data_ptr(), b, h, t,
                                    float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_mha launch failed: CUDA error {err}")
    global launch_count
    launch_count += 1
    return out


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_padding_mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Attention on (B, H, T, D) with a (B, T) key mask, True at padding.
    CUDA tensors go through the kernel (or raise); CPU tensors through the
    plain version."""
    if q.device.type == "cuda":
        return _flash_mha_cuda(q, k, v, key_padding_mask, sm_scale)
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, key_padding_mask, sm_scale)
    raise ValueError(f"flash_mha runs on cuda or cpu, not {q.device}")
