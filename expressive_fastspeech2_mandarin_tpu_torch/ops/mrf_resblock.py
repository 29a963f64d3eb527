"""HiFi-GAN MRF resblock: the CUDA kernel's wrapper and its plain version.

Replaces ``expressive_fastspeech2_mandarin_tpu/ops/pallas/mrf_resblock.py``
(``resblock_fused``, the Pallas TPU kernel). A resblock is, for each
dilation d::

    x = cast(f32(conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))) + f32(x))

with leaky-ReLU slope 0.1, 'same' zero padding for every conv, float32
accumulation and bias, every conv output stored in the working type
(float32 or bfloat16) and the residual sum taken in float32.

On a CUDA tensor ``mrf_resblock`` launches a kernel of
``csrc/mrf_resblock.cu`` once per conv (six launches per resblock, each
counted in ``launch_count``), both on the tensor cores: bfloat16 goes to
the bf16 kernel (counted in ``tc_launch_count``) with its weights packed by
``pack_mrf_weights``, float32 to the float32 kernel (counted in
``f32_launch_count``), which keeps float32 accuracy with three TF32
products a product and its weights packed and split by
``pack_mrf_weights_tf32``, whatever PyTorch's TF32 switches say. On a CPU
tensor it runs ``mrf_resblock_plain``, the same function written with
``F.conv1d``. Nothing else selects between them.

The kernels are built for C a multiple of 32, with the taps unrolled for
K in ``KERNEL_SIZES`` and read at run time for any other odd K;
``pad_resblock`` zero-pads any other C and an odd K below 11 to those
widths (exactly: the padded taps and channels contribute zeros, and the
padded lanes of the result are 0), and the wrapper slices the result back.
A halo (K - 1) * d too wide for a block's shared memory is refused with a
``RuntimeError``: the float32 kernel takes (K - 1) * d up to 650 at
C % 128 == 0, 714 at C = 64 and 746 at C = 32 (at d = 5, K up to 131,
143 and 149), the bf16 kernel K up to 105 at d = 5.
The kernels have no backward: on a CUDA tensor with a gradient wanted the
wrapper raises rather than return a result cut off from autograd (the
vocoder trainer runs the generator's plain path, ``Generator(fast=False)``,
as the JAX package's trainer does).

The note at the top of the CUDA source says what bounds the kernels and
what their design does about it.

Weights are a sequence of ``2 * len(dilations)`` ``(weight, bias)`` pairs,
``conv1_0, conv2_0, conv1_1, conv2_1, ...``, each weight in
``torch.nn.Conv1d`` layout ``(C, C, K)``.
"""

from __future__ import annotations

import ctypes
import weakref
from collections.abc import Sequence

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
KERNEL_SIZES = (3, 7, 11)

# Kernel launches made by ``mrf_resblock`` on CUDA tensors: all of them, the
# bfloat16 kernel's and the float32 kernel's.
launch_count = 0
tc_launch_count = 0
f32_launch_count = 0
# Their names, for what counts launches in bulk (``graphs``' replays).
COUNTERS = ("launch_count", "tc_launch_count", "f32_launch_count")

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_lib = None


def _conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                dilation: int) -> torch.Tensor:
    """(B, C, T): lrelu in the working type, conv in float32, stored back in
    the working type."""
    act = F.leaky_relu(x, LRELU_SLOPE)
    k = weight.shape[-1]
    y = F.conv1d(act.float(), weight.float(), bias.float(),
                 padding=(k - 1) // 2 * dilation, dilation=dilation)
    return y.to(x.dtype)


def mrf_resblock_plain(x: torch.Tensor,
                       weights: Sequence[tuple[torch.Tensor, torch.Tensor]],
                       kernel_size: int,
                       dilations: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch resblock on (B, T, C); the kernel's reference."""
    _check(x, weights, kernel_size, dilations)
    h = x.transpose(1, 2)
    for i, d in enumerate(dilations):
        (w1, b1), (w2, b2) = weights[2 * i], weights[2 * i + 1]
        xt = _conv_plain(_conv_plain(h, w1, b1, d), w2, b2, 1)
        h = (xt.float() + h.float()).to(x.dtype)
    return h.transpose(1, 2).contiguous()


def _check(x, weights, kernel_size, dilations) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if len(weights) != 2 * len(dilations):
        raise ValueError(f"expected {2 * len(dilations)} (weight, bias) "
                         f"pairs, got {len(weights)}")
    for w, b in weights:
        if tuple(w.shape) != (c, c, kernel_size) or tuple(b.shape) != (c,):
            raise ValueError(
                f"conv weight {tuple(w.shape)} / bias {tuple(b.shape)} do "
                f"not fit C={c}, K={kernel_size}")


def padded_kernel_size(kernel_size: int) -> int:
    """The kernel size the CUDA kernels run an odd K at: the smallest of
    ``KERNEL_SIZES`` not below it, or K itself past the last (the kernels'
    run-time tap count)."""
    if kernel_size < 1 or kernel_size % 2 == 0:
        raise ValueError(f"mrf_resblock takes an odd K ('same' padding), "
                         f"got K={kernel_size}")
    return next((k for k in KERNEL_SIZES if k >= kernel_size), kernel_size)


def pad_resblock(x: torch.Tensor,
                 weights: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 kernel_size: int):
    """(x, weights, K) zero-padded to the widths the kernels are built for:
    C to the next multiple of 32 (x's and every bias's lanes, both weight
    dims), K to ``padded_kernel_size`` with the taps centred (the 'same'
    padding grows with K, so every output sees the same inputs). The
    resblock of the padded arguments equals the original in its first C
    lanes, exactly, and is 0 in the rest. Returns the arguments themselves
    when nothing needs padding."""
    c = x.shape[-1]
    k = padded_kernel_size(kernel_size)
    dc, side = -c % 32, (k - kernel_size) // 2
    if dc == 0 and side == 0:
        return x, list(weights), kernel_size
    x = F.pad(x, (0, dc))
    weights = [(F.pad(w, (side, side, 0, dc, 0, dc)), F.pad(b, (0, dc)))
               for w, b in weights]
    return x, weights, k


def mrf_tiles(channels: int) -> tuple[int, int]:
    """(BN, KC) of the bf16 kernel for C channels: output channels per
    block and input channels per chunk (as ``csrc/mrf_resblock.cu`` picks
    them). The float32 kernel takes the same BN; its KC follows the halo."""
    bn = 128 if channels % 128 == 0 else 64 if channels % 64 == 0 else 32
    return bn, 64 if channels % 64 == 0 else 32


def pack_mrf_weights(weight: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(C_out, C_in, K) conv weight → the image the tensor-core kernel's
    wgmma B descriptor reads (bf16 for the kernel): one contiguous slab per
    (N tile, C_in chunk, tap), each slab (KC/8, BN, 8), so that
    ``packed[nt, kc, j, g, n, e] = weight[nt*BN + n, kc*KC + 8*g + e, j]``."""
    c_out, c_in, k = weight.shape
    bn, kc = mrf_tiles(c_out)
    w = weight.detach().to(dtype)
    w = w.reshape(c_out // bn, bn, c_in // kc, kc // 8, 8, k)
    return w.permute(0, 2, 5, 3, 1, 4).contiguous()


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as a float32 whose low 13 bits are zero: the bit
    arithmetic of ``csrc/tf32_wgmma.cuh:tf32_rna``."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 → (hi, lo), hi = rna(t), lo = rna(t - hi) (``t - hi`` is
    exact): hi + lo is within 2^-21 of t, relative."""
    hi = tf32_rna(t)
    return hi, tf32_rna(t - hi)


def pack_mrf_weights_tf32(weight: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, K) float32 conv weight → the image the float32 kernel's
    wgmma B descriptors read: its TF32 parts (``split_tf32``) laid out as
    ``(C_out/BN, K, 2, C_in/4, BN, 4)``, ``packed[nt, j, p, g, n, e]`` =
    part p (0 hi, 1 lo) of ``weight[nt*BN + n, 4*g + e, j]``. Every (N tile,
    tap, part) is [channel group of 4][output channel][4] float32, so the
    slab of any chunk of KC input channels is contiguous whatever KC the
    kernel takes."""
    c_out, c_in, k = weight.shape
    bn, _ = mrf_tiles(c_out)
    parts = torch.stack(split_tf32(weight.detach().float()))
    parts = parts.reshape(2, c_out // bn, bn, c_in // 4, 4, k)
    return parts.permute(1, 5, 0, 3, 2, 4).contiguous()


# id(weight) → (weakref to it, its _version, its packed image). An entry is
# dropped when its tensor dies and replaced when the tensor is written in
# place (its version moves).
_packed: dict[int, tuple[weakref.ref, int, torch.Tensor]] = {}


def packed_weights(weight: torch.Tensor) -> torch.Tensor:
    """The image the kernel of ``weight``'s dtype reads, packed once per
    tensor and version: ``pack_mrf_weights_tf32(weight)`` for float32,
    ``pack_mrf_weights(weight)`` for bfloat16. Inference tensors carry no
    version counter and are packed every call."""
    pack = (pack_mrf_weights_tf32 if weight.dtype == torch.float32
            else pack_mrf_weights)
    if weight.is_inference():
        return pack(weight)
    key = id(weight)
    hit = _packed.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == weight._version:
        return hit[2]
    packed = pack(weight)
    ref = weakref.ref(weight, lambda _, key=key: _packed.pop(key, None))
    _packed[key] = (ref, weight._version, packed)
    return packed


def _library():
    global _lib
    if _lib is None:
        from ..kernels.build import load

        lib = load("mrf_resblock")
        for fn in (lib.mrf_conv_f32, lib.mrf_conv_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(lib, x, weight, bias, res, out, kernel_size, dilation, stream):
    global launch_count, tc_launch_count, f32_launch_count
    b, t, c = x.shape
    tc = x.dtype == torch.bfloat16
    fn = lib.mrf_conv_bf16 if tc else lib.mrf_conv_f32
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             None if res is None else res.data_ptr(), out.data_ptr(),
             b, t, c, kernel_size, dilation, stream)
    if err != 0:
        # 1 is cudaErrorInvalidValue: a launch the kernel refuses, e.g. a
        # halo (K - 1) * d too wide for its shared memory.
        raise RuntimeError(f"mrf_conv launch failed: CUDA error {err} "
                           f"(C={c}, K={kernel_size}, dilation={dilation})")
    launch_count += 1
    if tc:
        tc_launch_count += 1
    else:
        f32_launch_count += 1


def _mrf_resblock_cuda(x, weights, kernel_size, dilations):
    _check(x, weights, kernel_size, dilations)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mrf_resblock kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    for w, b in weights:
        for p in (w, b):
            if p.device != x.device or p.dtype != x.dtype:
                raise TypeError("weights must be on x's device in x's dtype")
            if not p.is_contiguous():
                raise ValueError("weights must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for pair in weights for p in pair)):
        raise RuntimeError(
            "mrf_resblock's CUDA kernel has no backward: call it under "
            "torch.no_grad() or torch.inference_mode(), or run the "
            "generator's plain path (Generator.forward(mel, fast=False)), "
            "as vocoder training does")
    c = x.shape[-1]
    x, weights, kernel_size = pad_resblock(x, weights, kernel_size)
    lib = _library()
    weights = [(packed_weights(w), b) for w, b in weights]
    x = x.contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        state = x
        for i, d in enumerate(dilations):
            (w1, b1), (w2, b2) = weights[2 * i], weights[2 * i + 1]
            h = torch.empty_like(state)
            _launch(lib, state, w1, b1, None, h, kernel_size, d, stream)
            out = torch.empty_like(state)
            _launch(lib, h, w2, b2, state, out, kernel_size, 1, stream)
            state = out
    return state if state.shape[-1] == c else state[..., :c].contiguous()


def mrf_resblock(x: torch.Tensor,
                 weights: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 kernel_size: int, dilations: Sequence[int]) -> torch.Tensor:
    """One MRF resblock on (B, T, C). CUDA tensors go through the kernel
    (or raise); CPU tensors through the plain version."""
    if x.device.type == "cuda":
        return _mrf_resblock_cuda(x, weights, kernel_size, dilations)
    if x.device.type == "cpu":
        return mrf_resblock_plain(x, weights, kernel_size, dilations)
    raise ValueError(f"mrf_resblock runs on cuda or cpu, not {x.device}")
