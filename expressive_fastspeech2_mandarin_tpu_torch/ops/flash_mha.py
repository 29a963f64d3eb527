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

On CUDA tensors ``flash_mha`` launches the forward kernel of the inputs'
dtype and head dim: at D = 128 ``csrc/flash_mha.cu`` for float32 (counted
in ``launch_count``), ``csrc/flash_mha_bf16.cu`` for bfloat16
(``bf16_launch_count``); at D = 256 ``csrc/flash_mha_d256.cu`` for float32
(``d256_launch_count``), ``csrc/flash_mha_bf16_d256.cu`` for bfloat16
(``bf16_d256_launch_count``). When a gradient is wanted it goes through
``FlashMHA``, whose forward also stores each row's float32 log-sum-exp and
whose backward launches the dQ kernel (which also writes Δ in float32) and
then the dK/dV kernel of the same dtype and head dim: ``csrc/flash_mha_bwd.cu``
(``bwd_dq_launch_count``, ``bwd_dkv_launch_count``),
``csrc/flash_mha_bwd_bf16.cu`` (``bf16_bwd_dq_launch_count``,
``bf16_bwd_dkv_launch_count``), ``csrc/flash_mha_bwd_d256.cu``
(``d256_bwd_dq_launch_count``, ``d256_bwd_dkv_launch_count``) or
``csrc/flash_mha_bf16_d256.cu`` (``bf16_d256_bwd_dq_launch_count``,
``bf16_d256_bwd_dkv_launch_count``). A head dim under 128 goes to the
D = 128 kernels of its dtype zero-padded to 128, and out, dq, dk and dv are
sliced back (``through_padding``): exact, since zero columns add nothing to
q kᵀ or dO vᵀ and the padded columns of every output are zero. So the
kernels take float32 and bfloat16 at D ≤ 128 and D = 256, contiguous
tensors and a bool mask on the same device, or raise: every other head dim
(the JAX package's TPU kernel also takes the other multiples of 128) has no
kernel yet. The bf16 kernels round where the TPU kernel rounds in bf16: the
unnormalised P of each key tile to bf16 before P·V, Pᵀ and dS·sm_scale to
bf16 before their products, the outputs stored in bf16, everything else
float32. On CPU tensors the plain versions run: the forward
``flash_mha_plain`` (float32 and float64) or, for bf16,
``flash_mha_blocked_plain`` on the TPU kernel's 128-key blocks; the
backward ``flash_mha_bwd_plain``, with the
same rounding points for bf16 inputs. Nothing else selects between kernel
and plain version. The kernels mask keys only, so they equal the plain
versions at every query row; the TPU kernel agrees with both at the valid
rows (its segment IDs let padded queries attend to padded keys, and the
FFT block zeroes those rows and their gradients).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# The tensor-core kernels' head dim; a head dim under it is zero-padded to it.
HEAD_DIM = 128
# The head dim of csrc/flash_mha_d256.cu (the float32 forward),
# csrc/flash_mha_bwd_d256.cu (the float32 backward) and
# csrc/flash_mha_bf16_d256.cu (bfloat16), all on the tensor cores.
WIDE_HEAD_DIM = 256
# As in the JAX package (flash_mha.py:supported), the kernel is taken past
# the reference's 2000-frame cap.
MIN_SEQ_LEN = 2048
# Key block of the JAX package's TPU kernel (ops/pallas/flash_mha.py:_BLOCK),
# where it rounds the unnormalised probabilities in bf16.
JAX_BLOCK = 128

# Kernel launches on CUDA tensors: the forward, the dQ kernel (with Δ) and
# the dK/dV kernel, float32 and bfloat16 at D = 128, float32 and bfloat16 at
# D = 256.
launch_count = 0
bwd_dq_launch_count = 0
bwd_dkv_launch_count = 0
bf16_launch_count = 0
bf16_bwd_dq_launch_count = 0
bf16_bwd_dkv_launch_count = 0
d256_launch_count = 0
d256_bwd_dq_launch_count = 0
d256_bwd_dkv_launch_count = 0
bf16_d256_launch_count = 0
bf16_d256_bwd_dq_launch_count = 0
bf16_d256_bwd_dkv_launch_count = 0
# Their names, for what counts launches in bulk (``graphs``' replays).
COUNTERS = ("launch_count", "bwd_dq_launch_count", "bwd_dkv_launch_count",
            "bf16_launch_count", "bf16_bwd_dq_launch_count",
            "bf16_bwd_dkv_launch_count", "d256_launch_count",
            "d256_bwd_dq_launch_count", "d256_bwd_dkv_launch_count",
            "bf16_d256_launch_count", "bf16_d256_bwd_dq_launch_count",
            "bf16_d256_bwd_dkv_launch_count")

# The kernels by (dtype, head dim): the sources of the forward and of the
# backward pair (csrc/<name>.cu), the suffix of their C entries
# flash_mha_fwd_<suffix>, flash_mha_bwd_{dq,dkv}_<suffix>, and the
# counters of the forward, dQ and dK/dV launches.
_KERNELS = {
    (torch.float32, HEAD_DIM): ("flash_mha", "flash_mha_bwd", "f32",
                                COUNTERS[0:3]),
    (torch.bfloat16, HEAD_DIM): ("flash_mha_bf16", "flash_mha_bwd_bf16",
                                 "bf16", COUNTERS[3:6]),
    (torch.float32, WIDE_HEAD_DIM): ("flash_mha_d256", "flash_mha_bwd_d256",
                                     "f32_d256", COUNTERS[6:9]),
    (torch.bfloat16, WIDE_HEAD_DIM): ("flash_mha_bf16_d256",
                                      "flash_mha_bf16_d256", "bf16_d256",
                                      COUNTERS[9:12]),
}
# flash_mha_fwd_<suffix>(q, k, v, mask, out, lse, B, H, T, scale, stream)
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_void_p])
# flash_mha_bwd_dq_<suffix>(q, k, v, mask, out, dout, lse, delta, dq, B, H,
#                           T, scale, stream) and
# flash_mha_bwd_dkv_<suffix>(q, k, v, mask, dout, lse, delta, dk, dv, B,
#                            H, T, scale, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_void_p])
_libs: dict[str, ctypes.CDLL] = {}


def kernel_head_dim(head_dim: int, dtype: torch.dtype) -> int | None:
    """The head dim of the kernels that take ``head_dim`` in ``dtype`` (128
    for 0 < D ≤ 128, through zero padding; 256 at D = 256), or None where no
    kernel takes it."""
    d = HEAD_DIM if 0 < head_dim <= HEAD_DIM else head_dim
    return d if (dtype, d) in _KERNELS else None


def supported(device: torch.device, seq_len: int, head_dim: int,
              dtype: torch.dtype) -> bool:
    """Whether ``attention_impl="auto"`` takes the kernels: the JAX
    package's rule (``supported`` there: a multiple of 128 as the head dim,
    sequences past 2048), with "on a TPU" read as "on the card", wherever
    the port has a kernel for that head dim and dtype: D = 128 and 256 in
    float32 and bfloat16. D = 384, 512, ... stay on the math path, where the
    JAX package's TPU kernel would take them; D < 128 stays there as in the
    JAX package."""
    return (device.type == "cuda" and head_dim % HEAD_DIM == 0
            and seq_len > MIN_SEQ_LEN
            and kernel_head_dim(head_dim, dtype) == head_dim)


def through_padding(fn, *args):
    """``fn(*args)`` with every (B, H, T, D) tensor of ``args`` zero-padded
    along its head dim to ``HEAD_DIM`` and every (B, H, T, ·) tensor it
    returns sliced back to D (the mask and the (B, H, T) lse and Δ pass as
    they are). Exact for attention and its gradient: the padded columns add
    0 to every dot product over the head dim, and the padded columns of out,
    dq, dk and dv are 0."""
    d = args[0].shape[-1]

    def pad(x):
        return (F.pad(x, (0, HEAD_DIM - d))
                if torch.is_tensor(x) and x.ndim == 4 else x)

    def back(x):
        return x[..., :d] if torch.is_tensor(x) and x.ndim == 4 else x

    result = fn(*(pad(a) for a in args))
    if isinstance(result, tuple):
        return tuple(back(x) for x in result)
    return back(result)


def masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis; rows that are all ``-inf`` → 0."""
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    return e / torch.where(s == 0.0, torch.ones_like(s), s)


def _scores(q, k, key_padding_mask, sm_scale, dt):
    scores = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) * sm_scale
    return scores.masked_fill(key_padding_mask[:, None, None, :],
                              float("-inf"))


def _probabilities(q, k, key_padding_mask, sm_scale, dt):
    return masked_softmax(_scores(q, k, key_padding_mask, sm_scale, dt))


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Plain PyTorch attention on (B, H, T, D), the float32 forward
    kernel's reference and the math path ("xla"): float32 scores (float64
    for float64 inputs), ``-inf`` at padded keys, the normalised
    probabilities cast to v's dtype before the second product (bf16 for
    bf16 inputs, as the JAX package's math path rounds them,
    ``ops/attention.py:69`` there), the output in the inputs' dtype."""
    dt = torch.promote_types(q.dtype, torch.float32)
    attn = _probabilities(q, k, key_padding_mask, sm_scale, dt)
    out = torch.matmul(attn.to(v.dtype).to(dt), v.to(dt))
    return out.to(q.dtype)


def flash_mha_blocked_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, key_padding_mask: torch.Tensor,
                            sm_scale: float, block: int) -> torch.Tensor:
    """Plain PyTorch attention on (B, H, T, D) as an online softmax over
    blocks of ``block`` keys, the flash kernels' bf16 reference: the TPU
    kernel's arithmetic (JAX 0.9.0 ``flash_attention.py:447-474``) in
    float32 (float64 for float64 inputs). Per block, with m the running row
    max and l the running sum::

        p = exp(s − m_next),  α = exp(m_prev − m_next),  l_next = Σp + α·l
        acc = acc · (α·l / l_next) + (p in v's dtype) v / l_next

    so p is rounded (to bf16 for bf16 inputs) before its product
    *unnormalised*, where ``flash_mha_plain`` rounds the normalised
    probabilities. A block with no valid key for a row adds nothing (on
    the TPU α clears it); a row with no valid key is 0. The output is in
    the inputs' dtype."""
    dt = torch.promote_types(q.dtype, torch.float32)
    scores = _scores(q, k, key_padding_mask, sm_scale, dt)
    v = v.to(dt)
    acc = torch.zeros(scores.shape[:-1] + (v.shape[-1],), dtype=dt,
                      device=q.device)
    m = torch.full(scores.shape[:-1] + (1,), float("-inf"), dtype=dt,
                   device=q.device)
    l = torch.zeros_like(m)
    for k0 in range(0, scores.shape[-1], block):
        s = scores[..., k0:k0 + block]
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        seen = torch.isfinite(m_next)  # some valid key so far
        shift = torch.where(seen, m_next, torch.zeros_like(m_next))
        p = torch.exp(s - shift)
        alpha = torch.where(seen, torch.exp(m - shift), torch.zeros_like(m))
        l_corr = alpha * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, torch.ones_like(l_next),
                          1.0 / l_next)
        o = torch.matmul(p.to(q.dtype).to(dt), v[..., k0:k0 + block, :])
        acc = acc * (l_corr * inv) + o * inv
        m, l = m_next, l_next
    return acc.to(q.dtype)


def flash_mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_padding_mask: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, sm_scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_mha_plain`` by the explicit formulas, the
    backward kernels' reference, in float32 (float64 for float64 inputs);
    ``out`` is the forward's output. Rows with no valid key, and padded
    keys, get exactly 0. For bf16 inputs it rounds where the TPU kernel
    does (``flash_attention.py:900, :912-918, :1240-1261``): Pᵀ and
    dS·sm_scale to bf16 before their products, dq, dk, dv stored in bf16;
    P, dP, Δ and dS stay float32."""
    dt = torch.promote_types(q.dtype, torch.float32)
    low = q.dtype if q.dtype == torch.bfloat16 else None
    q, k, v, out, dout = (x.to(dt) for x in (q, k, v, out, dout))
    p = _probabilities(q, k, key_padding_mask, sm_scale, dt)
    dp = torch.matmul(dout, v.transpose(-1, -2))
    delta = (dout * out).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if low is None:
        dv = torch.matmul(p.transpose(-1, -2), dout)
        dq = torch.matmul(ds, k) * sm_scale
        dk = torch.matmul(ds.transpose(-1, -2), q) * sm_scale
        return dq, dk, dv
    p, ds = (x.to(low).to(dt) for x in (p, ds * sm_scale))
    dv = torch.matmul(p.transpose(-1, -2), dout)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq.to(low), dk.to(low), dv.to(low)


def flash_mha_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        key_padding_mask: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """(B, H, T) log-sum-exp of the masked scaled scores, as the forward
    kernel stores it: ``torch.logsumexp``, and +inf (the kernel's
    sentinel, which makes every recomputed probability 0) for a row with
    no valid key."""
    dt = torch.promote_types(q.dtype, torch.float32)
    lse = torch.logsumexp(_scores(q, k, key_padding_mask, sm_scale, dt),
                          dim=-1)
    return lse.masked_fill(torch.isneginf(lse), float("inf"))


def _entry(name: str, fn: str, argtypes: list):
    """C entry ``fn`` of the library built from ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is None:
        from ..kernels.build import load

        lib = _libs[name] = load(name)
    entry = getattr(lib, fn)
    entry.argtypes = argtypes
    entry.restype = ctypes.c_int
    return entry


def _check(q, k, v, key_padding_mask, *more):
    """The inputs' (B, H, T, D), or raise where no kernel takes them."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, t, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_mha kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if kernel_head_dim(d, q.dtype) is None:
        raise ValueError(
            f"flash_mha kernels take D <= {HEAD_DIM} and D = {WIDE_HEAD_DIM} "
            f"(float32 and bfloat16), got D = {d} in {q.dtype}; "
            f"the JAX package's TPU kernel also takes the other multiples "
            f"of {HEAD_DIM}, which have no kernel here yet")
    for x in (q, k, v, *more):
        if x.dtype != q.dtype:
            raise TypeError(f"flash_mha kernels take one dtype for q, k, v, "
                            f"out and dout, got {q.dtype} and {x.dtype}")
        if x.shape != q.shape or x.device != q.device:
            raise ValueError("q, k, v, out and dout must share one shape "
                             "and device")
        # Under 128 the padding makes contiguous copies.
        if d >= HEAD_DIM and (not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError("q, k, v, out and dout must be contiguous and "
                             "16-byte aligned")
    m = key_padding_mask
    if m.dtype != torch.bool or tuple(m.shape) != (b, t):
        raise ValueError(f"key_padding_mask must be bool (B, T) = {(b, t)}, "
                         f"got {m.dtype} {tuple(m.shape)}")
    if m.device != q.device or not m.is_contiguous():
        raise ValueError("key_padding_mask must be contiguous on q's device")
    return b, h, t, d


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _count(name: str) -> None:
    globals()[name] += 1


def _flash_mha_cuda(q, k, v, key_padding_mask, sm_scale, with_lse):
    """The forward kernel of q's dtype and head dim: (out, lse), lse
    (B, H, T) float32 or None."""
    b, h, t, d = _check(q, k, v, key_padding_mask)
    if d < HEAD_DIM:
        return through_padding(_flash_mha_cuda, q, k, v, key_padding_mask,
                               sm_scale, with_lse)
    out = torch.empty_like(q)
    lse = q.new_empty((b, h, t), dtype=torch.float32) if with_lse else None
    if out.numel() == 0:
        return out, lse
    name, _, suffix, counters = _KERNELS[(q.dtype, d)]
    with torch.cuda.device(q.device):
        err = _entry(name, f"flash_mha_fwd_{suffix}", _FWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_padding_mask.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, h, t, float(sm_scale),
            _stream(q))
    _raise_on(err, f"flash_mha forward ({suffix})")
    _count(counters[0])
    return out, lse


def _bwd_launch(kernel: str, q, args, b, h, t, sm_scale):
    """Launches backward kernel ``kernel`` ("dq" or "dkv") of q's dtype and
    head dim on the pointers ``args`` and counts it."""
    _, name, suffix, counters = _KERNELS[(q.dtype, q.shape[-1])]
    with torch.cuda.device(q.device):
        err = _entry(name, f"flash_mha_bwd_{kernel}_{suffix}", _BWD_ARGTYPES)(
            *(x.data_ptr() for x in args), b, h, t, float(sm_scale),
            _stream(q))
    what = "dQ" if kernel == "dq" else "dK/dV"
    _raise_on(err, f"flash_mha backward {what} ({suffix})")
    _count(counters[1 if kernel == "dq" else 2])


def _flash_mha_bwd_dq_cuda(q, k, v, key_padding_mask, out, dout, lse,
                           sm_scale):
    """The dQ kernel of q's dtype and head dim: (dq, delta), delta =
    rowsum(dout ∘ out) (B, H, T) float32."""
    b, h, t, d = _check(q, k, v, key_padding_mask, out, dout)
    if d < HEAD_DIM:
        return through_padding(_flash_mha_bwd_dq_cuda, q, k, v,
                               key_padding_mask, out, dout, lse, sm_scale)
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError("lse must be (B, H, T) float32")
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    if dq.numel() == 0:
        return dq, delta
    _bwd_launch("dq", q, (q, k, v, key_padding_mask, out, dout, lse, delta,
                          dq), b, h, t, sm_scale)
    return dq, delta


def _flash_mha_bwd_dkv_cuda(q, k, v, key_padding_mask, dout, lse, delta,
                            sm_scale):
    """The dK/dV kernel of q's dtype and head dim, after the dQ kernel wrote
    ``delta``: (dk, dv)."""
    b, h, t, d = _check(q, k, v, key_padding_mask, dout)
    if d < HEAD_DIM:
        return through_padding(_flash_mha_bwd_dkv_cuda, q, k, v,
                               key_padding_mask, dout, lse, delta, sm_scale)
    for x in (lse, delta):
        if x.shape != (b, h, t) or x.dtype != torch.float32:
            raise ValueError("lse and delta must be (B, H, T) float32")
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if dk.numel() == 0:
        return dk, dv
    _bwd_launch("dkv", q, (q, k, v, key_padding_mask, dout, lse, delta, dk,
                           dv), b, h, t, sm_scale)
    return dk, dv


def _flash_mha_bwd_cuda(q, k, v, key_padding_mask, out, dout, lse, sm_scale):
    """The backward kernels in order: (dq, dk, dv). A head dim under 128 is
    padded once for both."""
    if _check(q, k, v, key_padding_mask, out, dout)[3] < HEAD_DIM:
        return through_padding(_flash_mha_bwd_cuda, q, k, v,
                               key_padding_mask, out, dout, lse, sm_scale)
    dq, delta = _flash_mha_bwd_dq_cuda(q, k, v, key_padding_mask, out, dout,
                                       lse, sm_scale)
    dk, dv = _flash_mha_bwd_dkv_cuda(q, k, v, key_padding_mask, dout, lse,
                                     delta, sm_scale)
    return dq, dk, dv


def _flash_mha_cpu(q, k, v, key_padding_mask, sm_scale):
    """The CPU stand-in for the forward kernels: on bf16 inputs the blocked
    plain version on the JAX package's 128-key blocks (``flash_mha.py:22``
    there), so P is rounded where the TPU kernel rounds it; else
    ``flash_mha_plain``."""
    if q.dtype == torch.bfloat16:
        return flash_mha_blocked_plain(q, k, v, key_padding_mask, sm_scale,
                                       JAX_BLOCK)
    return flash_mha_plain(q, k, v, key_padding_mask, sm_scale)


def _device_type(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_mha runs on cuda or cpu, not {q.device}")
    return q.device.type


class FlashMHA(torch.autograd.Function):
    """Differentiable ``flash_mha``: the kernels of the inputs' dtype on
    CUDA tensors (the forward's float32 log-sum-exp carried to the
    backward), the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, sm_scale):
        if _device_type(q) == "cuda":
            out, lse = _flash_mha_cuda(q, k, v, key_padding_mask, sm_scale,
                                       with_lse=True)
        else:
            out = _flash_mha_cpu(q, k, v, key_padding_mask, sm_scale)
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
    return _flash_mha_cpu(q, k, v, key_padding_mask, sm_scale)
