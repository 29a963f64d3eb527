"""FFT-block transformer encoder and decoder.

Post-LN residual order, ``-inf`` key masking before the softmax, the padded
rows zeroed after each sublayer, sinusoidal absolute positions regrown past
``max_seq_len``; in training (a dropout generator given), dropout after the
attention's ``fc`` and after the second FFN conv. The JAX package's
``models/transformer.py``. Module and parameter names are the reference's,
so its state dicts load as they are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransformerConfig
from ..ops import conv1d, layer_norm, multi_head_attention
from ..ops.dropout import dropout


def sinusoid_encoding_table(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoidal position table (float32, computed in float64)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_k: int):
        super().__init__()
        self.n_head = n_head
        self.w_qs = nn.Linear(d_model, n_head * d_k)
        self.w_ks = nn.Linear(d_model, n_head * d_k)
        self.w_vs = nn.Linear(d_model, n_head * d_k)
        self.fc = nn.Linear(n_head * d_k, d_model)
        self.layer_norm = nn.LayerNorm(d_model)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_inner: int,
                 kernel_size: tuple[int, int]):
        super().__init__()
        self.kernel_size = kernel_size
        self.w_1 = nn.Conv1d(d_model, d_inner, kernel_size[0])
        self.w_2 = nn.Conv1d(d_inner, d_model, kernel_size[1])
        self.layer_norm = nn.LayerNorm(d_model)


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_size: tuple[int, int], attention_impl: str = "auto"):
        super().__init__()
        self.attention_impl = attention_impl
        self.slf_attn = MultiHeadAttention(d_model, n_head, d_model // n_head)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                dropout_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, D) → (B, T, D); ``pad_mask`` (B, T) True at padding. With
        a ``generator`` (training), dropout at ``dropout_rate``."""
        a = self.slf_attn
        out = multi_head_attention(
            x, a.w_qs.weight, a.w_qs.bias, a.w_ks.weight, a.w_ks.bias,
            a.w_vs.weight, a.w_vs.bias, a.n_head, pad_mask,
            impl=self.attention_impl)
        out = dropout(a.fc(out), dropout_rate, generator)
        out = layer_norm(out + x, a.layer_norm.weight, a.layer_norm.bias)
        out = out.masked_fill(pad_mask[..., None], 0.0)

        f = self.pos_ffn
        k0, k1 = f.kernel_size
        h = conv1d(out, f.w_1.weight, f.w_1.bias, padding=(k0 - 1) // 2)
        h = F.relu(h)
        h = conv1d(h, f.w_2.weight, f.w_2.bias, padding=(k1 - 1) // 2)
        h = dropout(h, dropout_rate, generator)
        h = layer_norm(h + out, f.layer_norm.weight, f.layer_norm.bias)
        return h.masked_fill(pad_mask[..., None], 0.0)


class _Stack(nn.Module):
    """Position table + FFT blocks, shared by the encoder and decoder."""

    def __init__(self, cfg: TransformerConfig, n_layer: int, d_model: int,
                 n_head: int, max_seq_len: int, dropout_rate: float):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.dropout_rate = dropout_rate
        self.d_model = d_model
        self.register_buffer(
            "position_enc",
            torch.from_numpy(sinusoid_encoding_table(max_seq_len + 1,
                                                     d_model)),
            persistent=False)
        self._regrown: torch.Tensor | None = None
        self.layer_stack = nn.ModuleList([
            FFTBlock(d_model, n_head, cfg.conv_filter_size,
                     cfg.conv_kernel_size, cfg.attention_impl)
            for _ in range(n_layer)])

    def positions(self, t: int, like: torch.Tensor) -> torch.Tensor:
        """(T, D) table in ``like``'s dtype, regrown past max_seq_len. The
        longest regrown table is kept on ``like``'s device (a row depends
        only on its position, so a shorter T takes its head)."""
        table = self.position_enc
        if t > self.max_seq_len:
            table = self._regrown
            if (table is None or table.shape[0] < t
                    or table.device != like.device):
                table = torch.from_numpy(
                    sinusoid_encoding_table(t, self.d_model)).to(like.device)
                self._regrown = table
        return table[:t].to(like.dtype)

    def run_layers(self, x: torch.Tensor, pad_mask: torch.Tensor,
                   generator: torch.Generator | None) -> torch.Tensor:
        x = x + self.positions(x.shape[1], x)[None]
        for layer in self.layer_stack:
            x = layer(x, pad_mask, self.dropout_rate, generator)
        return x


class Encoder(_Stack):
    def __init__(self, cfg: TransformerConfig, vocab_size: int,
                 max_seq_len: int):
        super().__init__(cfg, cfg.encoder_layer, cfg.encoder_hidden,
                         cfg.encoder_head, max_seq_len, cfg.encoder_dropout)
        self.src_word_emb = nn.Embedding(vocab_size, cfg.encoder_hidden,
                                         padding_idx=0)

    def forward(self, texts: torch.Tensor, pad_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, S) phoneme IDs → (B, S, D)."""
        return self.run_layers(self.src_word_emb(texts), pad_mask, generator)


class Decoder(_Stack):
    def __init__(self, cfg: TransformerConfig, max_seq_len: int):
        super().__init__(cfg, cfg.decoder_layer, cfg.decoder_hidden,
                         cfg.decoder_head, max_seq_len, cfg.decoder_dropout)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, D) frame states → (B, T, D)."""
        return self.run_layers(x, pad_mask, generator)
