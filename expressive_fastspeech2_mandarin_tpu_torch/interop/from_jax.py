"""JAX-package parameter trees (as numpy arrays) → the port's state dicts.

The JAX package stores linear weights ``(d_in, d_out)`` and conv kernels
``(K, C_in, C_out)``; torch keeps ``(d_out, d_in)``, Conv1d ``(C_out, C_in,
K)`` and ConvTranspose1d ``(C_in, C_out, K)``. Every mapping below is a
transpose, under the reference's torch names, so ``load_state_dict(strict=True)``
takes the result. Only numpy and torch are needed: the trees are nested
dicts and lists of arrays.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

Params = Mapping[str, Any]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _lin(out: dict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    out[f"{prefix}.bias"] = _t(p["b"])


def _conv(out: dict, prefix: str, p: Params) -> None:
    # (K, Cin, Cout) -> Conv1d (Cout, Cin, K)
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(out: dict, prefix: str, p: Params) -> None:
    # (K, Cin, Cout) -> ConvTranspose1d (Cin, Cout, K)
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(1, 2, 0))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _ln(out: dict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _t(p["g"])
    out[f"{prefix}.bias"] = _t(p["b"])


def _fft_block(out: dict, prefix: str, p: Params) -> None:
    _lin(out, f"{prefix}.slf_attn.w_qs", p["attn"]["wq"])
    _lin(out, f"{prefix}.slf_attn.w_ks", p["attn"]["wk"])
    _lin(out, f"{prefix}.slf_attn.w_vs", p["attn"]["wv"])
    _lin(out, f"{prefix}.slf_attn.fc", p["attn"]["fc"])
    _ln(out, f"{prefix}.slf_attn.layer_norm", p["attn"]["ln"])
    _conv(out, f"{prefix}.pos_ffn.w_1", p["ffn"]["w1"])
    _conv(out, f"{prefix}.pos_ffn.w_2", p["ffn"]["w2"])
    _ln(out, f"{prefix}.pos_ffn.layer_norm", p["ffn"]["ln"])


def _variance_predictor(out: dict, prefix: str, p: Params) -> None:
    _conv(out, f"{prefix}.conv_layer.conv1d_1.conv", p["conv1"])
    _ln(out, f"{prefix}.conv_layer.layer_norm_1", p["ln1"])
    _conv(out, f"{prefix}.conv_layer.conv1d_2.conv", p["conv2"])
    _ln(out, f"{prefix}.conv_layer.layer_norm_2", p["ln2"])
    _lin(out, f"{prefix}.linear_layer", p["linear"])


def _fastspeech2_params(params: Params, bn_state: Params | None = None
                        ) -> dict[str, torch.Tensor]:
    """The parameters under the port's names, with the BatchNorm
    statistics of ``bn_state`` when given; also maps trees shaped like the
    params, as Adam's moments are."""
    out: dict[str, torch.Tensor] = {}
    out["encoder.src_word_emb.weight"] = _t(params["encoder"]["embed"])
    for i, blk in enumerate(params["encoder"]["layers"]):
        _fft_block(out, f"encoder.layer_stack.{i}", blk)
    for i, blk in enumerate(params["decoder"]["layers"]):
        _fft_block(out, f"decoder.layer_stack.{i}", blk)
    va = params["variance_adaptor"]
    for name in ("duration", "pitch", "energy"):
        _variance_predictor(out, f"variance_adaptor.{name}_predictor",
                            va[f"{name}_predictor"])
    out["variance_adaptor.pitch_embedding.weight"] = _t(va["pitch_embedding"])
    out["variance_adaptor.energy_embedding.weight"] = _t(
        va["energy_embedding"])
    _lin(out, "mel_linear", params["mel_linear"])
    for i, conv in enumerate(params["postnet"]["convs"]):
        _conv(out, f"postnet.convolutions.{i}.0.conv", conv)
        out[f"postnet.convolutions.{i}.1.weight"] = _t(conv["bn_g"])
        out[f"postnet.convolutions.{i}.1.bias"] = _t(conv["bn_b"])
        if bn_state is not None:
            bn = bn_state["postnet"]["convs"][i]
            out[f"postnet.convolutions.{i}.1.running_mean"] = _t(bn["mean"])
            out[f"postnet.convolutions.{i}.1.running_var"] = _t(bn["var"])
    if "speaker_emb" in params:
        out["speaker_emb.weight"] = _t(params["speaker_emb"])
    if "emotion_emb" in params:
        out["emotion_emb.weight"] = _t(params["emotion_emb"])
        out["arousal_emb.weight"] = _t(params["arousal_emb"])
        out["valence_emb.weight"] = _t(params["valence_emb"])
        _lin(out, "emotion_linear.0", params["emotion_linear"])
    return out


def fastspeech2_from_jax(params: Params, bn_state: Params,
                         consts: Mapping[str, Any] | None = None
                         ) -> dict[str, torch.Tensor]:
    """JAX ``FastSpeech2`` params, BatchNorm state and consts (the
    pitch/energy bin boundaries) → the port's ``FastSpeech2`` state dict.
    Without ``consts`` the bins are left out (load with ``strict=False``
    over a model that already holds its bins)."""
    out = _fastspeech2_params(params, bn_state)
    if consts is not None:
        out["variance_adaptor.pitch_bins"] = _t(consts["pitch_bins"])
        out["variance_adaptor.energy_bins"] = _t(consts["energy_bins"])
    return out


def _find(node: Any, *attrs: str) -> Any:
    """The first node of an optax state tree (named tuples, tuples) that
    has every one of ``attrs``."""
    if all(hasattr(node, a) for a in attrs):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find(child, *attrs)
            if found is not None:
                return found
    return None


def train_state_from_jax(params: Params, bn_state: Params, opt_state: Any,
                         step: int, *,
                         consts: Mapping[str, Any] | None = None) -> dict:
    """A JAX ``TrainState``'s parts (as numpy trees) → a checkpoint dict of
    the port (``train.state.load_checkpoint``): the model state dict, and
    the optimizer state — Adam's ``mu``/``nu`` and count from the
    ``scale_by_adam`` state, and with ``optax.MultiSteps`` its mini-step
    and accumulated gradients — under the parameter names of
    ``fastspeech2_from_jax``; ``consts`` as there (the model's bins are
    part of a checkpoint)."""
    adam = _find(opt_state, "mu", "nu", "count")
    if adam is None:
        raise ValueError("opt_state holds no scale_by_adam state")
    multi = _find(opt_state, "mini_step", "acc_grads")
    optimizer = {
        "count": int(np.asarray(adam.count)),
        "mini_step": int(np.asarray(multi.mini_step)) if multi else 0,
        "mu": _fastspeech2_params(adam.mu),
        "nu": _fastspeech2_params(adam.nu),
        "acc": _fastspeech2_params(multi.acc_grads) if multi else {},
    }
    return {"model": fastspeech2_from_jax(params, bn_state, consts),
            "optimizer": optimizer, "step": int(np.asarray(step))}


def hifigan_from_jax(params: Params) -> dict[str, torch.Tensor]:
    """JAX HiFi-GAN generator params (folded kernels) → the port's
    ``Generator`` state dict (the inverse of the JAX package's
    ``convert_hifigan``)."""
    out: dict[str, torch.Tensor] = {}
    _conv(out, "conv_pre", params["conv_pre"])
    for i, up in enumerate(params["ups"]):
        _conv_transpose(out, f"ups.{i}", up)
    for i, rb in enumerate(params["resblocks"]):
        for j, conv in enumerate(rb["convs1"]):
            _conv(out, f"resblocks.{i}.convs1.{j}", conv)
        for j, conv in enumerate(rb["convs2"]):
            _conv(out, f"resblocks.{i}.convs2.{j}", conv)
    _conv(out, "conv_post", params["conv_post"])
    return out
