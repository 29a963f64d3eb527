"""The reference's checkpoints → the port's state dicts; the loading side of
the JAX package's ``interop/torch_ckpt.py`` and its ``generator.npz``
reader (``models/hifigan.py:load_generator_npz``).

The port's modules carry the reference's torch names and layouts, so a
reference checkpoint needs only three changes before
``load_state_dict(strict=True)``:

* the FastSpeech2 position tables (``encoder.position_enc``,
  ``decoder.position_enc``), which the port rebuilds as non-persistent
  buffers, are dropped;
* a checkpoint without pitch/energy bin boundaries gets them from the
  corpus stats, as the model would compute them (with them, the
  checkpoint's own boundaries are used, as the JAX package's
  ``consts_override`` does);
* HiFi-GAN weight norm is folded: ``weight = g · v / ‖v‖``, the norm over
  every dim but 0 (torch ``weight_norm``'s default), as the reference's
  ``remove_weight_norm`` does at load.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..models.fastspeech2 import DEFAULT_STATS
from ..models.variance import make_variance_bins
from .from_jax import hifigan_from_jax

# Reference FastSpeech2 keys that the port keeps as non-persistent buffers.
NON_PERSISTENT_KEYS = ("encoder.position_enc", "decoder.position_enc")


def load_torch_state_dict(path: str,
                          key: str | None = None) -> dict[str, torch.Tensor]:
    """A ``torch.save`` checkpoint (``{key: state_dict, ...}``) → its flat
    {name: tensor} state dict, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None:
        ckpt = ckpt[key]
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def fastspeech2_checkpoint_state(
    sd: Mapping[str, torch.Tensor], model_cfg: ModelConfig,
    stats: Mapping[str, list[float]] | None = None,
) -> dict[str, torch.Tensor]:
    """A reference FastSpeech2 state dict → the port's ``FastSpeech2``
    state dict."""
    out = {k: v for k, v in sd.items() if k not in NON_PERSISTENT_KEYS}
    stats = stats or DEFAULT_STATS
    ve = model_cfg.variance_embedding
    for name, quantization in (("pitch", ve.pitch_quantization),
                               ("energy", ve.energy_quantization)):
        key = f"variance_adaptor.{name}_bins"
        if key not in out:
            out[key] = make_variance_bins(stats[name][0], stats[name][1],
                                          ve.n_bins, quantization)
    return out


def fold_weight_norm(sd: Mapping[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
    """Every ``<p>.weight_g`` / ``<p>.weight_v`` pair → ``<p>.weight``;
    other entries pass through."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            prefix = k[: -len(".weight_v")]
            g = sd[f"{prefix}.weight_g"]
            norm = v.reshape(v.shape[0], -1).norm(dim=1)
            scale = (g.reshape(-1) / norm).reshape((-1,) + (1,) * (v.ndim - 1))
            out[f"{prefix}.weight"] = v * scale
        else:
            out[k] = v
    return out


def load_generator_npz(path: str) -> dict[str, torch.Tensor]:
    """A native ``generator.npz`` (folded kernels under path keys such as
    ``resblocks/0/convs1/1/kernel``) → the port's ``Generator`` state
    dict."""
    root: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return hifigan_from_jax(listify(root))


def melgan_from_state_dict(sd: Mapping[str, torch.Tensor]
                           ) -> dict[str, torch.Tensor]:
    """A melgan-neurips ``mel2wav.model`` Sequential state dict (an optional
    ``mel2wav.model.`` or ``model.`` prefix, weight norm) → the port's
    ``MelGAN`` state dict, weight norm folded; the JAX package's
    ``convert_melgan``. Sequential indices: 1 conv_pre; per stage s a
    LeakyReLU, the upsample, then the residual blocks (``block.2`` the
    dilated conv, ``block.4`` the 1×1, ``shortcut``); conv_post after a
    LeakyReLU and a ReflectionPad."""
    from ..models.melgan import N_RESIDUAL, RATIOS

    for pfx in ("mel2wav.model.", "model.", ""):
        if any(k.startswith(pfx + "1.") for k in sd):
            break
    sd = fold_weight_norm({k[len(pfx):]: torch.as_tensor(v)
                           for k, v in sd.items() if k.startswith(pfx)})
    out: dict[str, torch.Tensor] = {}

    def take(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    take("conv_pre", "1")
    idx = 2
    for i in range(len(RATIOS)):
        idx += 1  # LeakyReLU
        take(f"ups.{i}", str(idx))
        idx += 1
        for j in range(N_RESIDUAL):
            take(f"resblocks.{i}.{j}.conv_dilated", f"{idx}.block.2")
            take(f"resblocks.{i}.{j}.conv_1x1", f"{idx}.block.4")
            take(f"resblocks.{i}.{j}.shortcut", f"{idx}.shortcut")
            idx += 1
    take("conv_post", str(idx + 2))  # after LeakyReLU, ReflectionPad
    return out


def load_vocoder_state(path: str) -> dict[str, torch.Tensor]:
    """HiFi-GAN generator weights from a native ``generator.npz`` or a
    reference checkpoint (``{"generator": state_dict}``, weight norm
    folded)."""
    if path.endswith(".npz"):
        return load_generator_npz(path)
    return fold_weight_norm(load_torch_state_dict(path, key="generator"))
