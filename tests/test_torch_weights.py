"""Weights carried across from the JAX package: ``fastspeech2_from_jax``
equals the JAX package's ``export_fastspeech2`` key for key, and
``hifigan_from_jax`` followed by the JAX package's ``convert_hifigan`` gives
back the original tree; both load strictly into the port's modules."""

import numpy as np
import torch

import jax

from expressive_fastspeech2_mandarin_tpu.config import Config as JaxConfig
from expressive_fastspeech2_mandarin_tpu.interop.torch_ckpt import (
    convert_hifigan,
    export_fastspeech2,
)
from expressive_fastspeech2_mandarin_tpu.models import init_generator
from expressive_fastspeech2_mandarin_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
)
from expressive_fastspeech2_mandarin_tpu_torch.config import Config
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
    hifigan_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.models import (
    FastSpeech2,
    Generator,
)

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_fastspeech2_from_jax_equals_export_fastspeech2():
    cfg = JaxConfig()
    model = JaxFastSpeech2(cfg.model, cfg.preprocess)
    params, bn_state = model.init(jax.random.PRNGKey(3))
    consts = {k: np.asarray(v) for k, v in model.consts.items()}
    ref = export_fastspeech2(_np(params), _np(bn_state), consts)
    out = fastspeech2_from_jax(_np(params), _np(bn_state), consts)
    assert list(out) == list(ref)
    for key, value in ref.items():
        assert out[key].dtype == torch.float32, key
        np.testing.assert_array_equal(out[key].numpy(), value, err_msg=key)
    port = FastSpeech2(Config().model, Config().preprocess)
    port.load_state_dict(out, strict=True)
    assert set(port.state_dict()) == set(ref)


def test_hifigan_from_jax_round_trips_through_convert_hifigan():
    cfg = JaxConfig().model.vocoder
    params = _np(init_generator(jax.random.PRNGKey(4), cfg))
    sd = hifigan_from_jax(params)
    back = convert_hifigan({k: v.numpy() for k, v in sd.items()})
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, value in flat_ref:
        np.testing.assert_array_equal(flat_back[path], value)
    gen = Generator(Config().model.vocoder)
    gen.load_state_dict(sd, strict=True)
    assert gen.ups[0].weight.shape == (512, 256, 16)
    assert gen.resblocks[0].convs1[0].weight.shape == (256, 256, 3)
