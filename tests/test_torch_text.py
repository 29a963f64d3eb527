"""The port's text front-end against the JAX package's on the same inputs:
``phonemes_to_ids`` under each unknown-phone policy and its default, and
``text_to_ids`` of hanzi and of ``{…}`` phone strings."""

import pytest

from expressive_fastspeech2_mandarin_tpu import text as jax_text
from expressive_fastspeech2_mandarin_tpu_torch import text as torch_text

PHONE_LISTS = [
    ["b", "a", "n", "h", "ao"],
    ["b", "qq"],
    ["qq"],
    ["qq", "sh", "i", "zz", "j", "ie"],
    [],
]


@pytest.mark.parametrize("phones", PHONE_LISTS)
@pytest.mark.parametrize("unknown", ["skip", "pad", None])
def test_phonemes_to_ids_matches_jax(phones, unknown):
    kw = {} if unknown is None else {"unknown": unknown}
    assert (torch_text.phonemes_to_ids(phones, "pinyin", **kw)
            == jax_text.phonemes_to_ids(phones, "pinyin", **kw))


def test_phonemes_to_ids_default_skips():
    assert torch_text.phonemes_to_ids(["b", "qq"]) == \
        torch_text.phonemes_to_ids(["b"])


@pytest.mark.parametrize("unknown", ["error", "drop"])
def test_phonemes_to_ids_raises_like_jax(unknown):
    with pytest.raises(KeyError):
        jax_text.phonemes_to_ids(["b", "qq"], unknown=unknown)
    with pytest.raises(KeyError):
        torch_text.phonemes_to_ids(["b", "qq"], unknown=unknown)
    # A list with no unknown phone raises under no policy.
    assert (torch_text.phonemes_to_ids(["b", "a"], unknown=unknown)
            == jax_text.phonemes_to_ids(["b", "a"], unknown=unknown))


@pytest.mark.parametrize("text", ["今天天气真好", "{b a n qq h ao}",
                                  "{qq}", "{sh i j ie}"])
def test_text_to_ids_matches_jax(text):
    assert torch_text.text_to_ids(text) == jax_text.text_to_ids(text)
