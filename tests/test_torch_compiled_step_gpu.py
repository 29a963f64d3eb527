"""The compiled steps on the card: synthesis and train steps replayed from
CUDA graphs against the same functions run eagerly from the same weights
and state, and a capture that syncs to the host raises.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so on a machine without it run it with the root conftest off:

    python -m pytest --noconftest -m gpu tests/test_torch_compiled_step_gpu.py

Bounds (PERF.md section 6): the mel within 1e-5 of max(1, max|mel|), the
bf16 waveform within 5e-2 of its peak; each train loss within 1e-5
relative, the parameters' change within 1e-2 relative.
"""

import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu_torch import graphs
from expressive_fastspeech2_mandarin_tpu_torch.config import Config
from expressive_fastspeech2_mandarin_tpu_torch.models import (
    FastSpeech2,
    Generator,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf
from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    create_train_state,
    train_step,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import stage_batch
from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
    make_train_multi_step,
    make_train_step,
    stack_batches,
)


ROOT = Path(__file__).resolve().parents[1]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")


def _eager(synth, *args, **kwargs):
    """``synth.synthesize`` through its compiled functions' eager
    bodies."""
    compiled = synth._synth_fn, synth._vocoder_fn
    synth._synth_fn = lambda *key: synth._compile_synth(*key).fn
    synth._vocoder_fn = lambda kind: synth._compile_vocoder(kind).fn
    try:
        return synth.synthesize(*args, **kwargs)
    finally:
        synth._synth_fn, synth._vocoder_fn = compiled


@pytest.mark.gpu
def test_graphed_synthesis_equals_eager():
    _cuda_or_skip()
    cfg = Config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fs2 = FastSpeech2(cfg.model, cfg.preprocess).state_dict()
        torch.manual_seed(1)
        voc = Generator(cfg.model.vocoder).state_dict()
    fs2["variance_adaptor.duration_predictor.linear_layer.bias"] += 2.0
    synth = Synthesizer(cfg, fs2, voc, device="cuda")
    texts = ["{n i h ao sh i j ie}", "{w o m en q i zh en}"]
    eager = _eager(synth, texts, vocoder="hifigan")
    counts = []
    for _ in range(2):  # the capturing call, then a replay
        before = mrf.tc_launch_count
        graphed = synth.synthesize(texts, vocoder="hifigan")
        counts.append(mrf.tc_launch_count - before)
    assert counts == [72, 72] and synth._graphs.count() == 2
    for a, b in zip(eager, graphed):
        np.testing.assert_array_equal(a.durations, b.durations)
        assert np.abs(a.mel - b.mel).max() <= 1e-5 * max(
            1.0, np.abs(a.mel).max())
        assert np.abs(a.wav - b.wav).max() <= 5e-2 * np.abs(a.wav).max()
    # A weight written in place drops the graphs before the next call.
    with torch.no_grad():
        synth.model.mel_linear.bias.add_(1.0)
    moved = synth.synthesize(texts, vocoder="none")
    assert np.abs(moved[0].mel - graphed[0].mel).max() > 0.1


@pytest.mark.gpu
def test_graphed_synthesis_across_regrown_position_tables_equals_eager():
    """max_mel_len 2500, then 4096, then 2500 again, all past max_seq_len:
    the 4096 capture regrows the decoder's position table, which drops the
    2500 graph (it read the old table); each call equals eager."""
    _cuda_or_skip()
    cfg = Config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fs2 = FastSpeech2(cfg.model, cfg.preprocess).state_dict()
    fs2["variance_adaptor.duration_predictor.linear_layer.bias"] += 2.0
    synth = Synthesizer(cfg, fs2, device="cuda")
    texts = ["{n i h ao sh i j ie}", "{w o m en q i zh en}"]
    for max_mel, held in ((2500, 1), (4096, 1), (2500, 2)):
        graphed = synth.synthesize(texts, vocoder="none",
                                   max_mel_len=max_mel)
        assert synth._graphs.count() == held, max_mel
        # What a freed table's memory may hold next.
        junk = [torch.full((max_mel, 256), float("nan"), device="cuda")
                for _ in range(4)]
        again = synth.synthesize(texts, vocoder="none", max_mel_len=max_mel)
        del junk
        eager = _eager(synth, texts, vocoder="none", max_mel_len=max_mel)
        for a, b, c in zip(eager, graphed, again):
            np.testing.assert_array_equal(a.durations, b.durations)
            for got in (b, c):
                assert np.abs(a.mel - got.mel).max() <= 1e-5 * max(
                    1.0, np.abs(a.mel).max())


def _batch(s, t, seed):
    """Two rows at the bucket (s, t), the second shorter."""
    b = 2
    rng = np.random.default_rng(seed)
    src = np.array([s, s - 3], np.int32)
    mel = np.array([t, t - 20], np.int32)
    dur = np.zeros((b, s), np.int32)
    for i in range(b):
        dur[i, :src[i]] = rng.multinomial(mel[i] - src[i],
                                          np.full(src[i], 1 / src[i])) + 1
    texts = rng.integers(4, 100, (b, s)).astype(np.int32)
    texts[np.arange(s)[None] >= src[:, None]] = 0
    ids = rng.integers(0, 4, (4, b)).astype(np.int32)
    return {"speakers": ids[0], "emotions": ids[1], "arousals": ids[2],
            "valences": ids[3], "texts": texts, "src_lens": src,
            "mels": rng.normal(-4, 2, (b, t, 80)).astype(np.float32),
            "mel_lens": mel, "pitches": rng.normal(size=(b, s)).astype(
                np.float32),
            "energies": rng.normal(size=(b, s)).astype(np.float32),
            "durations": dur}


@pytest.mark.gpu
@pytest.mark.parametrize("spc", [1, 3])
def test_graphed_train_steps_equal_eager(spc):
    """Three float32 steps from one state: graphed one a replay or three
    a replay against eager."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    cuda = torch.device("cuda")
    batches = [stage_batch(_batch(32, 200, i), cuda) for i in range(3)]
    eager, graphed = (create_train_state(cfg, None, cuda) for _ in range(2))
    p0 = [p.detach().clone() for p in eager.model.parameters()]
    losses = [float(train_step(eager, b, cfg).total) for b in batches]
    if spc == 1:
        step = make_train_step(graphed, cfg)
        got = [float(step(b).total) for b in batches]
    else:
        multi = make_train_multi_step(graphed, cfg, 3)
        got = [float(multi(stack_batches(batches)).total)]
        losses = [sum(losses) / 3]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    assert graphed.step == eager.step == 3
    assert int(graphed.optimizer.count) == 3
    assert graphed.graphs.count() == 1
    num = den = 0.0
    for p, q, r in zip(graphed.model.parameters(),
                       eager.model.parameters(), p0):
        num += float(((p - q).detach().double() ** 2).sum())
        den += float(((q - r).detach().double() ** 2).sum())
    assert num ** 0.5 <= 1e-2 * den ** 0.5


@pytest.mark.gpu
def test_no_garbage_collection_while_a_stream_captures():
    """A dead owner's graphs, held in a cycle, are not collected inside
    another owner's capture (which that would invalidate): with the
    collector's threshold at 1, no collection starts while the stream
    captures, and the capture replays right."""
    _cuda_or_skip()
    capturing = []

    def on_collect(phase, info):
        if phase == "start":
            capturing.append(torch.cuda.is_current_stream_capturing())

    def dead_owner():
        owner = graphs.Graphs()
        owner.fn = owner.jit(lambda x: x * 2.0)  # owner -> fn -> owner
        owner.fn(torch.ones(4, device="cuda"))
        assert owner.count() == 1

    thresholds = gc.get_threshold()
    gc.callbacks.append(on_collect)
    gc.set_threshold(1)
    try:
        dead_owner()
        live = graphs.Graphs()
        fn = live.jit(lambda x: [x + i for i in range(50)][-1])
        out = [fn(torch.ones(4, device="cuda")) for _ in range(2)]
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(on_collect)
    assert capturing and not any(capturing)
    for o in out:
        assert torch.equal(o, torch.full((4,), 50.0, device="cuda"))


_SYNCING_CAPTURE = """
import torch
from expressive_fastspeech2_mandarin_tpu_torch import graphs
owner = graphs.Graphs()
fn = owner.jit(lambda x: x * float(x.sum()))
try:
    fn(torch.ones(4, device="cuda"))
except RuntimeError as e:
    print("raised", owner.count(), str(e).splitlines()[0])
"""


@pytest.mark.gpu
def test_a_function_compiled_after_the_owners_graphs_died_captures():
    """The pattern of ``examples_torch/convergence_deep.py``: a function
    compiled on an owner whose earlier functions (and so every graph in
    its pool) are gone captures into a new pool and replays."""
    _cuda_or_skip()
    owner = graphs.Graphs()
    x = torch.randn(64, device="cuda")
    first = owner.jit(lambda t: t * 2)
    assert torch.equal(first(x), x * 2)
    old_pool = owner.pool
    del first
    gc.collect()
    assert owner.count() == 0
    second = owner.jit(lambda t: t + 1)
    assert torch.equal(second(x), x + 1)
    assert torch.equal(second(x * 3), x * 3 + 1)  # a replay
    assert owner.pool != old_pool and owner.count() == 1


@pytest.mark.gpu
def test_capture_that_syncs_to_the_host_raises():
    """In a process of its own: a failed capture leaves PyTorch's default
    CUDA generator mid-capture, and later draws in that process raise."""
    _cuda_or_skip()
    out = subprocess.run([sys.executable, "-c", _SYNCING_CAPTURE], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert "raised 0" in out.stdout, out.stdout + out.stderr
