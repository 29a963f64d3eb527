"""The vocoder trainer's compiled steps and the inference forwards on the
card: the GAN step, one and three a replay, against the same step run
eagerly from the same state; a checkpoint loaded in place dropping the
graphs; ``.grad`` after a replay; the eval graph reading what the train
graph writes (BatchNorm's running statistics); and the eval, val,
sample-vocoder and GTA forwards replayed from CUDA graphs bit-equal to
eager.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so on a machine without it run it with the root conftest off:

    python -m pytest --noconftest -m gpu tests/test_torch_compiled_gan_step_gpu.py

Bounds (PERF.md section 6, chip_smoke phase 14c's, set from the
eager step against itself, 3.95e-3 and 3.60e-3 over 13 float32 steps:
cuDNN's float32 backward sums with atomics): each loss within 1e-2
relative, the parameters' change within 1e-2 relative; the gradients
within 2e-3 of their tensor's max|g| (chip_smoke's VOC_GRAD_REL_BOUND).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.data import (
    BucketedDataset,
    PreprocessedCorpus,
)
from expressive_fastspeech2_mandarin_tpu_torch.models import Generator
from expressive_fastspeech2_mandarin_tpu_torch.models.hifigan import (
    save_generator_npz,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf
from expressive_fastspeech2_mandarin_tpu_torch.preprocess import Preprocessor
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    CheckpointManager,
    create_train_state,
    eval_step,
    synth_step,
    train_step,
)
from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tv
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
    evaluate,
    stage_batch,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.sampling import (
    SampleVocoder,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
    make_eval_step,
    make_synth_step,
    make_train_step,
)

from .port_corpus import preprocess_config, write_pipeline_corpus

LOSS_RTOL, DELTA_RTOL, GRAD_REL = 1e-2, 1e-2, 2e-3
BATCH = 2


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(30000) / 22050
    wavs = [(0.4 * np.sin(2 * np.pi * (120 + 40 * i) * t)
             + 0.05 * rng.normal(size=t.size)).astype(np.float32)
            for i in range(4)]
    sampler = tv.SegmentSampler(cfg, wavs, seed=seed)
    return [torch.from_numpy(sampler.sample(BATCH)).cuda() for _ in range(n)]


def _params(state):
    return torch.cat([p.detach().reshape(-1).double()
                      for m in (state.gen, state.mpd, state.msd)
                      for p in m.parameters()])


def _eager_step(cfg):
    return tv.make_vocoder_train_step(cfg, torch.device("cuda"),
                                      mark=lambda _name: None)


@pytest.mark.gpu
@pytest.mark.parametrize("spc", [1, 3])
def test_graphed_gan_steps_equal_eager(spc):
    """Three float32 GAN steps at Config() width from one state: graphed
    one a replay or three a replay against eager; the counts on the
    card."""
    _cuda_or_skip()
    cfg, cuda = tcfg.Config(), torch.device("cuda")
    batches = _batches(cfg, 3)
    eager, graphed = (tv.init_vocoder_train_state(cfg, cuda)
                      for _ in range(2))
    p0 = _params(eager)
    step = _eager_step(cfg)
    reports = [step(eager, b).as_dict() for b in batches]
    if spc == 1:
        gstep = tv.make_vocoder_train_step(cfg, cuda)
        got = [gstep(graphed, b).as_dict() for b in batches]
    else:
        multi = tv.make_vocoder_multi_step(graphed, cfg, cuda, 3)
        got = [multi(torch.stack(batches)).as_dict()]
        reports = [{k: float(np.mean([r[k] for r in reports]))
                    for k in reports[0]}]
    for a, b in zip(got, reports):
        for k in a:
            assert abs(a[k] - b[k]) <= LOSS_RTOL * abs(b[k]), (k, a[k], b[k])
    assert graphed.step == eager.step == 3
    for opt in (graphed.opt_g, graphed.opt_d):
        assert int(opt.count) == 3 and opt.count.is_cuda
    assert graphed.graphs.count() == 1
    d_eager = _params(eager) - p0
    assert ((_params(graphed) - p0 - d_eager).norm()
            <= DELTA_RTOL * d_eager.norm())


@pytest.mark.gpu
def test_grad_after_a_replay_is_the_updates_gradient():
    """After the second graphed call (a replay), each parameter's .grad
    holds that update's gradient: the eager step's from the same state
    and batch, within 2e-3 of max|g|."""
    _cuda_or_skip()
    cfg, cuda = tcfg.Config(), torch.device("cuda")
    batches = _batches(cfg, 2, seed=1)
    graphed = tv.init_vocoder_train_state(cfg, cuda)
    gstep = tv.make_vocoder_train_step(cfg, cuda)
    gstep(graphed, batches[0])  # the capture, then its first replay
    eager = tv.init_vocoder_train_state(cfg, cuda)
    tv.load_vocoder_checkpoint(eager, tv.vocoder_checkpoint(graphed))
    _eager_step(cfg)(eager, batches[1])
    gstep(graphed, batches[1])
    assert graphed.graphs.count() == 1
    for part in ("gen", "mpd", "msd"):
        for (name, p), q in zip(getattr(graphed, part).named_parameters(),
                                getattr(eager, part).parameters()):
            scale = float(q.grad.abs().max())
            assert float((p.grad - q.grad).abs().max()) <= GRAD_REL * max(
                scale, 1e-30), (part, name)


@pytest.mark.gpu
def test_loaded_checkpoint_drops_the_graphs():
    """A checkpoint loaded into a graphed state in place drops its graphs
    at the next call, which captures anew and goes on from the loaded
    state: the eager run's next loss."""
    _cuda_or_skip()
    cfg, cuda = tcfg.Config(), torch.device("cuda")
    batches = _batches(cfg, 3, seed=2)
    eager, graphed = (tv.init_vocoder_train_state(cfg, cuda)
                      for _ in range(2))
    step, gstep = _eager_step(cfg), tv.make_vocoder_train_step(cfg, cuda)
    step(eager, batches[0])
    ckpt = tv.vocoder_checkpoint(eager)
    gstep(graphed, batches[1])
    gstep(graphed, batches[2])
    assert graphed.graphs.count() == 1
    tv.load_vocoder_checkpoint(graphed, ckpt)
    assert graphed.graphs.check() and graphed.graphs.count() == 0
    assert graphed.step == 1 and int(graphed.opt_g.count) == 1
    want = step(eager, batches[1]).as_dict()
    got = gstep(graphed, batches[1]).as_dict()
    assert graphed.graphs.count() == 1
    for k in want:
        assert abs(got[k] - want[k]) <= LOSS_RTOL * abs(want[k]), k


@pytest.mark.gpu
def test_eval_graph_reads_what_the_train_graph_writes():
    """The eval graph shares the train state's graphs: train replays write
    the weights and BatchNorm's running statistics in place, and the eval
    replay reads them there (equal to eager, no graph dropped); an eager
    train step writes them outside a replay and drops every graph, and
    the next eval captures anew."""
    _cuda_or_skip()
    cfg, cuda = tcfg.Config(), torch.device("cuda")
    batches = [stage_batch(b, cuda) for b in (
        _fs2_batch(32, 200, 0), _fs2_batch(32, 200, 1))]
    state = create_train_state(cfg, None, cuda)
    step, evaluate_ = make_train_step(state, cfg), make_eval_step(state, cfg)
    bn = state.model.postnet.convolutions[0][1].running_mean

    def same(got):
        for a, b in zip(got, eval_step(state.model, batches[1], cfg)):
            assert torch.equal(a, b)

    step(batches[0])
    same(evaluate_(batches[1]))
    assert state.graphs.count() == 2
    before = bn.clone()
    step(batches[0])  # a replay: BatchNorm's statistics move in place
    assert not torch.equal(bn, before)
    same(evaluate_(batches[1]))
    assert state.graphs.count() == 2
    train_step(state, batches[0], cfg)  # eager: the graphs drop
    same(evaluate_(batches[1]))
    assert state.graphs.count() == 1


def _fs2_batch(s, t, seed):
    """Two rows at the bucket (s, t), the second shorter."""
    rng = np.random.default_rng(seed)
    src = np.array([s, s - 3], np.int32)
    mel = np.array([t, t - 20], np.int32)
    dur = np.zeros((2, s), np.int32)
    for i in range(2):
        dur[i, :src[i]] = rng.multinomial(mel[i] - src[i],
                                          np.full(src[i], 1 / src[i])) + 1
    texts = rng.integers(4, 100, (2, s)).astype(np.int32)
    texts[np.arange(s)[None] >= src[:, None]] = 0
    ids = rng.integers(0, 4, (4, 2)).astype(np.int32)
    return {"speakers": ids[0], "emotions": ids[1], "arousals": ids[2],
            "valences": ids[3], "texts": texts, "src_lens": src,
            "mels": rng.normal(-4, 2, (2, t, 80)).astype(np.float32),
            "mel_lens": mel,
            "pitches": rng.normal(size=(2, s)).astype(np.float32),
            "energies": rng.normal(size=(2, s)).astype(np.float32),
            "durations": dur}


def _fs2_state(tmp_path, impl="flash"):
    raw, tg_root = write_pipeline_corpus(tmp_path)
    pre = tmp_path / "pre"
    shutil.copytree(tg_root, pre / "TextGrid")
    Preprocessor(preprocess_config(tcfg, raw, pre), num_workers=1,
                 device="cpu").build_from_path()
    with open(os.path.join(pre, "stats.json")) as f:
        stats = json.load(f)
    model = tcfg.ModelConfig(
        transformer=tcfg.TransformerConfig(
            encoder_layer=1, decoder_layer=1, attention_impl=impl),
        n_speakers=2, n_emotions=2, n_arousals=2, n_valences=2)
    cfg = tcfg.Config(preprocess=preprocess_config(tcfg, raw, pre),
                      model=model)
    return cfg, stats, create_train_state(cfg, stats, torch.device("cuda"))


@pytest.mark.gpu
def test_inference_graphs_equal_eager(tmp_path):
    """Under "flash": ``evaluate`` through ``make_eval_step``, the sample
    synthesis step and ``export_gta_mels`` bit-equal to eager with eager's
    flash forward launches (one a block a batch, counted once a call
    whether it captured or replayed); the vocoder's val step and
    ``SampleVocoder`` (72 float32 MRF launches a call) bit-equal."""
    _cuda_or_skip()
    cuda = torch.device("cuda")
    cfg, stats, state = _fs2_state(tmp_path)
    corpus = PreprocessedCorpus(cfg.preprocess.path.preprocessed_path)
    val_ds = BucketedDataset(corpus, "val.txt", 8, cfg.train.buckets,
                             cfg.model.max_seq_len,
                             symbol_table=cfg.preprocess.symbol_table)

    def flash(fn):
        before = fa.launch_count
        out = fn()
        return out, fa.launch_count - before

    eager, n_eager = flash(lambda: evaluate(
        lambda b: eval_step(state.model, b, cfg), val_ds, cuda))
    compiled = make_eval_step(state, cfg)
    for _ in range(2):
        got, n = flash(lambda: evaluate(compiled, val_ds, cuda))
        assert got == eager and n == n_eager == 2
    batch = stage_batch(next(val_ds.epoch(0, shuffle=False)), cuda)
    t = batch["mels"].shape[1]
    (mel, lens, dur), n_eager = flash(lambda: synth_step(state.model, batch,
                                                         t))
    synth = make_synth_step(state)
    for _ in range(2):
        (g_mel, g_lens, g_dur), n = flash(lambda: synth(batch, t))
        assert n == n_eager == 2
        assert torch.equal(g_mel, mel) and torch.equal(g_lens, lens)
        assert torch.equal(g_dur, dur)
    assert state.graphs.count() == 2
    single = eval_step(state.model, batch, cfg)
    for a, b in zip(compiled(batch), single):
        assert torch.equal(a, b)

    CheckpointManager(str(tmp_path / "ckpt")).save(0, state)
    outs = {}
    for kind in ("eager", "graphed"):
        graphs = tv.Graphs
        if kind == "eager":
            tv.Graphs = type("EagerGraphs", (), {
                "__init__": lambda self, *a, **k: None,
                "jit": lambda self, fn, *a, **k: fn})
        try:
            outs[kind] = str(tmp_path / kind)
            _, n = flash(lambda: tv.export_gta_mels(
                cfg, str(tmp_path / "ckpt"), outs[kind], device=cuda,
                log=lambda *_: None))
        finally:
            tv.Graphs = graphs
        assert n == 2 * 3  # two blocks, three batches
    for name in sorted(os.listdir(outs["eager"])):
        np.testing.assert_array_equal(
            np.load(os.path.join(outs["graphed"], name)),
            np.load(os.path.join(outs["eager"], name)))

    vcfg = tcfg.Config()
    vstate = tv.init_vocoder_train_state(vcfg, cuda)
    plain = tv.make_vocoder_val_step(vcfg, cuda)
    graphed = tv.make_vocoder_val_step(vcfg, cuda, vstate)
    for b in _batches(vcfg, 2, seed=3):
        assert torch.equal(graphed(vstate.gen, b), plain(vstate.gen, b))
    assert vstate.graphs.count() == 1

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        gen = Generator(vcfg.model.vocoder).state_dict()
    npz = str(tmp_path / "generator.npz")
    save_generator_npz(npz, gen)
    scfg = dataclasses.replace(vcfg, model=dataclasses.replace(
        vcfg.model, vocoder=dataclasses.replace(vcfg.model.vocoder,
                                                ckpt_path=npz)))
    sampler = SampleVocoder(scfg, cuda)
    mel = np.random.default_rng(4).normal(-4, 2, (100, 80)).astype(
        np.float32)
    compiled = sampler._generator
    sampler._generator = sampler.generator
    before = mrf.f32_launch_count
    want = sampler.vocode(mel, 93)
    assert mrf.f32_launch_count - before == 72
    sampler._generator = compiled
    for _ in range(2):
        before = mrf.f32_launch_count
        np.testing.assert_array_equal(sampler.vocode(mel, 93), want)
        assert mrf.f32_launch_count - before == 72
