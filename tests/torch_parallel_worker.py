"""One rank of the port's data-parallel training on the CPU, over gloo
(launched by tests/test_torch_parallel.py and tests/test_torch_cli.py);
the port's counterpart of tests/distributed_worker.py. It imports torch
and the port, never JAX.

Modes:

* ``steps``: the pieces of ``train()`` by hand, as the JAX worker's
  ``steps`` mode: a row-sharded ``BucketedDataset``, the state broadcast
  from rank 0, the collective ``evaluate`` at the initial parameters, then
  ``--steps`` train steps and ``evaluate`` again;
* ``train``: the whole ``train()`` loop (``--steps-per-call`` chunks,
  evaluation, samples on rank 0, checkpoints), each step's losses read by
  wrapping ``train.step._update``, the one optimizer step that the single
  and the multi step both run; with ``--resume-from`` rank 0 alone
  first copies a checkpoint into its own directory (each rank writes
  under ``<outdir>/rank<i>``), and ``--restore-step`` is passed on; with
  ``--expect-error`` the error ``train()`` raises is the result;
* ``jax_step``: from a train state and a global batch written by the test
  (``--state``, ``--batch``), with the dropout masks of ``MaskFeed``: the
  first step's gradients, then ``--steps`` train steps on the same batch;
* ``jax_chunk``: from the same state, a stacked chunk of global batches
  (``--batch``, (n, B, ...)) through ``make_train_multi_step``'s body (the
  function a capturable layout compiles), ``--grad-acc-step`` micro-steps
  an update, with ``MaskFeed``'s masks: the chunk's mean losses and the
  parameters after it (.npz);
* ``lockstep``: ``train()`` with the run's layout marked capturable (NCCL),
  so that the compiled makers are made as over NCCL (on CPU tensors a
  compiled step runs its body): each rank's collectives (op and element
  count), its compiled calls (function, owner, input shapes), and whether
  each rank-0 sample left the train graphs' state as it found it
  (``Graphs.check``), with ``--max-seq-len`` and ``--mel-buckets`` for a
  sample past ``max_seq_len``.

With ``--backend nccl`` (on a card) the process joins a world of
``--num-procs`` over NCCL, one alone included, and runs one of the modes
of tests/test_torch_parallel_gpu.py:

* ``witness``: one all-reduce with a pre-multiplied sum by 2 captured into
  a CUDA graph and replayed 3 times;
* ``graphed``: the data-parallel train step graphed against the same step
  eager, from one state (after one eager step) over the same batches,
  then the eager run's checkpoint restored into the graphed state through
  ``broadcast_state`` and the steps after it graphed again; the
  parameters' change is read over the parameters a gradient moves
  (``zero_in_exact_arithmetic``).

Writes a JSON result (and, in ``jax_step``, the gradients as .npz) for the
test to compare across world sizes.
"""

import argparse
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(commands: list[list[str]], timeout: float = 240) -> list[str]:
    """Run the commands at once from the repo root and return their
    outputs; on a timeout kill them all, and fail on a nonzero exit."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd in commands]
    outs, failures = [], []
    deadline = time.monotonic() + timeout
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        if p.returncode != 0:
            failures.append(f"process {i} rc={p.returncode}:\n{out}")
    assert not failures, "\n".join(failures)
    return outs


def run_workers(out_dir: str, runs: dict[str, tuple[int, dict]]
                ) -> dict[str, list[dict]]:
    """Every run of ``runs`` ({name: (ranks, worker options)}) at once, each
    on its own port; {name: each rank's JSON result}."""
    os.makedirs(out_dir, exist_ok=True)
    commands, outs = [], {}
    for name, (num_procs, options) in runs.items():
        coord = f"127.0.0.1:{free_port()}"
        flags = [f"--{k.replace('_', '-')}={v}" for k, v in options.items()]
        outs[name] = [os.path.join(out_dir, f"{name}_{i}.json")
                      for i in range(num_procs)]
        commands += [[sys.executable, os.path.abspath(__file__), "--out",
                      out, "--num-procs", str(num_procs), "--proc-id",
                      str(i), "--coord", coord, *flags]
                     for i, out in enumerate(outs[name])]
    launch(commands)
    results = {}
    for name, paths in outs.items():
        results[name] = []
        for path in paths:
            with open(path) as f:
                results[name].append(json.load(f))
    return results


class MaskFeed:
    """Keep-mask i (mod n) of a forward, made from one numpy seed: the
    masks tests/test_torch_train.py feeds both packages."""

    def __init__(self, n: int, seed: int = 7):
        self.n, self.seed, self.calls = n, seed, 0

    def __call__(self, shape, keep_prob):
        import numpy as np

        rng = np.random.default_rng([self.seed, self.calls % self.n])
        self.calls += 1
        return rng.random(tuple(shape)) < keep_prob


def n_dropouts(cfg) -> int:
    """Dropout draws per training forward: 2 per FFT block, 2 per variance
    predictor (duration, pitch, energy), 1 per postnet layer."""
    t = cfg.model.transformer
    return 2 * (t.encoder_layer + t.decoder_layer) + 6 + 5


def tiny_config(corpus: str, out: str, batch_size: int = 4,
                total_step: int = 8, steps_per_call: int = 1,
                model_parallel: int = 1):
    """tests/corpus_util.py:tiny_train_config in the port's dataclasses,
    with the model-parallel size."""
    from expressive_fastspeech2_mandarin_tpu_torch import config as C

    return C.Config(
        preprocess=C.PreprocessConfig(
            path=C.PathConfig(preprocessed_path=corpus)),
        model=C.ModelConfig(
            transformer=C.TransformerConfig(
                encoder_layer=1, decoder_layer=1, encoder_hidden=32,
                decoder_hidden=32, conv_filter_size=64, encoder_head=2,
                decoder_head=2),
            variance_predictor=C.VariancePredictorConfig(filter_size=32),
            n_speakers=4, n_emotions=3, n_arousals=3, n_valences=3,
            max_seq_len=128),
        train=C.TrainConfig(
            path=C.PathConfig(ckpt_path=os.path.join(out, "ckpt"),
                              log_path=os.path.join(out, "log"),
                              result_path=os.path.join(out, "result")),
            optimizer=C.OptimizerConfig(batch_size=batch_size,
                                        warm_up_step=10),
            step=C.StepConfig(total_step=total_step, log_step=2,
                              synth_step=4, val_step=4,
                              save_step=total_step),
            buckets=C.BucketConfig(src_buckets=(16, 24),
                                   mel_buckets=(64, 96, 128)),
            mesh=C.MeshConfig(model_parallel_size=model_parallel),
            steps_per_call=steps_per_call))


def jax_step_config(attention_impl: str = "auto"):
    """tests/test_torch_train.py:_config(tcfg) (hidden 32)."""
    from expressive_fastspeech2_mandarin_tpu_torch import config as C

    model = C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=1, decoder_layer=1, encoder_hidden=32,
            decoder_hidden=32, conv_filter_size=64, encoder_head=2,
            decoder_head=2, attention_impl=attention_impl),
        variance_predictor=C.VariancePredictorConfig(filter_size=32),
        n_speakers=4, n_emotions=3, n_arousals=3, n_valences=3,
        max_seq_len=64)
    return C.Config(preprocess=C.PreprocessConfig(), model=model,
                    train=C.TrainConfig(optimizer=C.OptimizerConfig(
                        warm_up_step=10)))


def param_sum(model) -> float:
    return sum(p.double().abs().sum() for p in model.parameters()).item()


def zero_in_exact_arithmetic(name: str) -> bool:
    """tests/test_torch_train.py's rule: the parameters whose gradients are
    float round-off (the key projection's bias, which the softmax cancels;
    a postnet conv's bias, which the training-mode BatchNorm removes), so
    whose Adam steps take a random sign."""
    return name.endswith("slf_attn.w_ks.bias") or (
        name.startswith("postnet.") and name.endswith(".conv.bias"))


def synthetic_batch(b: int, s: int, t: int, seed: int) -> dict:
    """``b`` rows at the bucket (s, t), their lengths stepping down from
    the bucket's, as numpy arrays (``loop.stage_batch``'s input)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src = s - np.arange(b) % (s // 2)
    mel = t - 3 * (np.arange(b) % (t // 6))
    dur = np.zeros((b, s), np.int32)
    for i in range(b):
        dur[i, :src[i]] = rng.multinomial(mel[i] - src[i],
                                          np.full(src[i], 1 / src[i])) + 1
    texts = rng.integers(4, 100, (b, s)).astype(np.int32)
    texts[np.arange(s)[None] >= src[:, None]] = 0
    ids = rng.integers(0, 3, (4, b)).astype(np.int32)
    return {"speakers": ids[0], "emotions": ids[1], "arousals": ids[2],
            "valences": ids[3], "texts": texts,
            "src_lens": src.astype(np.int32),
            "mels": rng.normal(-4, 2, (b, t, 80)).astype(np.float32),
            "mel_lens": mel.astype(np.int32),
            "pitches": rng.normal(size=(b, s)).astype(np.float32),
            "energies": rng.normal(size=(b, s)).astype(np.float32),
            "durations": dur}


def lockstep_train(args, cpu, result) -> None:
    """``--mode lockstep``: ``train()`` under a layout marked capturable,
    recording what every rank must do alike and rank 0's samples."""
    import torch.distributed as dist

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch import graphs
    from expressive_fastspeech2_mandarin_tpu_torch.train import loop, train
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        step as step_mod,
    )

    cfg = tiny_config(args.corpus, args.outdir, args.batch_size,
                      args.steps, args.steps_per_call)
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, max_seq_len=args.max_seq_len),
        train=dataclasses.replace(
            cfg.train,
            buckets=C.BucketConfig(
                src_buckets=(16, 24),
                mel_buckets=tuple(int(x) for x in
                                  args.mel_buckets.split(","))),
            step=dataclasses.replace(cfg.train.step, synth_step=2,
                                     val_step=4)))
    held = {}
    collectives, calls, samples = [], [], []

    def recorded(name, fn):
        def call(tensor, *a, **kw):
            collectives.append([name, tensor.numel()])
            return fn(tensor, *a, **kw)
        return call

    for name in ("all_reduce", "broadcast"):
        setattr(dist, name, recorded(name, getattr(dist, name)))
    barrier = dist.barrier

    def recorded_barrier(*a, **kw):
        collectives.append(["barrier", 0])
        return barrier(*a, **kw)

    dist.barrier = recorded_barrier
    make_layout, create = loop.make_layout, loop.create_train_state

    def capturable_layout(model_parallel):
        layout = make_layout(model_parallel)
        result["backend"] = layout.backend
        return dataclasses.replace(layout, backend="nccl")

    def creating(*a, **kw):
        held["state"] = create(*a, **kw)
        return held["state"]

    inner_call = graphs.Compiled.__call__

    def recording_call(self, *a, **kw):
        owner = ("train" if self.owner is held["state"].graphs
                 else "own")
        calls.append([self.fn.__qualname__, owner,
                      repr(graphs._flatten(a)[1])])
        return inner_call(self, *a, **kw)

    sample = loop.save_synth_sample

    def sampling(synth, val_ds, *a, **kw):
        owner = step_mod.train_graphs(held["state"])
        owner.check()
        out = sample(synth, val_ds, *a, **kw)
        samples.append({"changed": owner.check(), "max_mel_len": int(
            next(val_ds.epoch(0, shuffle=False))["mels"].shape[1])})
        return out

    loop.make_layout, loop.create_train_state = capturable_layout, creating
    graphs.Compiled.__call__ = recording_call
    loop.save_synth_sample = sampling
    state = train(cfg, device=cpu)
    result.update(collectives=collectives, calls=calls, samples=samples,
                  capturable=state.layout.capturable,
                  final_step=state.step, param_sum=param_sum(state.model))


def nccl_witness(result) -> None:
    """``--mode witness``: a pre-multiplied sum by 2 over NCCL, captured
    once and replayed 3 times; at one rank it still scales the tensor."""
    import torch
    import torch.distributed as dist

    dist.all_reduce(torch.ones(1, device="cuda"))  # the communicator
    x = torch.ones(1024, device="cuda")
    graph = torch.cuda.CUDAGraph()
    op = dist._make_nccl_premul_sum(2.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            dist.all_reduce(x, op=op)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    captured = x.clone()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    result.update(after_capture=sorted(set(captured.tolist())),
                  after_replays=sorted(set(x.tolist())))


def nccl_graphed(args, result) -> None:
    """``--mode graphed``: ``--steps`` data-parallel train steps eager and
    graphed from one state over the same batches; the graphs held after
    the first call; then the eager run's checkpoint at step 2 restored
    into the graphed state (rank 0 loads it, ``broadcast_state`` hands it
    to every rank, as ``CheckpointManager.resume`` does) and the steps
    after it graphed again."""
    import torch
    import torch.distributed as dist

    from expressive_fastspeech2_mandarin_tpu_torch import parallel
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        loop,
        train_step,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
        broadcast_state,
        load_checkpoint,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        eval_step,
        make_eval_step,
        make_train_step,
    )

    cuda = torch.device("cuda")
    cfg = jax_step_config()
    # The recipe's warm-up (small steps, as the compiled steps' own tests
    # take): past warm-up 10 the steps' float noise grows by chaos.
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optimizer=dataclasses.replace(
            cfg.train.optimizer,
            warm_up_step=type(cfg.train.optimizer)().warm_up_step)))
    layout = parallel.make_layout()
    batches = [loop.stage_batch(
        {k: v[layout.rows(args.batch_size)] for k, v in
         synthetic_batch(args.batch_size, 16, 60, seed=10 + i).items()},
        cuda) for i in range(args.steps)]

    def flat(state):
        """The parameters that a gradient moves, not round-off."""
        return torch.cat([p.detach().reshape(-1).double() for n, p in
                          state.model.named_parameters()
                          if not zero_in_exact_arithmetic(n)])

    def snapshot(state):
        return {"model": {k: v.clone() for k, v in
                          state.model.state_dict().items()},
                "optimizer": state.optimizer.state_dict(),
                "step": state.step, "generator": state.generator.get_state()}

    eager = create_train_state(cfg, None, cuda, layout)
    broadcast_state(eager)
    # One eager step first: Adam's first update is the sign of each
    # gradient, which turns round-off (eager steps are not bit-reproducible)
    # into whole steps; both runs start after it, from one snapshot.
    train_step(eager, loop.stage_batch(synthetic_batch(
        args.batch_size, 16, 60, seed=9), cuda), cfg)
    graphed = create_train_state(cfg, None, cuda, layout)
    load_checkpoint(graphed, snapshot(eager))
    broadcast_state(graphed)
    p0 = flat(eager)
    e_losses, ckpt = [], None
    for i, batch in enumerate(batches):
        if i == 2:
            ckpt = snapshot(eager)
        e_losses.append(float(train_step(eager, batch, cfg).total))
    e_eval = [float(x) for x in eval_step(eager.model, batches[0], cfg,
                                            layout)]
    step = make_train_step(graphed, cfg)
    g_losses, counts = [], []
    for batch in batches:
        g_losses.append(float(step(batch).total))
        counts.append(graphed.graphs.count())
    g_eval = [float(x) for x in make_eval_step(graphed, cfg)(batches[0])]
    d_eager, d_graphed = flat(eager) - p0, flat(graphed) - p0
    delta_rel = float((d_graphed - d_eager).norm() / d_eager.norm())
    if layout.rank == 0:
        load_checkpoint(graphed, ckpt)
    broadcast_state(graphed, True)
    dropped = graphed.graphs.check()
    r_losses = [float(step(batch).total) for batch in batches[2:]]
    r_delta = float((flat(graphed) - p0 - d_eager).norm() / d_eager.norm())
    result.update(backend=dist.get_backend(), move=float(
                      d_eager.norm() / p0.norm()),
                  capturable=layout.capturable, eager=e_losses,
                  graphed=g_losses, counts=counts, delta_rel=delta_rel,
                  eager_eval=e_eval, graphed_eval=g_eval, dropped=dropped,
                  resumed=r_losses, resumed_delta_rel=r_delta,
                  resumed_count=graphed.graphs.count(),
                  step=graphed.step)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-procs", type=int, default=1)
    ap.add_argument("--proc-id", type=int, default=0)
    ap.add_argument("--coord", default=None)
    ap.add_argument("--mode", choices=("steps", "train", "jax_step",
                                       "jax_chunk", "lockstep", "witness",
                                       "graphed"), default="steps")
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--steps-per-call", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--state", default=None)
    ap.add_argument("--batch", default=None)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--restore-step", type=int, default=None)
    ap.add_argument("--expect-error", type=int, default=0)
    ap.add_argument("--grad-acc-step", type=int, default=1)
    ap.add_argument("--max-seq-len", type=int, default=128)
    ap.add_argument("--mel-buckets", default="64,96,128")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args()

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from expressive_fastspeech2_mandarin_tpu_torch import parallel
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.ops import (
        dropout as dropout_mod,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        loss_and_grads,
        loop,
        train,
        train_step,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        step as step_mod,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
        broadcast_state,
        load_checkpoint,
    )

    cpu = torch.device("cpu")
    result = {"rank": args.proc_id}
    if args.backend == "nccl":  # a world of --num-procs, one alone included
        torch.cuda.set_device(args.proc_id % torch.cuda.device_count())
        torch.distributed.init_process_group(
            "nccl", init_method=f"tcp://{args.coord}",
            world_size=args.num_procs, rank=args.proc_id)
    else:
        parallel.initialize_distributed(args.coord, args.num_procs,
                                        args.proc_id, backend="gloo")
    if args.mode == "witness":
        nccl_witness(result)
    elif args.mode == "graphed":
        nccl_graphed(args, result)
    elif args.mode == "lockstep":
        lockstep_train(args, cpu, result)
    elif args.mode == "train":
        outdir = args.outdir
        if args.resume_from is not None:
            outdir = os.path.join(outdir, f"rank{args.proc_id}")
            if args.proc_id == 0:
                shutil.copytree(args.resume_from, os.path.join(outdir,
                                                               "ckpt"))
        cfg = tiny_config(args.corpus, outdir, args.batch_size,
                          args.steps, args.steps_per_call,
                          args.model_parallel)
        losses = []
        inner = step_mod._update

        def recording_step(state, batch, cfg):
            report = inner(state, batch, cfg)
            losses.append(float(report.total))
            return report

        step_mod._update = recording_step
        try:
            state = train(cfg, restore_step=args.restore_step, device=cpu)
        except Exception as e:
            if not args.expect_error:
                raise
            result.update(error=type(e).__name__, message=str(e))
        else:
            result.update(losses=losses, final_step=state.step,
                          param_sum=param_sum(state.model))
    elif args.mode == "steps":
        cfg = tiny_config(args.corpus, args.outdir, args.batch_size,
                          args.steps, model_parallel=args.model_parallel)
        layout = parallel.make_layout(args.model_parallel)
        n_data = layout.data_parallel if layout else 1
        corpus = PreprocessedCorpus(args.corpus)
        shards = dict(seed=cfg.train.seed, num_shards=n_data,
                      shard_index=layout.data_index if layout else 0)
        train_ds = BucketedDataset(corpus, "train.txt", args.batch_size,
                                   cfg.train.buckets, cfg.model.max_seq_len,
                                   drop_last=True, **shards)
        val_ds = BucketedDataset(corpus, "val.txt", args.batch_size,
                                 cfg.train.buckets, cfg.model.max_seq_len,
                                 **shards)
        state = create_train_state(cfg, corpus.stats, cpu, layout)
        if layout is not None:
            broadcast_state(state)
        eval0 = loop.evaluate(step_mod.make_eval_step(state, cfg), val_ds,
                              cpu)
        losses = []
        epoch = 0
        while len(losses) < args.steps:
            for batch in train_ds.epoch(epoch):
                report = train_step(state, loop.stage_batch(batch, cpu),
                                    cfg)
                losses.append(float(report.total))
                if len(losses) == args.steps:
                    break
            epoch += 1
        evals = loop.evaluate(step_mod.make_eval_step(state, cfg), val_ds,
                              cpu)
        result.update(losses=losses, eval0=eval0, eval=evals,
                      param_sum=param_sum(state.model),
                      host_rows=train_ds.host_rows(0))
    else:
        cfg = jax_step_config()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, optimizer=dataclasses.replace(
                cfg.train.optimizer, grad_acc_step=args.grad_acc_step)))
        layout = parallel.make_layout()
        state = create_train_state(cfg, None, cpu, layout)
        load_checkpoint(state, torch.load(args.state))
        feed = MaskFeed(n_dropouts(cfg))
        dropout_mod.keep_mask = (
            lambda shape, keep_prob, generator, device:
            torch.from_numpy(feed(shape, keep_prob)).to(device))
        data = dict(np.load(args.batch))
        if args.mode == "jax_chunk":  # (n, B, ...): the rows on axis 1
            if layout is not None:
                data = {k: v[:, layout.rows(v.shape[1])]
                        for k, v in data.items()}
            n = next(iter(data.values())).shape[0]
            report = step_mod.make_train_multi_step(state, cfg, n)(
                step_mod.stack_batches([
                    loop.stage_batch({k: v[i] for k, v in data.items()},
                                     cpu) for i in range(n)]))
            np.savez(args.out + ".params.npz",
                     **{k: v.numpy()
                        for k, v in state.model.state_dict().items()})
            result.update(mean_loss=[float(x) for x in report],
                          step=state.step, param_sum=param_sum(state.model),
                          updates=int(state.optimizer.count))
        else:
            if layout is not None:
                data = {k: v[layout.rows(v.shape[0])]
                        for k, v in data.items()}
            batch = loop.stage_batch(data, cpu)
            report, grads = loss_and_grads(state.model, batch, cfg,
                                           state.generator, layout)
            losses = [float(train_step(state, batch, cfg).total)
                      for _ in range(args.steps)]
            names = [n for n, _ in state.model.named_parameters()]
            np.savez(args.out + ".grads.npz",
                     **{n: g.numpy() for n, g in zip(names, grads)})
            result.update(grad_loss=[float(x) for x in report],
                          losses=losses, param_sum=param_sum(state.model))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(f"rank {args.proc_id}: ok", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
