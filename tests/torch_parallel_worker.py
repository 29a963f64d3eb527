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
  first step's gradients, then ``--steps`` train steps on the same batch.

Writes a JSON result (and, in ``jax_step``, the gradients as .npz) for the
test to compare across world sizes.
"""

import argparse
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-procs", type=int, default=1)
    ap.add_argument("--proc-id", type=int, default=0)
    ap.add_argument("--coord", default=None)
    ap.add_argument("--mode", choices=("steps", "train", "jax_step"),
                    default="steps")
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
    parallel.initialize_distributed(args.coord, args.num_procs,
                                    args.proc_id, backend="gloo")
    result = {"rank": args.proc_id}
    if args.mode == "train":
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
        layout = parallel.make_layout()
        state = create_train_state(cfg, None, cpu, layout)
        load_checkpoint(state, torch.load(args.state))
        feed = MaskFeed(n_dropouts(cfg))
        dropout_mod.keep_mask = (
            lambda shape, keep_prob, generator, device:
            torch.from_numpy(feed(shape, keep_prob)).to(device))
        data = dict(np.load(args.batch))
        if layout is not None:
            data = {k: v[layout.rows(v.shape[0])] for k, v in data.items()}
        batch = loop.stage_batch(data, cpu)
        report, grads = loss_and_grads(state.model, batch, cfg,
                                       state.generator, layout)
        losses = [float(train_step(state, batch, cfg).total)
                  for _ in range(args.steps)]
        names = [n for n, _ in state.model.named_parameters()]
        np.savez(args.out + ".grads.npz",
                 **{n: g.numpy() for n, g in zip(names, grads)})
        result.update(grad_loss=[float(x) for x in report], losses=losses,
                      param_sum=param_sum(state.model))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(f"rank {args.proc_id}: ok", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
