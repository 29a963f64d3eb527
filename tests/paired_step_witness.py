"""Why tests/test_torch_gta.py's paired GAN step runs on the log-mels of its
wavs and not on random N(-4, 2) mels: on random mels a few generator
parameters end just over 1e-6 from JAX's after the step, the bound.

For four seeds, this script runs that random-mel case (``gan_steps`` of
tests/test_torch_gta.py with each pair's mel drawn from N(-4, 2)), counts
the parameters over the bound where |g| > 1e-3·max|g| (the tests' skip
rule), and for the one that differs most prints:

- its gradient in JAX's float32 step, the port's float32 step and the
  port's float64 step from the same state and batch (the JAX package casts
  to float32 inside its step, so it has no float64 step);
- JAX's first-step moments and √v̂ against AdamW's eps;
- AdamW's second update computed in float64 from those moments and each
  of the two float32 gradients, and the two updates' difference beside
  the parameters' difference;
- each float32 step's distance from the float64 step there.

When the two updates differ by what the parameters do, the optimizer steps
agree and the gap comes from the gradients alone. When JAX's own float32
step is as far from the float64 step as the port's, the gap is float32
rounding that neither package holds to 1e-6. With √v̂ far above eps the
update m̂/√v̂ does not shrink with |g|: a gradient's relative error, not
its share of max|g|, sets the parameter's error.

Run from the repository root (about 3 minutes on 2 cores):

    JAX_PLATFORMS=cpu python -m tests.paired_step_witness
"""

import conftest  # noqa: F401  (JAX on the CPU, as under pytest)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.train import vocoder as jvoc
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    discriminator_from_jax,
    wn_generator_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tvoc

from .test_torch_gta import _pairs
from .test_torch_vocoder_train import (
    PARAM_ATOL,
    _cfg,
    _checkpoint,
    _jax_grads,
    _jax_state,
    _np,
    _port_params,
)

CPU = torch.device("cpu")


def random_mel_pairs(seed: int) -> list:
    """``_pairs(seed)``'s wavs, each with a mel of its rows drawn from
    N(-4, 2) right after the wav's noise, from the same generator."""
    rng = np.random.default_rng(seed)
    out = []
    for i, f in enumerate((40, 9, 25)):
        n = (f - 1) * 64 - 5 * i
        t = np.arange(n) / 16000
        f0 = 150 + 60 * i
        wav = (0.4 * np.sin(2 * np.pi * f0 * t)
               + 0.2 * np.sin(4 * np.pi * f0 * t)
               + 0.05 * rng.normal(size=n)).astype(np.float32)
        mel = rng.normal(-4.0, 2.0, (1 + n // 64, 80)).astype(np.float32)
        out.append((mel, wav))
    return out


def port_step(pc, js1, batch, dtype):
    ps = tvoc.init_vocoder_train_state(pc, CPU)
    if dtype == torch.float64:
        for m in (ps.gen, ps.mpd, ps.msd):
            m.double()
        ps.opt_g, ps.opt_d = tvoc.make_vocoder_optimizers(pc, ps.gen, ps.mpd,
                                                          ps.msd)
    tvoc.load_vocoder_checkpoint(ps, _checkpoint(js1))
    tvoc.make_vocoder_train_step(pc, CPU)(
        ps, {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()})
    return _port_params(ps)


def moments(js1, which: str) -> dict:
    def get(opt, convert):
        return convert(_np(optax.tree_utils.tree_get(opt, which)))

    d = get(js1.opt_d, lambda t: {f"{n}.{k}": v for n in ("mpd", "msd")
                                  for k, v in discriminator_from_jax(
                                      t[n]).items()})
    return {"gen": get(js1.opt_g, wn_generator_from_jax),
            "mpd": {k[4:]: v for k, v in d.items() if k.startswith("mpd.")},
            "msd": {k[4:]: v for k, v in d.items() if k.startswith("msd.")}}


def witness(step, seed: int) -> int:
    """The random-mel case from ``seed`` through JAX's ``step``; returns
    how many parameters are over the bound."""
    jc, pc = _cfg(jcfg), _cfg(tcfg)
    vt = pc.vocoder_train
    b1, b2 = vt.adam_betas
    lr = tvoc.vocoder_lr(pc, 1)  # the second update
    sampler = jvoc.PairedSegmentSampler(jc, random_mel_pairs(seed), seed=3)
    batch_a, batch_b = sampler.sample(2), sampler.sample(2)
    js1, _ = step(_jax_state(jc, 0), jax.tree.map(jnp.asarray, batch_a))
    js2, _ = step(js1, jax.tree.map(jnp.asarray, batch_b))
    g_jax = _jax_grads(js1, js2, b1)
    js2n = _np(js2)
    p_jax = {"gen": wn_generator_from_jax(js2n.gen),
             "mpd": discriminator_from_jax(js2n.mpd),
             "msd": discriminator_from_jax(js2n.msd)}
    port32 = port_step(pc, js1, batch_b, torch.float32)
    port64 = port_step(pc, js1, batch_b, torch.float64)
    mu, nu = moments(js1, "mu"), moments(js1, "nu")

    def update(m1, v1, g):  # AdamW's second update without the decay
        m = b1 * m1 + (1 - b1) * g
        v = b2 * v1 + (1 - b2) * g * g
        return lr * (m / (1 - b1 ** 2)) / (np.sqrt(v / (1 - b2 ** 2)) + 1e-8)

    over, worst = 0, None
    for part in ("gen", "mpd", "msd"):
        for name, p in port32[part].items():
            g32 = p.grad.double().numpy().ravel()
            big = np.abs(g32) > 1e-3 * np.abs(g32).max()
            pp = p.detach().double().numpy().ravel()
            pj = p_jax[part][name].double().numpy().ravel()
            diff = np.where(big, np.abs(pp - pj), 0.0)
            over += int(np.sum(diff > PARAM_ATOL))
            i = int(diff.argmax())
            if worst is None or diff[i] > worst[0]:
                worst = (diff[i], part, name, i, g32, pp[i], pj[i])
    d, part, name, i, g32, pp, pj = worst
    gj = g_jax[part][name].double().numpy().ravel()[i]
    g64 = port64[part][name].grad.numpy().ravel()[i]
    p64 = port64[part][name].detach().numpy().ravel()[i]
    m1 = mu[part][name].double().numpy().ravel()[i]
    v1 = nu[part][name].double().numpy().ravel()[i]
    gmax = np.abs(g32).max()
    uj, up = update(m1, v1, gj), update(m1, v1, g32[i])
    sqrt_v = np.sqrt((b2 * v1 + (1 - b2) * gj * gj) / (1 - b2 ** 2))
    print(f"seed {seed}: {over} parameters over {PARAM_ATOL:.0e} under the "
          f"skip rule; the largest difference, {d:.3e}, at {part}.{name}"
          f"[{i}], |g| / max|g| {abs(g32[i]) / gmax:.3e}")
    print(f"  g: JAX f32 {gj:.6e}, port f32 {g32[i]:.6e}, port f64 "
          f"{g64:.6e}; port f32 vs JAX {abs(g32[i] - gj) / abs(gj):.3e} "
          f"relative, {abs(g32[i] - gj) / gmax:.3e} of max|g|")
    print(f"  JAX's step-1 moments m {m1:.6e}, v {v1:.6e}; √v̂ after step "
          f"2 {sqrt_v:.3e} against eps 1e-8")
    print(f"  AdamW's update from JAX's g {uj:.6e}, from the port's "
          f"{up:.6e}: they differ by {abs(uj - up):.3e}, the parameters "
          f"by {d:.3e}")
    print(f"  distance from the port's f64 step: JAX f32 {abs(pj - p64):.3e},"
          f" port f32 {abs(pp - p64):.3e}", flush=True)
    return over


def main() -> None:
    step = jvoc.make_vocoder_train_step(_cfg(jcfg), donate=False,
                                        paired=True)
    for seed in range(4):
        witness(step, seed)


if __name__ == "__main__":
    main()
