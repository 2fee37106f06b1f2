"""Training launcher: --arch <id> [--reduced] --steps N ...

The port's copy of `repro.launch.train`, with the reference's flags and
output lines, run as `python -m repro_torch.launch.train`. It trains on
`--device` (default "cuda": without a CUDA device it stops, unless
`--device cpu` is given), from seeded torch weights (`init_lm` on a
`torch.Generator` seeded with --seed; the reference draws
`jax.random.PRNGKey(seed)`), with AdamW under a warmup-cosine schedule on
the synthetic `TokenStream`. Checkpoints (`--ckpt-dir`) are written in the
reference's layout. Encoder-decoder and modality-prefix archs train on
the reference's stub inputs (`stub_inputs`: zero encoder frames or a zero
prefix).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import registry
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.train.step import build_lm_train_step
from repro_torch.train.trainer import train_loop


def stub_inputs(cfg, bs, seq, device):
    out = {}
    if cfg.is_encdec:
        out["enc_embeds"] = torch.zeros((bs, max(seq // 2, 4), cfg.d_model),
                                        dtype=cfg.activation_dtype,
                                        device=device)
    elif cfg.embed_stub:
        out["embeds"] = torch.zeros((bs, max(seq // 4, 2), cfg.d_model),
                                    dtype=cfg.activation_dtype, device=device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on; 'cpu' for tests")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[train] --device cuda, but torch sees no CUDA "
                         "device; pass --device cpu to train on the CPU")

    cfg = registry.get(args.arch, reduced=args.reduced)
    print(f"[train] {cfg.arch_id} reduced={args.reduced} "
          f"params~{cfg.param_count()/1e6:.1f}M backend={device.type}")
    params = T.init_lm(torch.Generator(device).manual_seed(args.seed), cfg)
    opt_init, opt_update = adamw(
        linear_warmup_cosine(args.lr, args.steps // 10 + 1, args.steps))
    opt_state = opt_init(params)
    step = build_lm_train_step(cfg, opt_update,
                               microbatches=args.microbatches)
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    stubs = stub_inputs(cfg, args.batch, args.seq, device)

    def data():
        for b in stream:
            yield {**{k: torch.as_tensor(v, device=device)
                      for k, v in b.items()}, **stubs}

    params, opt_state, log = train_loop(
        step, params, opt_state, data(),
        num_steps=args.steps, log_every=max(args.steps // 20, 1),
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 2, 1), cfg=cfg)
    print(f"[train] loss {log.losses[0]:.4f} -> {log.losses[-1]:.4f} "
          f"over {args.steps} steps")
    return 0


if __name__ == "__main__":
    main()
