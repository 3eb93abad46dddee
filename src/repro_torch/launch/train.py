"""Training entry point, the twin of `repro.launch.train`:

    python -m repro_torch.launch.train --arch gemma3_4b --smoke --steps 200
    python -m repro_torch.launch.train --arch mamba2_1_3b --smoke \
        --quant paper_mixed

`--smoke` trains the config's smoke size (the same code path end to end:
models, quantization, trainer, checkpointing); `--device cpu` runs every
kernel's plain version.  The reference names `--grad-compress` in its
docstring, but its parser takes no such flag, so neither does this one;
the posit-compressed cross-pod step is
`train.make_train_step_compressed` on a `launch.mesh.make_train_mesh`.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.core.quant import policy_by_name
from repro_torch.data import DataConfig, Pipeline
from repro_torch.models.config import ShapeConfig, shape_by_name
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--quant", default="none",
                    help="none|paper_mixed|uniform_p16|serve_p16_kv8")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--shape", default=None,
                    help="assigned shape name (full-scale); default custom")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = cfg.replace(quant=policy_by_name(args.quant))
    if args.shape:
        shape = shape_by_name(args.shape)
    else:
        shape = ShapeConfig("custom", args.seq, args.batch, "train")

    pipe = Pipeline(cfg, shape, DataConfig(seed=0))
    opt = adamw(cosine_schedule(args.lr, warmup=max(args.steps // 20, 1),
                                total=args.steps))
    trainer = Trainer(cfg, shape, opt, pipe,
                      TrainerConfig(total_steps=args.steps, log_every=10,
                                    ckpt_every=max(args.steps // 4, 1),
                                    ckpt_dir=args.ckpt_dir, accum=args.accum),
                      device=args.device)
    state = trainer.run(torch.Generator(device=trainer.device).manual_seed(0))
    print(f"[train] done at step {int(state.step)}; "
          f"final loss {trainer.history[-1]['loss']:.4f}; "
          f"throughput {trainer.history[-1]['tokens_per_s']:.0f} tok/s")
    return trainer


if __name__ == "__main__":
    main()
