"""Post-training quantization study: model-level analogue of Table I,
through the PyTorch port.  The twin of `examples/ptq_study.py`.

Trains a small LM in float32 on a CUDA card, then evaluates held-out
cross-entropy with weights quantized to each storage format — the
deployment question PDPU answers: which posit format serves this model
with how much quality loss, at what hardware cost (generator model).

    PYTHONPATH=src python examples/ptq_study_torch.py --steps 300
    PYTHONPATH=src python examples/ptq_study_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import posit
from repro_torch.core.formats import P8_2, P10_2, P13_2, P16_2
from repro_torch.data import DataConfig, Pipeline
from repro_torch.models import api
from repro_torch.models.config import ShapeConfig
from repro_torch.models.module import param_count, tree_map
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import Trainer, TrainerConfig, step as step_lib

SHAPE = ShapeConfig("ptq", seq_len=128, global_batch=8, kind="train")


def train(arch: str, steps: int, device):
    """`arch`'s smoke config trained in float32 for `steps` steps; returns
    (cfg, params)."""
    cfg = configs.get_smoke(arch)
    pipe = Pipeline(cfg, SHAPE, DataConfig(seed=0))
    opt = adamw(cosine_schedule(3e-3, warmup=steps // 10, total=steps))
    tr = Trainer(cfg, SHAPE, opt, pipe,
                 TrainerConfig(total_steps=steps,
                               log_every=max(steps // 5, 1),
                               ckpt_every=steps, accum=1), device=device)
    state = tr.run(torch.Generator(device=tr.device).manual_seed(0))
    return cfg, state.params


def eval_batches(cfg, device, n: int = 4):
    """The held-out batches (seed 777) on `device`."""
    pipe = Pipeline(cfg, SHAPE, DataConfig(seed=777))
    return [{k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch_at(i).items()} for i in range(n)]


def ptq_rows(params, cfg, batches):
    """[(format name, mean held-out CE, bits)]: float32, bfloat16, float16
    and each posit storage format, every weight of 2 or more dims rounded
    to it."""
    def ce_with(quantize):
        q = tree_map(lambda p: quantize(p) if p.ndim >= 2 else p, params)
        with torch.no_grad():
            return float(np.mean([float(step_lib.loss_fn(q, b, cfg)[0])
                                  for b in batches]))

    rows = [("float32 (reference)", ce_with(lambda p: p), 32)]
    rows.append(("bfloat16", ce_with(
        lambda p: p.to(torch.bfloat16).to(torch.float32)), 16))
    rows.append(("float16", ce_with(
        lambda p: p.to(torch.float16).to(torch.float32)), 16))
    for fmt in (P16_2, P13_2, P10_2, P8_2):
        rows.append((str(fmt), ce_with(
            lambda p, f=fmt: posit.quantize(p, f)), fmt.n))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="minitron_8b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg, params = train(args.arch, args.steps, args.device)
    rows = ptq_rows(params, cfg, eval_batches(cfg, params["embed"].device))
    base = rows[0][1]
    n = param_count(api.param_specs(cfg))
    print(f"\nPTQ held-out CE ({cfg.name}, {n/1e3:.0f}K params, "
          f"{args.steps} train steps):")
    print(f"{'format':22} {'eval CE':>9} {'delta':>8} {'bits':>5} "
          f"{'weight MB/1B-params':>20}")
    for name, ce, bits in rows:
        print(f"{name:22} {ce:9.4f} {ce-base:+8.4f} {bits:5d} "
              f"{bits/8*1000:20.0f}")
    p16 = dict((r[0], r[1]) for r in rows)
    ok = (p16["P(16,2)"] - base) < 0.01 and (p16["P(13,2)"] - base) < 0.05
    print("\nposit-16 serves at float quality, posit-13 within noise — the "
          "paper's mixed-precision deployment claim." if ok else
          "\nWARNING: posit quality gap larger than expected on this run.")
    return rows


if __name__ == "__main__":
    main()
