"""Train a small LM with the paper's mixed-precision posit quantization
(P(13,2) operands, f32 wide accumulation: the PDPU contract) on a CUDA
card through the PyTorch port, and compare against an unquantized run.
The twin of `examples/train_posit_lm.py`.

`--execution` picks the QAT datapath (QuantPolicy.with_execution):

  fake_quant : STE fake-quantization on float dots (K2 encode + K1 decode
               of every operand, then a float matmul).
  fused      : every projection's forward runs the serving kernels (K2
               encode of the f32 masters and activations, K6's coded GEMM;
               the head K2 + K1 + an f32 matmul) and the gradients come
               from the straight-through backward of `kernels/ops.py`.

    PYTHONPATH=src python examples/train_posit_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_posit_lm_torch.py --execution fused
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core.quant import TRAINABLE_PLANS, policy_by_name
from repro_torch.data import DataConfig, Pipeline
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import Trainer, TrainerConfig


def run(quant: str, steps: int, arch: str, execution: str = "fake_quant",
        device: str = "cuda"):
    """Train `arch`'s smoke config for `steps` steps under policy `quant`;
    returns the per-step losses."""
    policy = policy_by_name(quant)
    if policy.enabled:  # 'none' has no formats: nothing to execute fused
        policy = policy.with_execution(execution).require_trainable()
    cfg = configs.get_smoke(arch).replace(quant=policy)
    shape = ShapeConfig("ex", seq_len=128, global_batch=8, kind="train")
    pipe = Pipeline(cfg, shape, DataConfig(seed=0))
    opt = adamw(cosine_schedule(3e-3, warmup=steps // 10, total=steps))
    tr = Trainer(cfg, shape, opt, pipe,
                 TrainerConfig(total_steps=steps, log_every=max(steps // 10, 1),
                               ckpt_every=steps, accum=2), device=device)
    tr.run(torch.Generator(device=tr.device).manual_seed(0))
    return [h["loss"] for h in tr.history]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--arch", default="minitron_8b")
    ap.add_argument("--execution", default="fake_quant",
                    choices=list(TRAINABLE_PLANS),
                    help="QAT datapath: fake_quant (STE on float dots) or "
                         "fused (serving kernels forward, STE backward)")
    args = ap.parse_args()
    base = run("none", args.steps, args.arch)
    mixed = run("paper_mixed", args.steps, args.arch, args.execution)
    n = max(args.steps // 5, 1)
    print(f"\nfinal loss (mean of last {n}):")
    print(f"  float32      : {sum(base[-n:]) / n:.4f}")
    print(f"  P(13,2) mixed: {sum(mixed[-n:]) / n:.4f} "
          f"(execution={args.execution})")


if __name__ == "__main__":
    main()
