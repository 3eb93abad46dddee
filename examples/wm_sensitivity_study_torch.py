"""Ablation: accuracy of the PDPU vs alignment width W_m and chunk size N
on the conv1-shaped workload — how a deployment picks the generator
configuration for a target DNN (paper §III-C "suitable alignment width").
The twin of `examples/wm_sensitivity_study.py` over the PyTorch port's
host references; it keeps its own copies of the workload and the hit-rate
metric, so nothing of `benchmarks/` (which imports JAX) is needed.

    PYTHONPATH=src python examples/wm_sensitivity_study_torch.py
"""
import numpy as np

from repro_torch.core import discrete, hwmodel
from repro_torch.core.formats import P13_2, P16_2, PDPUConfig

K_CONV1 = 7 * 7 * 3          # 147 MACs per output (ResNet-style stem)
OUT_CHANNELS = 64


def conv1_workload(n_positions: int = 256, batch: int = 1, seed: int = 0,
                   pad_to: int = 8, rho: float = 0.98):
    """(a, b) float64, row-aligned operand pairs for M = batch *
    n_positions * 64 dot products of length K = 147 (zero-padded to a
    chunk multiple): AR(1)-correlated im2col activations with per-patch
    contrast against He-scaled, zero-mean-per-filter weights, the
    statistics of a ResNet-18 conv1 layer."""
    rng = np.random.default_rng(seed)
    n_patch = batch * n_positions
    eps = rng.normal(0, 1, (n_patch, K_CONV1))
    acts = np.zeros((n_patch, K_CONV1))
    acts[:, 0] = eps[:, 0]
    for k in range(1, K_CONV1):  # AR(1) spatial correlation
        acts[:, k] = rho * acts[:, k - 1] + np.sqrt(1 - rho ** 2) * eps[:, k]
    acts *= 1.0 + 0.5 * np.abs(rng.normal(0, 1, (n_patch, 1)))  # contrast
    weights = rng.normal(0, np.sqrt(2.0 / K_CONV1), (OUT_CHANNELS, K_CONV1))
    weights -= weights.mean(axis=1, keepdims=True)  # edge-detector-like
    a = np.repeat(acts, OUT_CHANNELS, axis=0)          # [M, K]
    b = np.tile(weights, (n_patch, 1))                 # [M, K]
    pad = (-K_CONV1) % pad_to
    if pad:
        a = np.pad(a, ((0, 0), (0, pad)))
        b = np.pad(b, ((0, 0), (0, pad)))
    return a, b


def hit_rate_pct(y, y_ref, tau: float = 0.01) -> float:
    """Share (%) of outputs within relative tolerance tau of the FP64
    reference."""
    rel = np.abs(y - y_ref) / np.maximum(np.abs(y_ref), 1e-300)
    return float(100.0 * (rel < tau).mean())


def main():
    a, b = conv1_workload(n_positions=32, seed=0)
    exact = (a * b).sum(-1)

    print(f"{'N':>3} {'W_m':>4} {'accuracy%':>10} {'hit@1%':>8} "
          f"{'area um2':>9} {'GOPS/mm2':>9}")
    for N in (4, 8):
        for w_m in (8, 10, 12, 14, 18, 24):
            cfg = PDPUConfig(P13_2, P16_2, N=N, w_m=w_m)
            y = discrete.dpu_pdpu_fused(a, b, cfg)
            r = hwmodel.report(cfg)
            print(f"{N:>3} {w_m:>4} {discrete.accuracy_pct(y, exact):>10.2f} "
                  f"{hit_rate_pct(y, exact):>8.2f} {r.area_um2:>9.0f} "
                  f"{r.area_eff:>9.0f}")
    print("\nW_m=14 is the knee: quire-level accuracy at a fraction of the "
          "area (paper Table I).")


if __name__ == "__main__":
    main()
