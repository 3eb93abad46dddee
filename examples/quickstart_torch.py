"""Quickstart: the paper's PDPU in 40 lines, through the PyTorch port.
The twin of `examples/quickstart.py`.

Builds posit vectors, runs the bit-exact fused dot product at several
configurations, and shows the accuracy/hardware trade-off of the
configurable generator (paper Table I in miniature); then runs the coded
posit GEMM (K6, one encode to P(16,2)) on a CUDA card.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import discrete, hwmodel, posit_np as pnp
from repro_torch.core.formats import P8_2, P13_2, P16_2, PDPUConfig
from repro_torch.kernels import ops


def main(device: str = "cuda"):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    K = 64
    a = rng.normal(0, 1, (8, K))
    b = rng.normal(0, 1, (8, K))
    exact = (a * b).sum(-1)

    print("dot-product of K=64 posit values, out = acc + Va.Vb chunks")
    print(f"{'config':36} {'result[0]':>12} {'mean rel err':>13} "
          f"{'area um2':>9} {'GOPS/W':>7}")
    for cfg in [
        PDPUConfig(P8_2, P8_2, N=4, w_m=10),
        PDPUConfig(P13_2, P16_2, N=4, w_m=14),   # the paper's headline config
        PDPUConfig(P16_2, P16_2, N=8, w_m=14),
        PDPUConfig(P13_2, P16_2, N=4, w_m=256),  # quire (exact) reference
    ]:
        y = discrete.dpu_pdpu_fused(a, b, cfg)
        rel = np.abs(y - exact) / np.abs(exact)
        r = hwmodel.report(cfg)
        print(f"{cfg.name:36} {y[0]:12.6f} {rel.mean():13.2e} "
              f"{r.area_um2:9.0f} {r.energy_eff:7.0f}")

    # the card's fused path: posit codes in, single rounding out (K6)
    am = torch.from_numpy(pnp.encode_np(a, P16_2)).to(torch.int16)
    bm = torch.from_numpy(pnp.encode_np(b.T, P16_2)).to(torch.int16)
    out = ops.fused_matmul(am.to(device), bm.to(device), P16_2, P16_2, P16_2)
    y_kernel = pnp.decode_np(out.cpu().numpy(), P16_2)
    print(f"\nfused posit matmul on {device.type} diag vs exact:",
          np.abs(np.diag(y_kernel) - exact).max())
    return y_kernel


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    main(ap.parse_args().device)
