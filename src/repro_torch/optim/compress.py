"""Posit-compressed gradient all-reduce with error feedback (PyTorch port
of `repro.optim.compress`).

Cross-pod gradient reduction is the bandwidth-starved collective at scale,
so the pods exchange P(8,2) codes (a quarter of f32's bytes) over the slow
axis, keep f32 reductions on the fast in-pod axis, and carry the rounding
error forward:

    e      <- error-feedback residual (persistent, same tree as grads)
    q      = posit8_encode(g + e)            # one rounding
    e'     = (g + e) - posit8_decode(q)      # residual stays local
    shards = all_to_all(q)                   # int8 wire
    s      = sum(posit8_decode(shards))      # f32 accumulate, pod order
    out    = all_gather(posit8_encode(s))    # int8 wire, one more rounding
    return posit8_decode(out) / n_pods

The segment owner also folds the sum's own rounding error (s minus the
decode of its codes) into its residual.

The reference's functions run inside one replica under `shard_map` and
name a mesh axis; its collectives act across the replicas.  The port has
no such runtime: a leaf here takes the list of the n pods' tensors (pod i's
on pod i's device, which may repeat: several pods of one card) and
returns one result per pod, with the same algorithm step for step.  The
collectives become explicit moves of tensors between the pods' devices,
and what moves is int8 codes only: the all_to_all hands pod j's segment i
to pod i, the all_gather hands every pod each owner's codes.  On a card
the encode and decode are K2 and K1 (`kernels/ops.encode` / `decode`, the
compile-time `p8_2` variants); on the CPU their plain versions.
`wire_bytes` is the reference's analytical count of one reduction's
traffic.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import P8_2, PositFormat
from repro_torch.kernels import ops, work
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten

# int8 bytes the exchanges handed from one pod to another since the last
# reset (the all_to_all's and the all_gather's codes, whether or not the
# two pods share a device): what `wire_bytes` reckons
BYTES_HANDED = {"int8": 0}


def _pad_to(x, mult: int):
    """x (1-D) with zeros appended up to a multiple of mult."""
    pad = (-x.shape[0]) % mult
    if pad:
        x = torch.cat([x, torch.zeros((pad,), dtype=x.dtype,
                                      device=x.device)])
    return x


def _sum_in_order(terms):
    """terms[0] + terms[1] + ... , one rounding an add, in list order."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def compressed_psum_leaf(gs, errs, fmt: PositFormat = P8_2):
    """One leaf over n pods: gs / errs are lists of n tensors of one shape,
    pod i's gradient and error residual on pod i's device.  Returns (the
    n mean-reduced gradients, the n new residuals), f32, pod i's on its
    device; every pod's reduced gradient holds the same values.  Moves
    between devices carry int8 codes only."""
    n = len(gs)
    if n < 1 or len(errs) != n:
        raise ValueError(f"{n} gradients and {len(errs)} residuals: one of "
                         f"each per pod")
    shape = gs[0].shape
    L = gs[0].numel()
    Ls = -(-L // n)
    codes, new_err = [], []
    for g, e in zip(gs, errs):
        gf = g.reshape(-1).to(torch.float32) + e.reshape(-1)
        q = ops.encode(gf, fmt)                          # int8 codes
        new_err.append(gf - ops.decode(q, fmt))          # stage-1 residual
        codes.append(_pad_to(q, n))
        del gf
    # the all_to_all: owner i receives every pod's segment i, sums it in
    # f32 in pod order and encodes the sum once more
    sums = []
    for i in range(n):
        dev = gs[i].device
        shards = [codes[j][i * Ls:(i + 1) * Ls].to(dev) for j in range(n)]
        BYTES_HANDED["int8"] += (n - 1) * Ls
        if i:   # pod 0's segment i, handed to its owner
            work.exchange("compressed_psum:all_to_all", Ls)
        local_sum = _sum_in_order([ops.decode(s, fmt) for s in shards])
        out_codes = ops.encode(local_sum, fmt)           # second rounding
        # stage-2 residual: the owner folds the sum's rounding error into
        # its own segment (the reference's dynamic_update_slice; the
        # padded tail is cut off again there)
        seg_err = local_sum - ops.decode(out_codes, fmt)
        hi = min(L, (i + 1) * Ls)
        if hi > i * Ls:
            new_err[i][i * Ls:hi].add_(seg_err[:hi - i * Ls])
        sums.append(out_codes)
    # the all_gather: every pod decodes the owners' codes in segment order
    reduced = []
    for i in range(n):
        dev = gs[i].device
        full = torch.cat([s.to(dev) for s in sums])[:L]
        BYTES_HANDED["int8"] += (n - 1) * Ls
        if i:   # pod 0's summed segment, handed to pod i
            work.exchange("compressed_psum:all_gather", Ls)
        total = ops.decode(full, fmt)
        reduced.append((total / torch.tensor(n, dtype=torch.float32,
                                             device=dev)).reshape(shape))
    return reduced, [e.reshape(shape) for e in new_err]


def compressed_psum(grads, err_trees, fmt: PositFormat = P8_2):
    """Tree version over n pods: grads / err_trees are lists of n nested-
    dict trees of one structure.  Returns (n reduced trees, n residual
    trees), leaf by leaf in the trees' sorted-key order."""
    n = len(grads)
    out = [[] for _ in range(n)]
    err = [[] for _ in range(n)]
    for leaves in zip(*(tree_leaves(g) for g in grads),
                      *(tree_leaves(e) for e in err_trees)):
        red, new = compressed_psum_leaf(list(leaves[:n]), list(leaves[n:]),
                                        fmt)
        for i in range(n):
            out[i].append(red[i])
            err[i].append(new[i])
    return ([tree_unflatten(grads[i], out[i]) for i in range(n)],
            [tree_unflatten(err_trees[i], err[i]) for i in range(n)])


def init_error_tree(params):
    """Zero f32 residuals in the parameters' tree, shapes and devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def wire_bytes(params, n_devices: int, fmt: PositFormat = P8_2) -> dict:
    """Analytical wire traffic of one gradient reduction a device: a ring
    all-reduce in f32 against the posit codes' reduce-scatter and
    all-gather."""
    n_elems = sum(x.numel() for x in tree_leaves(params))
    f32 = 2 * n_elems * 4 * (n_devices - 1) / n_devices
    comp = 2 * n_elems * (fmt.storage_bits // 8) * (n_devices - 1) / n_devices
    return {"f32_allreduce_bytes": f32, "posit_bytes": comp,
            "ratio": f32 / comp}
