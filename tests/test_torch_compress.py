"""PyTorch port vs the JAX reference: the posit-compressed cross-pod
gradient reduction (`optim/compress.py`) and the compressed train step
(`train.make_train_step_compressed`), on the CPU.

The reference's leaf runs inside one replica and names an axis; here it
runs under `jax.vmap(..., axis_name="pod")`, whose all_to_all / all_gather
/ axis_index act across the vmapped pods in one process.  The port's leaf
takes the pods' tensors as a list.  Same numpy inputs.

Tolerances: the leaf is P(8,2) encodes and decodes (bit-exact codecs) and
f32 adds of decoded codes, then one division by n.  At 2 pods the owner's
sum is one add, so reduced values and residuals are held bitwise.  At 4
pods the port sums the shards in pod order and XLA's reduce in another
(an element of pod 1's segment comes out 6e-8 apart): the reduced values
are still bitwise (the sums round to the same codes here), and each
residual is held to the gap two orders of an n-term f32 sum can show,
2 (n - 1) u sum_j |decoded code j| + 2 u |residual| (u = 2^-24), plus
the previous step's gap, which the residual carries forward.  The train
step runs the smoke minitron-8b (f32, no quantization) on a (2, 2, 1) mesh
against the reference's own step on 4 forced host devices in a subprocess:
the two frameworks' gradients differ in their f32 sum orders (about 1e-6
of the largest entry, `tests/test_torch_grad.py`), and a gradient element
that lies that close to a P(8,2) rounding boundary takes the adjacent
code on one side.  So losses are held to 1e-5, and the parameters and
error trees to a tolerance per element of such a flip: an AdamW step
moves a parameter by at most a few learning rates, so parameters within 4
lr of the reference's with at most 0.1% of them beyond 1e-5; a residual
carries its gradient's gap (median 1e-4, 99th percentile 1.2e-3 of the
leaf's largest |residual| after two steps) and a flip moves it by one
P(8,2) step, so residuals within twice the leaf's largest |residual|,
with at most 1% of them beyond 1e-2 of it (0.08% here).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcompress

from repro_torch import configs as tconfigs
from repro_torch.core.formats import P8_2
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.models import packing as tpacking
from repro_torch.models.module import tree_leaves
from repro_torch.optim import adamw, compress, constant_schedule
from repro_torch.train import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 2e-3
U = 2.0 ** -24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: run this module's torch work on one thread (torch's
    pool stalls when the suite's other workers hold the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grads(rng, n, shape):
    """n pods' gradients with magnitudes across P(8,2)'s range (1e-6 to
    10), some exact zeros."""
    g = rng.normal(0, 1, (n,) + shape) * 10.0 ** rng.uniform(-6, 1, (n,)
                                                               + shape)
    g[..., ::17] = 0.0
    return g.astype(np.float32)


_JLEAF = jax.jit(jax.vmap(
    lambda g, e: jcompress.compressed_psum_leaf(g, e, "pod"),
    axis_name="pod"))


@pytest.mark.parametrize("n,L", [(2, 1001), (4, 1001), (4, 4096), (4, 3)])
def test_leaf_matches_reference_with_error_feedback(n, L):
    """Three steps of error feedback over n pods, a length that needs
    padding (1001 is odd; 3 is shorter than n): every pod's reduced value
    bitwise the reference's (so are the codes the pods exchanged) and
    equal on every pod; the residuals bitwise at 2 pods, within the
    sum-order gap at 4."""
    rng = np.random.default_rng([n, L])
    je = np.zeros((n, L), np.float32)
    te = [torch.zeros(L) for _ in range(n)]
    carried = np.zeros((n, L), np.float32)
    for step in range(3):
        g = _grads(rng, n, (L,))
        # sum_j |decoded code j| at each element (the port's residuals)
        S = sum(np.abs(compress.ops.decode(compress.ops.encode(
            torch.from_numpy(g[j]) + te[j], P8_2), P8_2).numpy())
            for j in range(n))
        jr, je = _JLEAF(g, je)
        jr, je = np.asarray(jr), np.asarray(je)
        tr, te = compress.compressed_psum_leaf(
            [torch.from_numpy(g[i]) for i in range(n)], te)
        for i in range(n):
            assert np.array_equal(tr[i].numpy().view(np.int32),
                                  jr[i].view(np.int32)), (step, i)
            assert torch.equal(tr[i], tr[0])
            if n == 2:
                assert np.array_equal(te[i].numpy().view(np.int32),
                                      je[i].view(np.int32)), (step, i)
            else:
                gap = np.abs(te[i].numpy() - je[i])
                assert (gap <= carried[i] + 2 * (n - 1) * U * S
                        + 2 * U * np.abs(je[i])).all(), (step, i, gap.max())
                carried[i] = gap
        assert int(np.count_nonzero(je)) > 0


def test_tree_matches_reference_and_keeps_structure():
    """`compressed_psum` over a nested tree at 2 pods: leaf by leaf the
    reference's tree version, bitwise, the trees' structure kept;
    `init_error_tree` zeros of the parameters' shapes."""
    rng = np.random.default_rng(3)
    shapes = {"w": (6, 5), "layers": {"k": (2, 4, 3), "b": (7,)}}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in s.items()}

    g = tree(lambda s: _grads(rng, 2, s))
    e = tree(lambda s: rng.normal(0, 1e-3, (2,) + s).astype(np.float32))
    jred, jerr = jax.jit(jax.vmap(
        lambda g, e: jcompress.compressed_psum(g, e, "pod"),
        axis_name="pod"))(g, e)
    pick = lambda t, i: {k: pick(v, i) if isinstance(v, dict)  # noqa: E731
                         else torch.from_numpy(v[i]) for k, v in t.items()}
    tred, terr = compress.compressed_psum([pick(g, 0), pick(g, 1)],
                                          [pick(e, 0), pick(e, 1)])
    for i in range(2):
        assert set(tred[i]) == set(shapes)
        assert set(tred[i]["layers"]) == {"k", "b"}
        for a, b in zip(tree_leaves(tred[i]),
                        tree_leaves(jax.tree.map(lambda x: x[i], jred))):
            assert np.array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(terr[i]),
                        tree_leaves(jax.tree.map(lambda x: x[i], jerr))):
            assert np.array_equal(a.numpy(), np.asarray(b))
    zeros = compress.init_error_tree(pick(g, 0))
    assert all(t.dtype == torch.float32 and not t.any()
               for t in tree_leaves(zeros))
    with pytest.raises(ValueError):
        compress.compressed_psum_leaf([torch.zeros(3)] * 2, [torch.zeros(3)])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_wire_bytes_match_reference(n):
    params = {"a": np.zeros((300, 7), np.float32),
              "b": {"c": np.zeros((11,), np.float32)}}
    tparams = {"a": torch.zeros(300, 7), "b": {"c": torch.zeros(11)}}
    assert compress.wire_bytes(tparams, n) == jcompress.wire_bytes(params, n)


def test_train_mesh_and_step_validation():
    """The (pod, data, model) mesh places every replica by the serving
    mesh's rule; the step refuses another mesh, accum != 1 and a batch
    the replicas do not divide."""
    mesh = make_train_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape == {"pod": 2, "data": 2, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_mesh(2, 2)
    cfg = tconfigs.get_smoke("minitron_8b")
    opt = adamw(constant_schedule(LR))
    with pytest.raises(ValueError, match="accum"):
        tstep.make_train_step_compressed(cfg, opt, mesh, accum=2)
    from repro_torch.launch.mesh import make_serving_mesh
    with pytest.raises(ValueError, match="pod"):
        tstep.make_train_step_compressed(
            cfg, opt, make_serving_mesh(2, devices=["cpu"] * 2))
    ts = tstep.make_train_step_compressed(cfg, opt, mesh)
    state = tstep.init_state(torch.Generator().manual_seed(0), cfg, opt,
                             "cpu")
    err = ts.init_err(state.params)
    assert all(e.shape[0] == 2 for e in tree_leaves(err))
    batch = {k: torch.zeros(6, 8, dtype=torch.int32)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="divisible"):
        ts((state, err), batch)


_REFERENCE_STEPS = """
    import jax, numpy as np, jax.numpy as jnp
    from repro import configs
    from repro.models.config import ShapeConfig
    from repro.optim import adamw, constant_schedule
    from repro.train import step as step_lib
    from repro.data import Pipeline

    out = {out!r}
    cfg = configs.get_smoke("minitron_8b").replace(dtype="float32")
    shape = ShapeConfig("t", 16, 8, "train")
    opt = adamw(constant_schedule({lr!r}))
    mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
    ts = step_lib.make_train_step_compressed(cfg, opt, mesh)
    state = step_lib.init_state(jax.random.key(0), cfg, opt)
    err = ts.init_err(state.params)
    pipe = Pipeline(cfg, shape)
    flat = lambda t, tag: {{tag + "/" + "/".join(str(k.key) for k in p):
                            np.asarray(v) for p, v in
                            jax.tree_util.tree_flatten_with_path(t)[0]}}
    arrays = dict(flat(state.params, "init"))
    losses = []
    carry = (state, err)
    with mesh:
        tsj = jax.jit(ts)
        for s in range(2):
            batch = pipe.batch_at(s)
            for k, v in batch.items():
                arrays[f"batch{{s}}/{{k}}"] = np.asarray(v)
            carry, m = tsj(carry, jax.tree.map(jnp.asarray, batch))
            losses.append(float(m["loss"]))
    arrays.update(flat(carry[0].params, "params"))
    arrays.update(flat(carry[1], "err"))
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(losses, f)
    print("REFERENCE-OK")
"""


def _nested(arrays, tag):
    out = {}
    for key, v in arrays.items():
        if not key.startswith(tag + "/"):
            continue
        node = out
        parts = key[len(tag) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def test_compressed_step_matches_reference_two_steps(tmp_path):
    """Two compressed steps of the smoke minitron-8b on a (2, 2, 1) CPU
    mesh against the reference's `make_train_step_compressed` on 4 forced
    host devices, from the reference's initial parameters and batches:
    losses, parameters and error trees at the module's tolerances."""
    out = str(tmp_path / "ref")
    code = "import json\n" + textwrap.dedent(_REFERENCE_STEPS).format(
        out=out, lr=LR)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0 and "REFERENCE-OK" in r.stdout, r.stderr[-3000:]
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        want_losses = json.load(f)

    cfg = tconfigs.get_smoke("minitron_8b").replace(dtype="float32")
    opt = adamw(constant_schedule(LR))
    mesh = make_train_mesh(2, 2, devices=["cpu"] * 4)
    ts = tstep.make_train_step_compressed(cfg, opt, mesh)
    params = tpacking.params_from_numpy(_nested(arrays, "init"), cfg, "cpu")
    state = tstep.TrainState(params, opt.init(params),
                             torch.zeros((), dtype=torch.int32))
    carry = (state, ts.init_err(params))
    losses = []
    for s in range(2):
        batch = {k: torch.from_numpy(arrays[f"batch{s}/{k}"])
                 for k in ("tokens", "labels")}
        carry, m = ts(carry, batch)
        losses.append(float(m["loss"]))
    assert int(carry[0].step) == 2
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    want_p = tree_leaves(_nested(arrays, "params"))
    got_p = tree_leaves(carry[0].params)
    want_e = tree_leaves(_nested(arrays, "err"))
    got_e = tree_leaves(carry[1])
    assert len(got_p) == len(want_p) == len(got_e) == len(want_e)
    n = far = 0
    for a, b in zip(got_p, want_p):
        gap = np.abs(a.detach().numpy() - b)
        assert gap.max() <= 4 * LR
        far += int((gap > 1e-5).sum())
        n += gap.size
    assert far <= 1e-3 * n, (far, n)
    n = far = 0
    for a, b in zip(got_e, want_e):
        assert a.shape == b.shape
        gap = np.abs(a.numpy() - b)
        top = max(float(np.abs(b).max()), 1e-30)
        assert gap.max() <= 2 * top
        far += int((gap > 1e-2 * top).sum())
        n += gap.size
    assert far <= 1e-2 * n, (far, n)
