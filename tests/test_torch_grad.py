"""PyTorch port vs the JAX reference: the fused plan's straight-through
(STE) gradients over float masters (`kernels/ops.py` autograd functions
routed by `kernels/dispatch.py`), after the pattern of
`tests/test_grad_parity.py`.

The fused plan's backward is dx = g @ wq^T, dw = xq^T @ g on the decoded
quantized operands, which is what the fake_quant plan's autograd computes:
on the same g the two plans' gradients are held bitwise (f32, 2-D / 3-D
activations; the 4-D grouped form folds its batch dim into the rows, so
its dw sums in another order than fake_quant's broadcast matmul and is
held to the worst-case gap of two f32 sums of its n = B * Cg products,
2 n u sum |xq g| with u = 2^-24).
Against the reference's `jax.grad` through `repro.kernels.dispatch` the
gradients are f32 products taken by two frameworks' CPU matmuls and are
held to rtol = atol = 1e-6.

Model level (`api.apply` logits, `train.step.loss_fn` gradients of the
minitron-8b and command-r-35b smoke configs): without quantization the
two frameworks' f32 sums differ in order only, so logits are held to
rtol = atol = 2e-5 and each gradient leaf to 1e-5 of its largest entry.
Under paper_mixed an activation whose f32 value the frameworks compute one
ulp apart can sit on a P(13,2) rounding boundary and take the adjacent
code (one P(13,2) step is up to 2^-9 of the value): minitron's first
layer comes out 2e-3 apart, and 35 of the 2048 codes of the second
layer's input differ.  There logits are held to 1e-2 and each gradient
leaf to 4e-3 of its largest entry, and, sharper, the port's fused plan is
held bitwise to its fake_quant plan (logits and every gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posit as jposit
from repro.core.formats import P13_2 as JP13_2, P16_2 as JP16_2
from repro.core.quant import QuantPolicy as JPolicy
from repro.kernels import dispatch as jdispatch

from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.core.formats import P13_2, P16_2
from repro_torch.core.quant import QuantPolicy, policy_by_name
from repro_torch.kernels import dispatch, ops
from repro_torch.models import api as tapi
from repro_torch.models import packing as tpacking
from repro_torch.models.module import tree_leaves
from repro_torch.train import step as tstep

RTOL = ATOL = 1e-6
_JFMT = {None: None, P13_2: JP13_2, P16_2: JP16_2}


def _inputs(seed, x_shape, w_shape, g_shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, x_shape).astype(np.float32),
            rng.normal(0, 0.2, w_shape).astype(np.float32),
            rng.normal(0, 1, g_shape).astype(np.float32))


def _torch_grads(fn, x, w, g, policy, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = fn(xt, wt, policy)
    return torch.autograd.grad(out, (xt, wt), torch.from_numpy(g).to(out.dtype))


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


_DENSE = ((3, 5, 40), (40, 24), (3, 5, 24))
_GROUPED = ((4, 6, 40), (4, 40, 24), (4, 6, 24))


@pytest.mark.parametrize("acts", [None, P13_2], ids=["float_act", "act_coded"])
@pytest.mark.parametrize("wfmt", [P16_2, P13_2], ids=["w16", "w13"])
@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
def test_fused_grads_bitwise_fake_quant(acts, wfmt, grouped):
    """The fault this slice repairs: the fused plan over float masters gave
    no weight gradient (float activations) or no gradient at all (coded
    activations).  Now both gradients exist and are, bitwise, the
    fake_quant plan's."""
    fn = dispatch.qdot_grouped if grouped else dispatch.qdot
    x, w, g = _inputs(1, *(_GROUPED if grouped else _DENSE))
    policy = QuantPolicy(weights=wfmt, activations=acts)
    want = _torch_grads(fn, x, w, g, policy)
    got = _torch_grads(fn, x, w, g, policy.with_execution("fused"))
    for a, b in zip(want, got):
        assert torch.equal(_bits(a), _bits(b))


def test_grouped_4d_fused_grads_match_fake_quant():
    """[B, E, Cg, K] activations fold B into the per-expert rows around the
    grouped STE; dx stays bitwise, dw sums over B in another order."""
    x, w, g = _inputs(2, (2, 3, 4, 16), (3, 16, 8), (2, 3, 4, 8))
    policy = QuantPolicy(weights=P16_2, activations=P13_2)
    gx_f, gw_f = _torch_grads(dispatch.qdot_grouped, x, w, g, policy)
    gx_k, gw_k = _torch_grads(dispatch.qdot_grouped, x, w, g,
                              policy.with_execution("fused"))
    assert torch.equal(_bits(gx_f), _bits(gx_k))
    xq = ops.decode(ops.encode(torch.from_numpy(x), P13_2), P13_2)
    n = x.shape[0] * x.shape[2]
    bound = 2 * n * 2.0 ** -24 * torch.einsum(
        "becd,becf->edf", xq.abs(), torch.from_numpy(g).abs())
    assert bool(((gw_k - gw_f).abs() <= bound).all())


def _jax_grads(fn, x, w, g, policy):
    def f(a, b):
        return jnp.sum(fn(a, b, policy) * g)
    return jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("acts", [None, P13_2], ids=["float_act", "act_coded"])
@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
def test_fused_grads_match_reference(acts, grouped):
    """The port's fused gradients against `jax.grad` through the
    reference's dispatch (its custom_vjp STE, Pallas in interpret mode)."""
    x, w, g = _inputs(3, *(_GROUPED if grouped else _DENSE))
    jfn = jdispatch.qdot_grouped if grouped else jdispatch.qdot
    tfn = dispatch.qdot_grouped if grouped else dispatch.qdot
    jpol = JPolicy(weights=JP16_2, activations=_JFMT[acts], execution="fused")
    tpol = QuantPolicy(weights=P16_2, activations=acts, execution="fused")
    want = _jax_grads(jfn, x, w, g, jpol)
    got = _torch_grads(tfn, x, w, g, tpol)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
def test_fused_grads_flow_through_bf16_casts(grouped):
    """Activations arrive in the compute dtype: the casts around the
    f32-only STE functions carry the gradients back (dx bf16, dw f32)."""
    fn = dispatch.qdot_grouped if grouped else dispatch.qdot
    x, w, g = _inputs(4, *(_GROUPED if grouped else _DENSE))
    policy = QuantPolicy(weights=P16_2, activations=P13_2, execution="fused")
    gx, gw = _torch_grads(fn, x, w, g, policy, dtype=torch.bfloat16)
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    assert torch.isfinite(gx.float()).all() and torch.isfinite(gw).all()
    assert gw.abs().sum() > 0


def test_packed_act_coded_grad_raises():
    """Activation-coded fused over packed weights is forward-only: a
    gradient raises instead of coming back silently absent.  Float
    activations over packed weights keep their exact gradient (decode +
    dot), and the forward stays usable."""
    x, w, _ = _inputs(5, *_DENSE)
    xe, we, _ = _inputs(5, *_GROUPED)
    policy = policy_by_name("serve_fused_p16_a13")
    codes = ops.encode(torch.from_numpy(w), P16_2)
    codes_e = ops.encode(torch.from_numpy(we), P16_2)
    for fn, xx, cc in ((dispatch.qdot, x, codes),
                       (dispatch.qdot_grouped, xe, codes_e)):
        xt = torch.from_numpy(xx).requires_grad_()
        with pytest.raises(ValueError, match="packed int weights"):
            fn(xt, cc, policy).sum().backward()
        with torch.no_grad():
            assert fn(xt, cc, policy).shape == xx.shape[:-1] + (24,)
    xt = torch.from_numpy(x).requires_grad_()
    gx, = torch.autograd.grad(
        dispatch.qdot(xt, codes, policy_by_name("serve_fused_p16")).sum(), xt)
    assert torch.isfinite(gx).all() and gx.abs().sum() > 0
    # the reference raises on the same call
    jx = jnp.asarray(x)
    jcodes = jposit.pack(jnp.asarray(w), JP16_2)
    from repro.core.quant import policy_by_name as jpolicy
    with pytest.raises(ValueError, match="packed int weights"):
        jax.grad(lambda a: jdispatch.qdot(
            a, jcodes, jpolicy("serve_fused_p16_a13")).sum())(jx)


def test_prepared_refuses_a_master_that_requires_grad():
    """`Prepared` caches a plan operand; under grad mode it refuses a
    master that trains (it would serve stale codes after an update) and
    keeps serving packed or frozen weights."""
    x, w, _ = _inputs(6, *_DENSE)
    policy = QuantPolicy(weights=P16_2, execution="fused")
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w).requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        dispatch.qdot(xt, dispatch.Prepared(wt), policy)
    with torch.no_grad():
        a = dispatch.qdot(xt, dispatch.Prepared(wt), policy)
    b = dispatch.qdot(xt, dispatch.Prepared(wt.detach()), policy)
    assert torch.equal(a, b)
    assert torch.equal(a, dispatch.qdot(xt, wt, policy).detach())


@pytest.mark.parametrize("acts", [None, P13_2], ids=["float_act", "act_coded"])
def test_ste_functions_save_only_codes(acts):
    """The STE forward keeps the weight codes and the activation codes (or
    the float activations themselves), never a decoded f32 copy."""
    x, w, _ = _inputs(7, (5, 40), (40, 24), (5, 24))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = ops.fused_matmul_ste(xt, wt, acts, P16_2)
    a_res, w_codes = out.grad_fn.saved_tensors
    assert w_codes.dtype == torch.int16
    if acts is None:
        assert a_res is xt or a_res.data_ptr() == xt.data_ptr()
    else:
        assert a_res.dtype == torch.int16


# ---------------------------------------------------------------------------
# model level: logits and loss gradients against the reference
# ---------------------------------------------------------------------------

_PLANS = (("none", "fake_quant"), ("paper_mixed", "fake_quant"),
          ("paper_mixed", "fused"))


def _model_cfgs(arch, policy, execution, **kw):
    from repro import configs as jconfigs
    from repro.core.quant import policy_by_name as jpolicy
    jq, tq = jpolicy(policy), policy_by_name(policy)
    if tq.enabled:
        jq, tq = jq.with_execution(execution), tq.with_execution(execution)
    return (jconfigs.get_smoke(arch).replace(quant=jq, **kw),
            tconfigs.get_smoke(arch).replace(quant=tq, **kw))


def _model_batch(vocab):
    rng = np.random.default_rng(12)
    return {k: rng.integers(0, vocab, (2, 16)).astype(np.int32)
            for k in ("tokens", "labels")}


def _jax_model(jcfg, batch):
    """(logits, loss, {path: grad}) of the reference."""
    from repro.models import api as japi
    from repro.train import step as jstep
    params = japi.init(jax.random.key(1), jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def both(p):
        (loss, _), g = jax.value_and_grad(
            lambda q: jstep.loss_fn(q, jb, jcfg), has_aux=True)(p)
        return japi.apply(p, jb, jcfg), loss, g

    logits, loss, grads = jax.jit(both)(params)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    grads = {"/".join(str(k.key) for k in path): np.asarray(g)
             for path, g in flat}
    return np.asarray(logits), float(loss), grads, params


def _torch_model(tcfg, jparams, batch):
    """(logits, loss, {path: grad}) of the port on the reference's
    parameters."""
    params = tpacking.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = tstep.loss_fn(params, tb, tcfg)
    loss.backward()
    with torch.no_grad():
        logits = tapi.apply(params, tb, tcfg)
    grads = {k: v.grad for k, v in _flatten(params).items()}
    return logits, float(loss.detach()), grads


@pytest.mark.parametrize("plan", _PLANS, ids=["none", "mixed_fake_quant",
                                              "mixed_fused"])
@pytest.mark.parametrize("arch", ["minitron_8b", "command_r_35b"])
def test_model_logits_and_grads_match_reference(arch, plan):
    jcfg, tcfg = _model_cfgs(arch, *plan)
    batch = _model_batch(jcfg.vocab_size)
    jlogits, jloss, jgrads, jparams = _jax_model(jcfg, batch)
    logits, loss, grads = _torch_model(tcfg, jparams, batch)
    quantized = plan[0] != "none"
    tol = 1e-2 if quantized else 2e-5
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=tol, atol=tol)
    assert abs(loss - jloss) <= tol * max(1.0, abs(jloss))
    assert set(grads) == set(jgrads)
    frac = 4e-3 if quantized else 1e-5
    for k, g in grads.items():
        want = jgrads[k]
        gap = float(np.abs(g.numpy() - want).max())
        assert gap <= frac * float(np.abs(want).max()), (k, gap)
    if plan[1] == "fused":
        # sharper: the port's fused plan is its fake_quant plan, bitwise
        _, qcfg = _model_cfgs(arch, plan[0], "fake_quant")
        q_logits, _, q_grads = _torch_model(qcfg, jparams, batch)
        assert torch.equal(_bits(logits), _bits(q_logits))
        for k, g in grads.items():
            assert torch.equal(_bits(g), _bits(q_grads[k])), k


@pytest.mark.parametrize("policy", ["none", "paper_mixed"])
def test_remat_grads_bitwise_equal_no_remat(policy):
    """Recomputing each layer in the backward (cfg.remat "layer") gives,
    bitwise, the gradients of keeping its activations (remat "none")."""
    out = []
    for remat in ("layer", "none"):
        _, tcfg = _model_cfgs("minitron_8b", policy, "fused", remat=remat)
        params = tapi.init(torch.Generator().manual_seed(3), tcfg, "cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v)
                 for k, v in _model_batch(tcfg.vocab_size).items()}
        loss, _ = tstep.loss_fn(params, batch, tcfg)
        loss.backward()
        out.append([loss] + [p.grad for p in tree_leaves(params)])
    for a, b in zip(*out):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("acts", [None, P13_2], ids=["float_act", "act_coded"])
@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
def test_ste_plain_states_the_ste_functions(acts, grouped):
    """`ops.ste_plain`, the plain statement the card checks the STE
    functions against, is on the CPU bitwise what they compute."""
    fn = ops.fused_matmul_grouped_ste if grouped else ops.fused_matmul_ste
    x, w, g = _inputs(8, *(_GROUPED if grouped else ((5, 40), (40, 24),
                                                      (5, 24))))
    x, w, g = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = fn(xr, wr, acts, P16_2)
    got = (out,) + torch.autograd.grad(out, (xr, wr), g)
    for a, b in zip(got, ops.ste_plain(x, w, acts, P16_2, g)):
        assert torch.equal(_bits(a), _bits(b))
