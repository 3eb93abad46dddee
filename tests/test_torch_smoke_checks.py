"""chip_smoke.py's phase-4 check (`_small_reference`) on the CPU, and how
the script derives its training shapes and attributes launches.

The check compares the card's KV codes and logits with the plain CPU
path's.  Here the "card" side runs on the CPU too, so the two sides agree
exactly; a planted +1 on a KV code far from any rounding boundary of the
card side's pages, written in the prefill or in the decode step, one code
or many, must fail the check (`_kv_flips` accepts a differing code only
at a rounding boundary, and at most `_KV_FLIP_LIMIT` of them).
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402

ARCH, POLICY = "gemma3_4b", "serve_fused_p16"
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size ops on one thread: with the suite's other workers busy,
    torch's thread pool waits on taken cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_small_reference_agrees_on_the_cpu():
    assert chip_smoke._small_reference(CPU, POLICY, ARCH) == (0.0, 0.0, 0)


@pytest.mark.parametrize("fn_name,page,row,n_codes", [
    ("prefill_chunk_batched", 1, 5, 1),
    ("decode_step", 2, 4, 1),
    ("decode_step", 2, 4, 10)])
def test_small_reference_rejects_planted_codes(monkeypatch, fn_name, page,
                                               row, n_codes):
    """The second call of `fn_name` is the card side's: its output pages
    get `n_codes` V codes of layer 3 at (page, row) (slot 0's position 5
    in the prefill, 20 in the step) moved up by one, where the code lies
    between 3 and 100 (far from zero and from NaR)."""
    orig = getattr(api, fn_name)
    calls = []

    def planted(*args, **kw):
        out = orig(*args, **kw)
        calls.append(None)
        if len(calls) == 2:
            v = out[1]["v"][3, page, row]
            idx = torch.nonzero((v > 3) & (v < 100))[:n_codes, 0]
            assert len(idx) == n_codes
            v[idx] += 1
        return out

    monkeypatch.setattr(api, fn_name, planted)
    with pytest.raises(SystemExit, match="adjacent one, across a rounding"):
        chip_smoke._small_reference(CPU, POLICY, ARCH)


@pytest.mark.parametrize("arch,dense,experts,capacity", [
    ("minitron_8b", (("wq", 4096, 4096), ("wk", 4096, 1024),
                     ("wv", 4096, 1024), ("wo", 4096, 4096),
                     ("gate", 4096, 16384), ("up", 4096, 16384),
                     ("down", 16384, 4096)), None, None),
    ("qwen3_moe_235b", (("wq", 4096, 8192), ("wk", 4096, 512),
                        ("wv", 4096, 512), ("wo", 8192, 4096)),
     ((4096, 1536), (4096, 1536), (1536, 4096)), 40),
    ("deepseek_moe_16b", (("wq", 2048, 2048), ("wk", 2048, 2048),
                          ("wv", 2048, 2048), ("wo", 2048, 2048),
                          ("gate", 2048, 2816), ("up", 2048, 2816),
                          ("down", 2816, 2048)),
     ((2048, 1408), (2048, 1408), (1408, 2048)), 64)])
def test_training_shapes_follow_the_config(arch, dense, experts, capacity):
    """The K6 / STE shapes the script checks are the full-width config's
    coded GEMMs (deepseek's shared experts 2 x 1408 wide), and K9's are its
    expert GEMMs at the capacity rows of a 512-token microbatch."""
    cfg = configs.get(arch)
    assert chip_smoke._dense_kn(cfg) == dense
    if experts is not None:
        assert chip_smoke._expert_kn(cfg) == experts
        tokens = chip_smoke._train_shape().tokens // chip_smoke.TRAIN_ACCUM
        assert moe.capacity(cfg, tokens) == capacity


def test_attribute_launches_counts_each_launch_once():
    """A record with "paths" counts those runs; one without counts the
    runs no other record of its kernel names; a variant counter reports
    itself as the only variant."""
    runs = {
        "MoE greedy": {"posit_matmul_grouped": 12,
                       "posit_matmul_grouped:p16_2": 12,
                       "posit_matmul_grouped:posit": 0, "posit_decode": 7},
        "train qwen3": {"posit_matmul_grouped": 48,
                        "posit_matmul_grouped:p16_2": 0,
                        "posit_matmul_grouped:posit": 48, "posit_decode": 5},
        "train deepseek": {"posit_matmul_grouped": 192,
                           "posit_matmul_grouped:p16_2": 0,
                           "posit_matmul_grouped:posit": 192,
                           "posit_decode": 3}}
    recs = [dict(name="posit_matmul_grouped"),
            dict(name="K9 qwen3", counter="posit_matmul_grouped:posit",
                 paths=("train qwen3",)),
            dict(name="K9 deepseek", counter="posit_matmul_grouped:posit",
                 paths=("train deepseek",)),
            dict(name="posit_decode")]
    chip_smoke._attribute_launches(recs, runs)
    serving, qwen3, deepseek, decode = recs
    assert serving["launches_by_path"] == {"MoE greedy": 12}
    assert serving["launches_by_variant"] == {"p16_2": 12, "posit": 0}
    assert (qwen3["launches"], qwen3["launches_by_variant"]) == (
        48, {"posit": 48})
    assert (deepseek["launches"], deepseek["launches_by_variant"]) == (
        192, {"posit": 192})
    assert sum(r["launches"] for r in recs[:3]) == sum(
        c["posit_matmul_grouped"] for c in runs.values())
    assert decode["launches"] == 15 and decode["launches_by_variant"] == {}
    assert all(r["route"] == "cuda" for r in recs)


def test_planted_faults_fail_the_sum_bound():
    """The two planted faults exceed `sum_bound` over 2-D and grouped
    operands whose P(13,2) weights all lie below 2^-4, so that they are
    exact in bf16 (as minitron's down projection's at K 16384 are), and a
    bound no gap can pass trips the check."""
    from repro_torch.core.formats import P13_2
    from repro_torch.kernels import posit_codec
    from repro_torch.kernels import posit_matmul as pm
    g = torch.Generator().manual_seed(5)
    for lead, scale in (((), 16), ((3,), 16), ((), 128)):
        a = posit_codec.encode(torch.randn(*lead, 8, 256, generator=g), P13_2)
        w = (torch.randn(*lead, 256, 16, generator=g) / scale).clamp(
            -0.0624, 0.0624)
        b = posit_codec.encode(w, P13_2)
        want = (pm.posit_matmul_grouped_plain(a, b, P13_2, P13_2) if lead
                else pm.posit_matmul_plain(a, b, P13_2, P13_2))
        bound = pm.sum_bound(a, b, P13_2, P13_2)
        A, B = posit_codec.decode(a, P13_2), posit_codec.decode(b, P13_2)
        assert torch.equal(B.to(torch.bfloat16).float(), B)
        chip_smoke._planted_faults("test", A, B, want, bound)
        with pytest.raises(SystemExit):
            chip_smoke._planted_faults("test", A, B, want,
                                       torch.full_like(bound, float("inf")))

