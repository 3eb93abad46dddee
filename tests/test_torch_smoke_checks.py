"""chip_smoke.py's phase-4 check (`_small_reference`) on the CPU.

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

from repro_torch.models import api  # noqa: E402

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
