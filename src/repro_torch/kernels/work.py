"""What each hand kernel moves and computes, from its shapes, and the
launches the kernel wrappers make on meta tensors.

Every function below returns a `Work`: the math flops (two per
multiply-add of a product, as `repro/launch/hlo_analysis.py` counts a
dot), the operations the kernel's datapath runs and the class of unit that
runs them (`rate`: "f32" FMA, "bf16" tensor-core products, "int32"
integer lanes), and the bytes it must move: each input read once, each
output written once.  Its `bound_s` is the least time the card could take
for that work, the larger of bytes over the memory rate and operations
over the peak rate of their class: PERF.md §6's `bound` column states the
same formulas, and `launch/step_analysis.py` adds them up over a step.

A kernel wrapper given meta tensors (`is_meta`) stands where its CUDA
branch would launch: it picks the same variant, makes the same outputs
and scratch (empty, on meta), and hands its launch keys and its `Work` to
`record` instead of launching, so a step analysed on meta counts every
launch the card would make, under the keys `ops.launch_counts()` uses,
and nothing of any plain version.  Where a kernel's work depends on the
data (the keys a row attends, the experts a decode step routes to) the
meta branch, which sees shapes only, counts what the shapes allow at
most: the whole block table, every expert's rows.
"""
from __future__ import annotations

import dataclasses
import math

# the StepAnalysis objects now recording (launch/step_analysis.py), the
# innermost last
_RECORDERS: list = []


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float = 0.0
    ops: float = 0.0
    rate: str = "f32"
    read: float = 0.0
    written: float = 0.0

    @property
    def bytes(self) -> float:
        return self.read + self.written

    def bound_s(self, hw: dict) -> tuple[float, str]:
        """(seconds, "bytes" or "operations"): the larger of the bytes over
        hw["hbm_bw"] and the operations over the peak of their rate."""
        t_b = self.bytes / hw["hbm_bw"]
        t_o = self.ops / hw[PEAK_KEYS[self.rate]]
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# the `launch.mesh.HW` entry of each rate class
PEAK_KEYS = {"f32": "peak_flops_f32", "bf16": "peak_flops_bf16",
             "int32": "peak_int32_ops"}


def is_meta(t) -> bool:
    return t.device.type == "meta"


def count(table: dict, keys):
    """One launch under each of `keys` in a wrapper's LAUNCHES table."""
    for k in keys:
        table[k] = table.get(k, 0) + 1


def record(keys, work: Work):
    """A launch made on meta tensors: its keys and work go to the
    innermost recording analysis (none: nothing is counted)."""
    if _RECORDERS:
        _RECORDERS[-1].kernel(tuple(keys), work)


def exchange(name: str, nbytes: int):
    """Bytes one mesh position hands to another under the exchange
    `name` (the compressed reduction's codes, a sharded pool's partials
    and history), counted by the recording analysis."""
    if _RECORDERS:
        _RECORDERS[-1].exchange(name, nbytes)


def total(works) -> Work:
    """The work of several launches of one kernel (one rate class)."""
    works = list(works)
    return Work(flops=sum(w.flops for w in works),
                ops=sum(w.ops for w in works), rate=works[0].rate,
                read=sum(w.read for w in works),
                written=sum(w.written for w in works))


# ---------------------------------------------------------------------------
# per-kernel work
# ---------------------------------------------------------------------------

def decode(n: int, code_bytes: int) -> Work:
    """K1: n codes read, n f32 values written."""
    return Work(read=n * code_bytes, written=n * 4)


def encode(n: int, code_bytes: int) -> Work:
    """K2: n f32 values read, n codes written."""
    return Work(read=n * 4, written=n * code_bytes)


def gemv_f(M: int, K: int, N: int, x_bytes: int, w_bytes: int) -> Work:
    """The float GEMV: [M, K] float activations x [K, N] codes -> f32,
    f32 FMA."""
    f = 2.0 * M * K * N
    return Work(flops=f, ops=f, read=K * N * w_bytes + M * K * x_bytes,
                written=M * N * 4)


def matmul(M: int, K: int, N: int, a_bytes: int, b_bytes: int,
           out_bytes: int, variant: str) -> Work:
    """K6: [M, K] x [K, N] codes.  The GEMV and tiled variants run f32
    FMA; the split-bf16 tensor-core variants ("tc*") four bf16 products a
    multiply-add (the exact form)."""
    f = 2.0 * M * K * N
    tc = variant.startswith("tc")
    return Work(flops=f, ops=4 * f if tc else f, rate="bf16" if tc else "f32",
                read=M * K * a_bytes + K * N * b_bytes,
                written=M * N * out_bytes)


def grouped(E: int, M: int, K: int, N: int, a_bytes: int, b_bytes: int,
            out_bytes: int, variant: str, experts: int | None = None,
            rows: int | None = None) -> Work:
    """K9: E experts' [M, K] x [K, N]; the codes of `experts` of them (all
    by default) read, `rows` rows computed (all of those experts' by
    default), every expert's activations and output moved."""
    x = E if experts is None else experts
    f = 2.0 * (x * M if rows is None else rows) * K * N
    tc = variant.startswith("tc")
    return Work(flops=f, ops=4 * f if tc else f, rate="bf16" if tc else "f32",
                read=x * K * N * b_bytes + E * M * K * a_bytes,
                written=E * M * N * out_bytes)


def paged_attention(B: int, T: int, Hq: int, Hkv: int, Dh: int,
                    kv_rows: int, kv_bytes: int, table_width: int, keys: int,
                    partials: bool = False, page_ok: bool = False) -> Work:
    """K3 (T 1) / K7: q [B, T, Hq, Dh] f32 read and its output written
    (with a shard's m and l beside it under `partials`), `kv_rows` K and V
    rows read once, the block tables, the lengths and (under `page_ok`) the
    ownership mask; q.k and p.v over `keys` (row, key) pairs, f32 FMA."""
    q = B * T * Hq * Dh * 4
    f = 4.0 * Hq * Dh * keys
    return Work(flops=f, ops=f,
                read=q + 2 * kv_rows * Hkv * Dh * kv_bytes
                + B * table_width * 4 * (2 if page_ok else 1) + B * 4,
                written=q + (2 * B * T * Hq * 4 if partials else 0))


def merge(S: int, rows: int, Dh: int) -> Work:
    """The shard merge: S shards' (o, m, l) partials of `rows` rows read,
    one f32 row written; an exp, two multiplies and two adds a shard and
    element of o, one division an output element."""
    f = 4.0 * S * rows * Dh + rows * Dh
    return Work(flops=f, ops=f, read=S * rows * (Dh + 2) * 4,
                written=rows * Dh * 4)


def decode_sample(B: int, D: int, V: int, w_bytes: int, x_bytes: int,
                  greedy: bool) -> Work:
    """K4: the [D, V] head read once for the B rows, the rows and (when
    sampling) the [B, V] noise read, B tokens written."""
    f = 2.0 * B * V * D
    return Work(flops=f, ops=f,
                read=V * D * w_bytes + B * D * x_bytes
                + (0 if greedy else B * V * 4), written=B * 4)


def prefill_q_terms(variant: str, Dh: int) -> int:
    """bf16 products a q.k multiply-add of the tensor-core K5: three
    (q * scale split exactly), one on tc256 where 1 / sqrt(Dh) is a power
    of two."""
    return 1 if variant == "tc256" and math.frexp(Dh ** -0.5)[0] == 0.5 \
        else 3


def prefill(B: int, C: int, Hq: int, Hkv: int, Dh: int, act_bytes: int,
            page_bytes: int, hist_rows: int, written_rows: int, pairs: int,
            variant: str, chunk_pairs: int = 0, kv_terms: int = 1) -> Work:
    """K5: q, k, v [B, C, ...] read and the output written, the K and V
    of `hist_rows` history rows read, `written_rows` chunk rows encoded
    into the pages; q.k and p.v over `pairs` (query, key) pairs: f32 FMA
    on the SIMT variant, the exact bf16 products on the tensor-core ones
    (`prefill_q_terms` a q.k multiply-add, three a p.v one, each against
    one bf16 term of k / v).  tc_f32 splits k and v too: the
    `chunk_pairs` of the pairs whose key is a chunk row take three terms
    of it, the others (history) `kv_terms` (`prefill_kv_terms`), so a
    multiply-add is 3 x terms bf16 products, q.k and p.v alike."""
    f = 4.0 * pairs * Hq * Dh
    if variant == "simt":
        ops, rate = f, "f32"
    elif variant == "tc_f32":
        ops = 2.0 * Hq * Dh * 2 * 3 * (3 * chunk_pairs
                                       + kv_terms * (pairs - chunk_pairs))
        rate = "bf16"
    else:
        ops = 2.0 * pairs * Hq * Dh * (prefill_q_terms(variant, Dh) + 3)
        rate = "bf16"
    return Work(flops=f, ops=ops, rate=rate,
                read=B * C * (Hq + 2 * Hkv) * Dh * act_bytes
                + 2 * hist_rows * Hkv * Dh * page_bytes,
                written=B * C * Hq * Dh * act_bytes
                + 2 * written_rows * Hkv * Dh * page_bytes)


def pdpu_step_ops(N: int, sticky: bool = True) -> int:
    """Integer operations of one chunk step of one output on K8's fields
    chain (csrc/pdpu_step.cuh, every variant), counted from its source:
    per product a multiply, an exponent add, a sign xor, the exponent max
    and the negative count (5 N); per aligned term (N + 1: the products and
    the accumulator) the shift amount, the kept bits, the sign xor and the
    add (4), and with sticky the dropped bits, their min and the OR (7);
    the exponent max and the sum's start (2); S5 the magnitude, its leading
    one, the left-aligned word and the scale (5); S6's rounding in the log
    domain (24; the run-time variant's 64-bit word, where 32 bits do not
    hold it, takes more) and the accumulator's next fields (4).  The card's
    bound uses the count of the built kernel's SASS
    (scripts/count_k8_sass.py), which the compiler's three-operand adds
    make smaller."""
    return 5 * N + (7 if sticky else 4) * (N + 1) + 2 + 5 + 24 + 4


# operations of one operand decode into fields (csrc/pdpu_step.cuh
# pdpu_operand), counted from its source
PDPU_DECODE_OPS = 20


def pdpu_floor_s(K: int, N: int, step_s: float) -> float:
    """K8's latency floor: one output's K / N chunk steps run one after
    another (each rounds the accumulator the next one reads), so no call
    at that K takes less than the chain of K / N steps of `step_s` each,
    the time of one step on the chain (a lone chain's call over its steps,
    measured on the card)."""
    return (K // N) * step_s


def pdpu(M: int, K: int, N: int, chunk: int, step_ops: float | None = None,
         decode_ops: float = PDPU_DECODE_OPS) -> Work:
    """K8: [M, K] x [K, N] int16 codes -> int32 codes; every chunk step
    of every output `step_ops` integer operations (`pdpu_step_ops(chunk)`
    by default) and every code decoded once (`decode_ops`: the producers
    decode each slab's codes once a block)."""
    step_ops = pdpu_step_ops(chunk) if step_ops is None else step_ops
    return Work(flops=2.0 * M * K * N,
                ops=M * N * (K // chunk) * step_ops
                + (M * K + K * N) * decode_ops, rate="int32",
                read=(M * K + K * N) * 2, written=M * N * 4)
