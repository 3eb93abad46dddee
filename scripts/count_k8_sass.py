"""Integer operations of a K8 variant, counted from its SASS:

    python scripts/count_k8_sass.py LIBRARY_OR_LISTING [KERNEL [STEPS]]

LIBRARY_OR_LISTING is the built libpdpu_dot.so (disassembled with the CUDA
toolkit's cuobjdump -sass) or a saved listing of it; KERNEL a substring of
the instantiation's mangled name (the bit_exact policy's p13_16_n4,
`PdpuFixedILi13ELi16ELi2ELi4ELi14ELi2ELb1EE`, by default); STEPS the chunk
steps a 32-deep slab unrolls (32 / N, at most 8; 8 by default).  In
pdpu_fields_kernel the consumer's chunk loop is unrolled over a slab,
with one FLO (the leading-one count of S5) a chunk step, and the producer
decodes 8 codes at a time, with one FLO (the regime's run) a code.  A
step's (a code's) operations are the instructions between the first and
the last FLO of such a run, divided by the number of gaps, less the
memory, barrier and control instructions.  Prints one line "SASS {json}":
step_ops, decode_ops and the runs they came from."""
import json
import re
import statistics
import subprocess
import sys

# not integer operations of the datapath
_SKIP = ("LDS", "STS", "LDG", "STG", "BAR", "NOP", "BRA", "BSSY", "BSYNC",
         "WARPSYNC", "EXIT", "S2R", "S2UR", "LDC", "ULDC", "DEPBAR")
_STEP_GAP = 50   # FLOs at least this far apart belong to the chain's steps


FIXED = "PdpuFixedILi13ELi16ELi2ELi4ELi14ELi2ELb1EE"


def instructions(text: str, kernel: str = FIXED):
    """Opcodes of the kernel's listing, in order."""
    parts = re.split(r"\n\s*Function : ", text)
    body = next(p for p in parts[1:] if kernel in p.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4,6}\*/\s+([^;]*);", body)
    return [re.sub(r"^@!?U?P[T0-9]+\s+", "", o).split()[0].split(".")[0]
            for o in ops]


def _runs(flo, steps: bool, n: int = 8):
    """Runs of n FLOs with gaps all >= _STEP_GAP (steps) or all below."""
    out = []
    for i in range(len(flo) - n + 1):
        gaps = [flo[j + 1] - flo[j] for j in range(i, i + n - 1)]
        if all((g >= _STEP_GAP) == steps for g in gaps):
            out.append((flo[i], flo[i + n - 1]))
    return out


def _per_gap(ops, run, n: int = 8):
    lo, hi = run
    return sum(1 for o in ops[lo:hi] if o not in _SKIP) / (n - 1)


def count(text: str, kernel: str = FIXED, steps_per_slab: int = 8) -> dict:
    ops = instructions(text, kernel)
    flo = [i for i, o in enumerate(ops) if o == "FLO"]
    n = steps_per_slab
    steps = [_per_gap(ops, r, n) for r in _runs(flo, True, n)]
    codes = [_per_gap(ops, r) for r in _runs(flo, False)]
    if not steps or not codes:
        raise ValueError("no unrolled chunk steps / decodes found")
    return {"step_ops": statistics.median(steps),
            "decode_ops": statistics.median(codes),
            "step_runs": len(steps), "decode_runs": len(codes),
            "instructions": len(ops)}


def main() -> int:
    path = sys.argv[1]
    if path.endswith(".so"):
        text = subprocess.run(["cuobjdump", "-sass", path], check=True,
                              capture_output=True, text=True).stdout
    else:
        text = open(path).read()
    args = sys.argv[2:4]
    print("SASS " + json.dumps(count(text, *(args[:1]),
                                     *map(int, args[1:2]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
