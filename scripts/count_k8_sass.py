"""Integer operations of K8's compile-time variant, counted from its SASS:

    python scripts/count_k8_sass.py LIBRARY_OR_LISTING

LIBRARY_OR_LISTING is the built libpdpu_dot.so (disassembled with the CUDA
toolkit's cuobjdump -sass) or a saved listing of it.  In
pdpu_matmul_fixed_kernel the consumer's chunk loop is unrolled over a
slab, with one FLO (the leading-one count of S5) a chunk step, and the
producer decodes 8 codes at a time, with one FLO (the regime's run) a
code.  A step's (a code's) operations are the instructions between the
first and the last FLO of such a run, divided by the number of gaps, less
the memory, barrier and control instructions.  Prints one line "SASS
{json}": step_ops, decode_ops and the runs they came from."""
import json
import re
import statistics
import subprocess
import sys

# not integer operations of the datapath
_SKIP = ("LDS", "STS", "LDG", "STG", "BAR", "NOP", "BRA", "BSSY", "BSYNC",
         "WARPSYNC", "EXIT", "S2R", "S2UR", "LDC", "ULDC", "DEPBAR")
_STEP_GAP = 50   # FLOs at least this far apart belong to the chain's steps


def instructions(text: str, kernel: str = "pdpu_matmul_fixed_kernel"):
    """Opcodes of the kernel's listing, in order."""
    parts = re.split(r"\n\s*Function : ", text)
    body = next(p for p in parts[1:] if kernel in p.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4,6}\*/\s+([^;]*);", body)
    return [re.sub(r"^@!?U?P[T0-9]+\s+", "", o).split()[0].split(".")[0]
            for o in ops]


def _runs(flo, steps: bool):
    """Runs of 8 FLOs with gaps all >= _STEP_GAP (steps) or all below."""
    out = []
    for i in range(len(flo) - 7):
        gaps = [flo[j + 1] - flo[j] for j in range(i, i + 7)]
        if all((g >= _STEP_GAP) == steps for g in gaps):
            out.append((flo[i], flo[i + 7]))
    return out


def _per_gap(ops, run):
    lo, hi = run
    return sum(1 for o in ops[lo:hi] if o not in _SKIP) / 7


def count(text: str) -> dict:
    ops = instructions(text)
    flo = [i for i, o in enumerate(ops) if o == "FLO"]
    steps = [_per_gap(ops, r) for r in _runs(flo, True)]
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
    print("SASS " + json.dumps(count(text)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
