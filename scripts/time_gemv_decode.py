"""The float GEMV's P(16,2) decode candidates on the card, each alone:

    python scripts/time_gemv_decode.py [--out FILE]

Builds scripts/gemv_decode_bench.cu (fast17: posit_decode_fast<16, 2>;
table512: the GEMV's DecodeP16_2Table, 4-byte entries; table512x8: the
same with 8-byte entries; table256: a table over |code|; table32k: every
magnitude in 128 KB of shared memory) with nvcc into
build/gemv_decode/, checks each candidate bitwise against the port's
decode on all 2^16 codes (NaR as nan), then times it decoding 8 codes a
16-byte load and feeding each value to 4 FMAs (the GEMV at M 4), over
codes of P(16,2)-encoded N(0, 1/8192) weights read from L1 / L2, so HBM is
not the limit.  Reports each candidate's time for one command-r-35b
layer's 704,643,072 codes (its bytes bound at 3.35 TB/s: 0.4212 ms) and
its instructions a code in the hot loop, counted from the SASS
(cuobjdump): `alu` the integer pipe (IADD3, LOP3, SHF, PRMT, IABS, FLO,
ISETP, SEL, LEA, MOV, VOTE, FSETP, ...), `fma` the FMA pipe (FFMA,
FADD, IMAD, ...), `mio` shared-memory and global loads, shuffles.  The
warp-uniform full-decode branch of the table candidates (the blocks with
FLO) is left out: it runs only for long-run codes.  Prints one line
"GEMV_DECODE {json}".

`count(text, needles, m, decode_ffma)` is the counter; chip_smoke.py uses
it on the built posit_gemv_f library.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

LAYER_CODES = 704_643_072  # command-r-35b: 2 x 8192^2 + 2 x 8192 x 1024 + 3 x 8192 x 22528
CANDIDATES = ("fast17", "table512", "table256", "table32k", "table512x8")
DECODE_FFMA = {"fast17": 0, "table512": 1, "table256": 1, "table32k": 0,
               "table512x8": 1}
_KERNEL_NAMES = {"fast17": "Fast17", "table512": "Table512E",
                 "table256": "Table256", "table32k": "Table32k",
                 "table512x8": "Table512x8"}

_ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT",
        "IABS", "FLO", "POPC", "BREV", "SEL", "ISETP", "IMNMX", "VIMNMX",
        "LEA", "SGXT", "BMSK", "MOV", "P2R", "R2P", "PLOP3", "VOTE",
        "FSETP", "FSEL", "FMNMX", "CS2R", "UIADD3", "ULOP3", "USHF",
        "UMOV", "ULEA", "UISETP", "USEL", "UPRMT", "VOTEU"}
_FMA = {"FFMA", "FADD", "FMUL", "IMAD", "IMUL", "HFMA2", "HADD2", "HMUL2",
        "UIMAD"}
_MIO = {"LDS", "LDG", "LD", "LDSM", "SHFL", "STS", "STG", "ST", "LDC",
        "ULDC", "ATOMG", "ATOMS", "RED", "LDGSTS"}


def kernel_listing(text: str, needles) -> str:
    """The SASS of the one function whose name holds every needle."""
    parts = re.split(r"\n\s*Function : ", text)
    found = [p for p in parts[1:]
             if all(n in p.split("\n", 1)[0] for n in needles)]
    if len(found) != 1:
        raise ValueError(f"{len(found)} functions match {needles}")
    return found[0]


def _parse(body: str):
    """[(opcode, index of the branch target or None)]: targets as labels
    (`(.L_x_3)`) or as addresses (0x0340)."""
    instrs, labels, addrs = [], {}, {}
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L\w*):", line)
        if lab:
            labels[lab.group(1)] = len(instrs)
            continue
        ins = re.search(r"/\*([0-9a-f]{4,6})\*/\s+([^;]*);", line)
        if not ins:
            continue
        addrs[int(ins.group(1), 16)] = len(instrs)
        text = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins.group(2).strip())
        target = (re.search(r"`\((\.L\w*)\)", text)
                  or re.search(r"\b(0x[0-9a-f]+)\b", text))
        instrs.append((text.split()[0].split(".")[0],
                       target.group(1) if target else None))
    return [(op, labels.get(t, addrs.get(int(t, 16)) if t and t.startswith(
        "0x") else labels.get(t)) if op == "BRA" else None)
        for op, t in instrs], set(labels.values())


def count(text: str, needles, m: int, decode_ffma: int,
          skip_flo: bool = True, codes: int | None = None) -> dict:
    """Instructions a code in the hot loop of the function named by
    `needles`: the backward branch's range with the most FFMAs (the
    smallest of equals), or with `codes` x (m + decode_ffma) of them
    when `codes` is given, less the basic blocks holding FLO when
    `skip_flo` (the table decoders' full-decode branch).  Codes in the
    loop = FFMAs / (m + decode_ffma): m FMAs a value and the decode's
    own."""
    instrs, starts = _parse(kernel_listing(text, needles))
    loops = [(t, i) for i, (op, t) in enumerate(instrs)
             if op == "BRA" and t is not None and t <= i]
    starts |= {t for op, t in instrs if t is not None}
    if not loops:
        raise ValueError(f"no loop in {needles}")

    def ffma(lo, hi):
        return sum(op == "FFMA" for op, _ in instrs[lo:hi + 1])

    if codes is not None:
        loops = [r for r in loops if ffma(*r) == codes * (m + decode_ffma)]
        if not loops:
            raise ValueError(f"no loop of {codes} codes in {needles}")
    lo, hi = max(loops, key=lambda r: (ffma(*r), r[0] - r[1]))
    blocks, cur = [], []
    for i in range(lo, hi + 1):
        if i in starts and cur:
            blocks.append(cur)
            cur = []
        cur.append(instrs[i][0])
        if instrs[i][0] == "BRA":
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    hot = [op for b in blocks if not (skip_flo and "FLO" in b) for op in b]
    codes = hot.count("FFMA") / (m + decode_ffma)
    out = {"codes_a_loop": codes,
           "alu": sum(op in _ALU for op in hot) / codes,
           "fma": sum(op in _FMA for op in hot) / codes,
           "imad": sum(op.startswith("IMAD") for op in hot) / codes,
           "mio": sum(op in _MIO for op in hot) / codes,
           "other": sum(op not in _ALU | _FMA | _MIO for op in hot) / codes}
    return {k: round(v, 3) for k, v in out.items()}


def sass(lib: str) -> str:
    import shutil
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True, timeout=120).stdout


def build() -> str:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    out = os.path.join(ROOT, "build", "gemv_decode")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libgemv_decode_bench.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build._CSRC), "-o", lib,
                           os.path.join(HERE, "gemv_decode_bench.cu")],
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + done.stdout + done.stderr)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON here")
    ap.add_argument("--sass-out", help="also write the SASS listing here")
    args = ap.parse_args()
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import posit
    from repro_torch.core.formats import P16_2
    if not torch.cuda.is_available():
        print("time_gemv_decode: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    lib_path = build()
    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gemv_decode_bench.argtypes = [I, I, P, I, I, I, P, P]
    lib.gemv_decode_bench.restype = I
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # want[c]: the value of the code whose 16 bits are c
    want = posit.decode(posit.to_container(
        torch.arange(1 << 16, dtype=torch.int64), P16_2), P16_2)
    g = torch.Generator().manual_seed(30)
    slices = 64
    codes = posit.pack(torch.randn(slices * 16384, generator=g)
                       / 8192 ** 0.5, P16_2).to(dev)
    blocks, passes = 132 * 8, 41
    total = blocks * 256 * 64 * passes
    out = torch.empty(max(1 << 16, blocks * 256), device=dev)
    text = sass(lib_path)
    if args.sass_out:
        with open(args.sass_out, "w") as f:
            f.write(text)
    result = {"device": torch.cuda.get_device_name(0), "codes": total,
              "layer_codes": LAYER_CODES, "candidates": {}}
    for c, name in enumerate(CANDIDATES):
        err = lib.gemv_decode_bench(c, 0, None, 0, 0, 0, out.data_ptr(),
                                    stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        got = out[:1 << 16].cpu()
        nan = torch.isnan(want)
        ok = (torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32)))
        times = []
        for rep in range(6):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.gemv_decode_bench(c, 1, codes.data_ptr(), slices,
                                        blocks, passes, out.data_ptr(),
                                        stream)
            stop.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            if rep:
                times.append(start.elapsed_time(stop))
        ms = sorted(times)[len(times) // 2]
        try:
            counts = count(text, ("gemv_decode_bench_kernel",
                                  _KERNEL_NAMES[name]), 4,
                           DECODE_FFMA[name], skip_flo=name != "fast17")
        except ValueError as e:
            counts = {"error": str(e)}
        result["candidates"][name] = dict(
            bitwise=ok, ms_total=ms, codes_per_s=total / (ms * 1e-3),
            layer_ms=ms * LAYER_CODES / total, sass=counts)
        print(f"{name}: bitwise {ok}, {total / (ms * 1e-3):.4g} codes/s, "
              f"{ms * LAYER_CODES / total:.4f} ms a command-r layer "
              f"(bytes bound 0.4212), SASS a code {counts}", flush=True)
    result["seconds"] = time.perf_counter() - t0
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print("GEMV_DECODE " + line)
    return 0 if all(v["bitwise"] for v in result["candidates"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
