"""Time variants of the correlation kernels against each other.

    python tools/corr_variants.py [variant ...]

Builds `deflicker_torch/csrc/corr_lookup.cu` as written and with each named
variant's text substitutions (all builds at once, into
`build/corr_variants/`), then times the band, shared and resident bodies of
every build at the flow engine's shape (8 x 54 x 96, D = 256, four levels;
flows of +-0.5, +-3 and +-40 px) in turns (as written, variants, variants
reversed, as written), and prints each build's device ms and its error
against the plain twin.  Variants of the tensor-core kernel (shared and
resident bodies):

  terms3       f1 as three bf16 terms (all its bits) instead of two, with
               two ring stages a warpgroup instead of three (the same
               shared memory)
  no_select    the accumulators are not written into the tables
  no_output    the tables are not combined into the output
  no_products  no wgmma is issued (the ring still runs)

and of the band body's window products (the band body, and the shared and
resident bodies' tiles that do not stage):

  band_no_products  the window rows are loaded, but folded by xor instead
                    of multiplied on the tensor cores
  band_no_loads     no window row is loaded: the products take registers
  band_skeleton     both: neither loads nor products, the rest of the loop
  band_no_join      a position's four lanes are not joined by shuffles
  band_no_output    the band body writes one value a level instead of 81
                    (every table still written)

Only `terms3` computes the lookup; the others measure what a part of a
kernel costs.  Needs a CUDA card and nvcc; prints the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402

VARIANTS = {
    "terms3": [("constexpr int TERMS = 2;", "constexpr int TERMS = 3;"),
               ("constexpr int RING = 3;", "constexpr int RING = 2;")],
    "no_select": [("    select_group<STAGED>(acc, q, Wl, P, rx, ry, tables, g, lt);",
                   "    hopper::fence_acc(acc);")],
    "no_output": [("        table_to_out(wtab + i * (K1 * K1), wx, wy, p.inv_sqrt_d,\n"
                   "                     p.out + pix * L * (K * K) + l * (K * K), lane);",
                   "        (void)pix;")],
    "no_products": [("          wgmma_m64n128<0, 0>(acc, sw128_desc(A + (t * KC + kc) * ATOM + 32 * k, 16, 1024),\n"
                     "                              sw128_desc(bsrc + 32 * k, 16, 1024));",
                     "          ;")],
    "band_no_products": [
        ("            mma16816(c[u], word(q[2 * u][w], 2 * v), word(q[2 * u + 1][w], 2 * v),\n"
         "                     word(q[2 * u][w], 2 * v + 1), word(q[2 * u + 1][w], 2 * v + 1),\n"
         "                     bf[2 * u / RP][w][2 * v], bf[2 * u / RP][w][2 * v + 1]);",
         "            c[u][(w + v) & 3] += __uint_as_float(\n"
         "                (word(q[2 * u][w], 2 * v) ^ word(q[2 * u + 1][w], 2 * v) ^\n"
         "                 word(q[2 * u][w], 2 * v + 1) ^ word(q[2 * u + 1][w], 2 * v + 1)) & 0x3f7fffffu);")],
    "band_no_loads": [("q[k][w] = __ldg(src[k] + STEP * w);",
                       "q[k][w].x ^= bf[0][w][0] + (uint32_t)k;")],
    "band_no_join": [("      const float half = mine + __shfl_xor_sync(FULL, mine, 1);\n"
                      "      const float tot = half + __shfl_xor_sync(FULL, half, 6);",
                      "      const float tot = mine;")],
    "band_no_output": [("    table_to_out(table, c.wx, c.wy, inv_sqrt_d, o + l * (K * K), lane);",
                        "    if (lane == 0) o[l * (K * K)] = table[0] + table[K1 * K1 - 1];")],
}
VARIANTS["band_skeleton"] = VARIANTS["band_no_products"] + VARIANTS["band_no_loads"]


def start_build(name: str, subs) -> tuple:
    from deflicker_torch.ops.cuda import build

    out = ROOT / "build" / "corr_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for path in build.sources("corr_lookup"):
        shutil.copy(path, out / path.name)
    src = out / "corr_lookup.cu"
    text = src.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: text to replace found {text.count(old)} times")
        text = text.replace(old, new)
    src.write_text(text)
    lib = out / "libcorr_lookup.so"
    proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)])
    return proc, lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("corr_variants: no CUDA device", file=sys.stderr)
        return 1
    from deflicker_torch.ops.cuda import build
    from deflicker_torch.ops.cuda import corr_kernel as C

    names = sys.argv[1:] or list(VARIANTS)
    print(S.nvidia_smi_line(), flush=True)
    procs = {"written": start_build("written", [])}
    procs.update({n: start_build(n, VARIANTS[n]) for n in names})
    libs = {}
    for n, (proc, lib) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {n}")
        libs[n] = ctypes.CDLL(str(lib))
    order = ["written", *names, *reversed(names), "written"]
    device = torch.device("cuda:0")
    _, B, H, W, D, _ = S.CORR_CASES[0]
    results = {}
    for spread in S.CORR_SPREADS:
        f1, _, stored, coords = S.corr_case(B, H, W, D, spread, device)
        want = C.corr_lookup_plain(f1, stored, coords)
        for n in order:
            build._loaded["corr_lookup"] = libs[n]
            for body in C.BODIES:
                got = C.corr_lookup_cuda(f1, stored, coords, body=body)
                torch.cuda.synchronize()
                ms = S.cuda_ms(lambda: C.corr_lookup_cuda(f1, stored, coords, body=body))
                r = results.setdefault(f"{body} +-{spread} {n}", {
                    "ms": [], "rel_err": S.rel_err(got, want),
                    "max_abs_err": S.abs_err(got, want),
                    "max_abs_plain": float(want.abs().max())})
                r["ms"].append(ms)
    for key, r in results.items():
        print(key, json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
