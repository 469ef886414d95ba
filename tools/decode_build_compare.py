"""The split-KV decode kernel of this checkout against another build of its
source, on one CUDA card: the same bits, and each one's time.

    python tools/decode_build_compare.py --other PATH/decode_attention.cu

Builds ``--other`` with the port's ``nvcc`` flags into
``src/repro_torch/kernels/decode_attention/build/other/`` and loads it beside
this checkout's library.  For every head dim both builds take, both dtypes
and G 1, 2, 4 and 8, at a capacity that is no multiple of the key tile and
at the serving shape (B 8, H 16, KV 8, S 640, D 128), it launches both at
cache lengths 0, 1, each split's first and last key +-1 and the capacity,
and at one length a row, and requires the outputs and the lse equal bit for
bit.  Then it times both at the serving shape in bf16 from a CUDA graph, in
turns (this, other, other, this), and prints the card.  Head dims only this
checkout's build takes (``ops.HEAD_DIMS``) are held to the plain version
instead.  Run from a checkout; exits 1 on any difference.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="another decode_attention.cu")
    ap.add_argument("--dims", default="32,64,128",
                    help="head dims both builds take")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cs.log(cs.card_line())
    mine = ops.load_library()
    out_dir = ops._HERE / "build" / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "decode_attention.cu"
    src.write_bytes(args.other.read_bytes())
    other = _build.load(src, _build.library_path(src, out_dir, "lib.so"),
                        ops._configure)
    for line in (ops.library_path().parent / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            cs.log(f"  ptxas: {line.strip()}")

    def run(lib, q, k, v, lens):
        saved = ops._lib
        ops._lib = lib
        try:
            return ops.launch(q, k, v, lens, ops.plan_for(q, k))
        finally:
            ops._lib = saved

    gen = torch.Generator(device=dev).manual_seed(0)
    dims = [int(d) for d in args.dims.split(",")]
    shapes = [(3, KV * G, KV, 200, D) for D in dims for G in ops.GROUPS
              for KV in (2,)] + [(8, 16, 8, 640, 128)]
    same = held = 0
    for B, H, KV, S, D in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = [torch.randn(s, generator=gen, device=dev, dtype=dtype)
                       for s in ((B, H, D), (B, KV, S, D), (B, KV, S, D))]
            n_split, split_keys = ops.plan_for(q, k)
            lens = {0, 1, S - 1, S}
            for j in range(n_split):
                for e in (j * split_keys, min((j + 1) * split_keys, S) - 1):
                    lens.update((e - 1, e, e + 1))
            cases = [torch.tensor([L], dtype=torch.int32, device=dev)
                     for L in sorted(x for x in lens if 0 <= x <= S)]
            cases.append(torch.randint(0, S + 1, (B,), generator=gen,
                                       device=dev, dtype=torch.int32))
            for lt in cases:
                a, b = run(mine, q, k, v, lt), run(other, q, k, v, lt)
                torch.cuda.synchronize()
                if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                    cs.log(f"DIFFER: B{B} H{H} KV{KV} S{S} D{D} {dtype} "
                           f"lens {lt.tolist()}")
                    return 1
                same += 1
    cs.log(f"[bits] {same} launches of both builds at D {dims}, fp32 and "
           f"bf16, G {ops.GROUPS}: outputs and lse equal bit for bit")
    for D in sorted(set(ops.HEAD_DIMS) - set(dims)):
        for dtype in (torch.float32, torch.bfloat16):
            for G in ops.GROUPS:
                B, KV, S = 3, 2, 300
                q, k, v = [torch.randn(s, generator=gen, device=dev, dtype=dtype)
                           for s in ((B, KV * G, D), (B, KV, S, D), (B, KV, S, D))]
                for L in (0, 1, 35, 36, 37, 64, 191, 192, 299, 300):
                    lt = torch.tensor([L], dtype=torch.int32, device=dev)
                    out, lse = ops.decode_mha(q, k, v, lt)
                    want, want_lse = ref.decode_attention_ref(q, k, v, lt)
                    torch.testing.assert_close(out.float(), want.float(),
                                               **cs.DECODE_TOL[dtype])
                    torch.testing.assert_close(lse, want_lse,
                                               **cs.DECODE_TOL[dtype])
                    held += 1
    cs.log(f"[plain] {held} launches at the head dims only this build takes "
           f"({sorted(set(ops.HEAD_DIMS) - set(dims))}) within the decode "
           f"tolerance of the plain version")
    q, k, v = [torch.randn(s, generator=gen, device=dev, dtype=torch.bfloat16)
               for s in ((8, 16, 128), (8, 8, 640, 128), (8, 8, 640, 128))]
    lt = torch.tensor([544], dtype=torch.int32, device=dev)
    times = {"this": [], "other": []}
    for who in ("this", "other", "other", "this"):
        lib = mine if who == "this" else other
        times[who].append(cs.graph_ms(lambda: run(lib, q, k, v, lt)))
    cs.log(f"[time] serving shape B8 H16 KV8 S640 D128 bf16 cache_len 544, a "
           f"launch from a CUDA graph (this, other, other, this): this "
           f"{times['this']}, other {times['other']} ms, on {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
