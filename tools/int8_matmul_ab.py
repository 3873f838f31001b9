"""Time one checkout's w8a16 ``int8_matmul`` kernel on the card, for an A/B
of two trees.

It imports ``repro_torch`` from ``<root>/src``, builds that checkout's
kernel into ``<root>/build`` and times it as ``chip_smoke.py``'s int8 phase
does (``chip_smoke.int8_times`` of this repository): device time, median of
25 single calls, at M in {1, 4, 8} on a Mixtral-8x7B expert's two matrices
(K=4096 N=14336 and K=14336 N=4096), fp32 and bf16 x, with L2 warm and with
L2 flushed before each call, each beside its bytes bound.  To compare two
commits, unpack the older one with ``git archive`` into an ignored
directory and run, in one call on the card::

    for r in OLD . . OLD; do python3 tools/int8_matmul_ab.py --root $r; done

The last line is a JSON object of the times.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose kernel is timed")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke                       # imports neither torch nor the port here
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels.int8_matmul import int8_matmul_kernel
    from repro_torch.kernels.int8_matmul import kernel as int8_lib
    chip_smoke.phase_card()
    info = int8_lib.LIBRARY.build()
    print(f"[int8-ab] {args.root}: {info['path']} built in {info['seconds']:.2f} s", flush=True)
    rows = chip_smoke.int8_times(int8_matmul_kernel, label=f"int8-ab {args.root}")
    print(json.dumps({"root": args.root, "times": [
        {"m": m, "k": k, "n": n, "x": str(dtype)[6:], **row}
        for (m, k, n, dtype), row in rows.items()]}))


if __name__ == "__main__":
    main()
