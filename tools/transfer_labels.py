#!/usr/bin/env python
"""Transfer per-point labels/colors between clouds by nearest neighbour.

CLI rebuild of ref example/GetLabelUsingKDTree.cpp: for each point of the
target cloud, copy the label (color) of its nearest source point — the
KD-tree replaced by the exact brute-force nearest neighbour (ops/knn.py).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("labeled", help="PLY with colors = labels")
    ap.add_argument("target", help="PLY to label")
    ap.add_argument("output")
    ap.add_argument("--max-dist", type=float, default=0.1)
    args = ap.parse_args()

    import jax.numpy as jnp

    from onepiece_tpu.io.ply import read_ply, write_ply_pointcloud
    from onepiece_tpu.ops.knn import knn

    src = read_ply(args.labeled)
    tgt = read_ply(args.target)
    if "colors" not in src:
        raise SystemExit("labeled cloud has no color/label channel")
    idx, d2 = knn(
        jnp.asarray(tgt["vertices"]), jnp.asarray(src["vertices"]),
        jnp.ones(len(src["vertices"]), bool), k=1,
    )
    idx = np.asarray(idx)[:, 0]
    ok = np.asarray(d2)[:, 0] <= args.max_dist**2
    colors = src["colors"][idx]
    colors[~ok] = 0.0
    write_ply_pointcloud(args.output, tgt["vertices"], colors=colors)
    print(f"labeled {ok.sum()}/{len(ok)} points -> {args.output}")


if __name__ == "__main__":
    main()
