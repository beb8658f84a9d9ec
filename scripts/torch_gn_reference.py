#!/usr/bin/env python3
"""The JAX package's Gauss-Newton poses for the kernel's card tests, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_gn_reference.py [--write FILE]

Feeds the JAX package's ``optimal_tf_gauss_newton`` (float32, as it
computes) the problems of ``mp2p_icp_tpu_torch.eval.gn_problem`` at the
cells' shapes, the ones ``tests/test_torch_gn_kernel.py`` holds the kernel
to: 6,144 pt2pl rows (the odometry), 8,192 pt2pt rows (the scan to map) and
8,192 + 8,192 rows (Adaptive), seeds 10-13 each, with ``PARAMS`` (3 inner
iterations, pair weights pt2pt 0.5 and pt2pl 2). Prints one JSON object
({"params", "cases": [{seed, n_pt, n_pl, R, t}]}); ``--write`` also writes
it to a file. The kernel's card test reads
``scripts/torch_gn_reference.json``, written so with the defaults, and
``tests/test_torch_solvers.py`` checks that file against this script.

This script is not part of the port: it imports both packages. JAX runs on
the CPU (set JAX_PLATFORMS=cpu).
"""

import argparse
import dataclasses
import functools
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mp2p_icp_tpu.core import pairings as jp  # noqa: E402
from mp2p_icp_tpu.core import se3 as jse3  # noqa: E402
from mp2p_icp_tpu.solvers import gauss_newton as jgn  # noqa: E402
from mp2p_icp_tpu.solvers.common import PairWeights  # noqa: E402
from mp2p_icp_tpu_torch.core.pairings import BLOCK_TYPES  # noqa: E402
from mp2p_icp_tpu_torch.eval.gn_problem import gn_problem  # noqa: E402

REFERENCE = HERE / "torch_gn_reference.json"
SHAPES = ((0, 6144), (8192, 0), (8192, 8192))  # (pt2pt rows, pt2pl rows)
SEEDS = (10, 11, 12, 13)
PARAMS = dict(max_iterations=3, pt2pt=0.5, pt2pl=2.0)
JAX_BLOCKS = dict(pt2pt=jp.PairsPt2Pt, pt2pl=jp.PairsPt2Pl, pt2ln=jp.PairsPt2Ln,
                  ln2ln=jp.PairsLn2Ln, pl2pl=jp.PairsPl2Pl)


def jax_inputs(pairings, guess):
    """The port's (Pairings, Pose) on the CPU as the JAX package's: the live
    blocks field by field, every other block one empty row."""
    blocks = {}
    for name in BLOCK_TYPES:
        if name in pairings.live:
            b = getattr(pairings, name)
            blocks[name] = JAX_BLOCKS[name](**{f.name: jnp.asarray(getattr(b, f.name).numpy())
                                               for f in dataclasses.fields(b)})
        else:
            blocks[name] = JAX_BLOCKS[name].empty(1)
    pot = jnp.asarray(np.int32(int(pairings.potential_pairings)))
    return (jp.Pairings(**blocks, potential_pairings=pot),
            jse3.Pose(jnp.asarray(guess.R.numpy()), jnp.asarray(guess.t.numpy())))


@functools.lru_cache(maxsize=None)
def _solve():
    params = jgn.GNParams(max_iterations=PARAMS["max_iterations"],
                          pair_weights=PairWeights(pt2pt=PARAMS["pt2pt"],
                                                   pt2pl=PARAMS["pt2pl"]))
    return jax.jit(lambda p, g: jgn.optimal_tf_gauss_newton(p, g, params))


def jax_pose(n_pt, n_pl, seed):
    """(R, t) as float32 numpy: the JAX package's solve of one problem."""
    out = _solve()(*jax_inputs(*gn_problem(seed, n_pt, n_pl)))
    return np.asarray(out.R, np.float32), np.asarray(out.t, np.float32)


def reference():
    cases = []
    for n_pt, n_pl in SHAPES:
        for seed in SEEDS:
            R, t = jax_pose(n_pt, n_pl, seed)
            cases.append({"seed": seed, "n_pt": n_pt, "n_pl": n_pl,
                          "R": [float(x) for x in R.ravel()], "t": [float(x) for x in t]})
    return {"params": PARAMS, "cases": cases}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", default=None, help="also write the JSON here")
    args = ap.parse_args()
    text = json.dumps(reference())
    print(text)
    if args.write:
        pathlib.Path(args.write).write_text(text + "\n")


if __name__ == "__main__":
    main()
