"""icp-log-viewer: render an .icplog record as a text report, PNG images
or a standalone interactive WebGL page.

Port of ``mp2p_icp_tpu/apps/icp_log_viewer.py`` (reference:
apps/icp-log-viewer/main.cpp, a nanogui/OpenGL browser). The text report
(iterations, termination, quality, pairings, result, covariance diagonal,
the per-iteration trace with the residuals of the recorded pairings) is
the JAX app's, line for line; the residuals are formed on the log's device
(``--device``). ``--html`` writes the page of apps/html_viewer.py (an
iteration slider re-posing the local map, pairing lines). ``-o`` renders
before/after overlays and, with ``-i N``, the pairings of iteration N; it
needs matplotlib, which is imported only there.

Usage:
  python -m mp2p_icp_tpu_torch.apps.icp_log_viewer run.icplog.npz [--html out.html]
      [-o PREFIX [-i N]] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="icp-log-viewer")
    ap.add_argument("input", help=".icplog.npz record")
    ap.add_argument("-o", "--output-prefix", default=None, help="write <prefix>_overlay.png")
    ap.add_argument("-i", "--iteration", type=int, default=None,
                    help="render the recorded pairings of iteration N (requires -o for the "
                         "output path and a log written with record_pairings)")
    ap.add_argument("--html", default=None,
                    help="write a standalone interactive WebGL viewer: live iteration slider "
                         "re-posing the local map + pairing lines (apps/html_viewer.py)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    if args.iteration is not None and not args.output_prefix:
        ap.error("-i/--iteration renders a PNG frame and needs -o/--output-prefix")

    from mp2p_icp_tpu_torch.io.icplog import load_log

    with on_device(args.device) as device:
        log = load_log(args.input, device=device)
        if args.html:
            from mp2p_icp_tpu_torch.apps.html_viewer import export_icplog_html

            export_icplog_html(log, args.html)
            print(f"wrote {args.html}")
        _report(log)
        if args.output_prefix:
            _render_png(log, args.output_prefix, args.iteration)
    return 0


def _posed(pose_R, pose_t, xyz) -> np.ndarray:
    """xyz [N, 3] (numpy or a tensor) under the pose, formed on the pose's
    device; as numpy."""
    import torch

    from mp2p_icp_tpu_torch.core import se3

    pts = torch.as_tensor(xyz, device=pose_t.device)
    return se3.apply(se3.Pose(pose_R, pose_t), pts).cpu().numpy()


def _report(log) -> None:
    from mp2p_icp_tpu_torch.io.mm import to_numpy

    meta = log["meta"]
    print("ICP log record:")
    print(f"  iterations : {meta['n_iterations']}")
    print(f"  reason     : {meta['termination_reason']}")
    print(f"  quality    : {meta['quality']:.4f}")
    print(f"  pairings   : {meta['n_pairings']}")
    t = to_numpy(log["result"].t)
    print(f"  result t   : {t.round(4).tolist()}")
    cov_diag = np.diag(to_numpy(log["covariance"]))
    print(f"  cov diag   : {cov_diag.round(6).tolist()}")
    if "iterations" not in log:
        return
    its = log["iterations"]
    ts = to_numpy(its["poses"].t)
    cnts = to_numpy(its["pair_counts"])
    print("  per-iteration trace:")
    for i in range(len(ts)):
        line = f"    it {i:3d}: t={ts[i].round(4).tolist()} pairs={int(cnts[i])}"
        if "pairings" in its:
            # residual stats over the recorded (decimated) pt2pt pairs at
            # that iteration's pose
            blk = its["pairings"].pt2pt
            sel = to_numpy(blk.weight[i]) > 0
            if sel.any():
                loc = _posed(its["poses"].R[i], its["poses"].t[i], blk.local[i])
                d = np.linalg.norm(loc[sel] - to_numpy(blk.globl[i])[sel], axis=1)
                line += f" rec={int(sel.sum())} d_mean={d.mean():.4f} d_max={d.max():.4f}"
        print(line)


def _render_png(log, prefix, iteration) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from mp2p_icp_tpu_torch.io.mm import to_numpy

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    g = next(iter(log["global"].values())).to_numpy()
    l_raw = next(iter(log["local"].values())).to_numpy()
    l_guess = _posed(log["guess"].R, log["guess"].t, l_raw)
    l_final = _posed(log["result"].R, log["result"].t, l_raw)
    for ax, local, title in ((axes[0], l_guess, "initial guess"),
                             (axes[1], l_final, "registered")):
        ax.scatter(g[:, 0], g[:, 1], s=1, c="gray", label="global")
        ax.scatter(local[:, 0], local[:, 1], s=1, c="red", label="local")
        ax.set_title(title)
        ax.set_aspect("equal")
        ax.legend(markerscale=8)
    out = f"{prefix}_overlay.png"
    fig.savefig(out, dpi=110, bbox_inches="tight")
    print(f"  overlay    : {out}")

    # iteration playback frame: pairing lines local->global at the selected
    # iteration's pose (reference: the viewer's pairing lines over its
    # iteration slider)
    if iteration is None:
        return
    if "iterations" not in log or "pairings" not in log["iterations"]:
        print("  (no recorded per-iteration pairings in this log)")
        return
    its = log["iterations"]
    i = iteration
    n_it = its["poses"].t.shape[0]
    if not (0 <= i < n_it):
        raise SystemExit(f"iteration {i} out of range [0, {n_it})")
    blk = its["pairings"].pt2pt
    sel = to_numpy(blk.weight[i]) > 0
    R_i, t_i = its["poses"].R[i], its["poses"].t[i]
    loc = _posed(R_i, t_i, blk.local[i])
    glb = to_numpy(blk.globl[i])
    fig2, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(g[:, 0], g[:, 1], s=1, c="gray", label="global")
    li = _posed(R_i, t_i, l_raw)
    ax.scatter(li[:, 0], li[:, 1], s=1, c="red", label="local")
    for a_, b_ in zip(loc[sel], glb[sel]):
        ax.plot([a_[0], b_[0]], [a_[1], b_[1]], c="tab:blue", lw=0.4, alpha=0.6)
    ax.set_title(f"iteration {i}: {int(sel.sum())} recorded pairings")
    ax.set_aspect("equal")
    ax.legend(markerscale=8)
    out2 = f"{prefix}_iter{i:03d}.png"
    fig2.savefig(out2, dpi=110, bbox_inches="tight")
    print(f"  iter frame : {out2}")


if __name__ == "__main__":
    sys.exit(main())
