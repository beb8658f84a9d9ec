"""Command-line entry points of the port (``python -m mp2p_icp_tpu_torch.apps.<name>``).

Ports of every app of ``mp2p_icp_tpu/apps``: icp_run, kitti_odometry,
mm_filter, sm2mm_app, sm_cli, rawlog_filter, sm_filter, mm_georef, txt2mm,
mm2txt, kitti2mm, mm_info, mm_viewer and icp_log_viewer (html_viewer is
their page writer). Each takes ``--device`` (default: the package's
default device, the card) and runs every tensor of its work there.
"""

from __future__ import annotations

import argparse
import contextlib

from mp2p_icp_tpu_torch import device as _device


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=str(_device.default_device()),
                    help="the torch device of the run (default: %(default)s; "
                         "'cpu' runs the plain PyTorch versions of the kernels)")


@contextlib.contextmanager
def on_device(device):
    """The package's default device set to ``device`` for the block."""
    previous = _device._requested
    _device.set_default_device(device)
    try:
        yield _device.default_device()
    finally:
        _device.set_default_device(previous)
