"""``scripts/torch_demo_odometry.py``, the port's twin of
``scripts/demo_odometry.py``, on the CPU at a small ray count (16 x 256,
set on the module): the page it writes embeds the mapper's whole map (its
point count equals the mapper's) and the trajectory of every frame, and the
printed ATE is finite and below the trajectory limit of chip_smoke.py's
odometry phase (0.1 m)."""

import base64
import contextlib
import io
import json
import pathlib
import re
import sys

import numpy as np
import pytest

import mp2p_icp_tpu_torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))
import torch_demo_odometry as demo  # noqa: E402

FRAMES = 3


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


@pytest.fixture(scope="module")
def page(tmp_path_factory):
    path = tmp_path_factory.mktemp("demo") / "odometry_demo.html"
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(demo, "RINGS", 16)  # a small sweep: the CPU's plain kNN
        mp.setattr(demo, "AZIMUTHS", 256)
        rc = demo.main([str(path), "--frames", str(FRAMES), "--device", "cpu"])
    return rc, buf.getvalue(), path.read_text()


def _embedded(html: str) -> dict:
    """The page's data object (``apps/html_viewer._emit``)."""
    m = re.search(r"const DATA=(\{.*?\});\n", html)
    assert m, "no embedded data in the page"
    return json.loads(m.group(1))


def test_demo_page_holds_the_whole_map(page):
    rc, printed, html = page
    assert rc == 0
    n_map = int(re.search(r"map (\d+) points", printed).group(1))
    data = _embedded(html)
    (layer,) = data["layers"]
    assert layer["name"] == "map" and layer["kind"] == "points"
    xyz = np.frombuffer(base64.b64decode(layer["xyz"]), np.float32).reshape(-1, 3)
    assert layer["n"] == xyz.shape[0] == n_map > 0
    assert np.isfinite(xyz).all()


def test_demo_trajectory_and_ate(page):
    _, printed, html = page
    ate = float(re.search(r"ATE ([0-9.eE+-]+) m", printed).group(1))
    assert np.isfinite(ate) and ate < 0.1
    traj = np.frombuffer(base64.b64decode(_embedded(html)["traj"]), np.float32).reshape(-1, 3)
    assert traj.shape == (FRAMES, 3) and np.isfinite(traj).all()
    assert f"{FRAMES} frames" in printed and "wrote " in printed
