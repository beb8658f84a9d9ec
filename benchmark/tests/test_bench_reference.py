"""CPU tests of the benchmark's plain reference: each stage against a
brute-force statement of its rule, and against the program (the port) at a
tiny size for every cell's entry point.

    python -m pytest benchmark/tests -q
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import checks, programs, reference as ref, scenes, se3  # noqa: E402

TINY = Path(__file__).resolve().parent / "tiny"
F64 = ref.FLOAT64


@pytest.fixture(scope="module", autouse=True)
def cpu():
    import mp2p_icp_tpu_torch

    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def tiny(name):
    return json.loads((TINY / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def drive():
    cfg = tiny("kitti_hdl64_odometry")
    gt, tw, scans = scenes.street_drive(cfg, 6, 2 ** 31 + 5, "cpu")
    raw = [scenes.compact_scan(s, cfg["sensor"]["raw_capacity"]) for s in scans]
    return cfg, gt, tw, raw


def test_knn_is_the_brute_force_nearest_within_the_radius():
    g = torch.Generator().manual_seed(0)
    q, p = torch.rand((50, 3), generator=g, dtype=torch.float64), torch.rand(
        (200, 3), generator=g, dtype=torch.float64)
    d2, idx = ref.knn(q, p, 3, 0.02, F64, chunk=16)
    full = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    dd, ii = torch.sort(full, dim=1)
    for k in range(3):
        inside = dd[:, k] < 0.02
        assert torch.equal(idx[:, k], torch.where(inside, ii[:, k], -1))
        assert torch.allclose(d2[:, k][inside], dd[:, k][inside])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11 + 2 ** -13, -3.0])
    assert ref.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10, -3.0]


def test_first_point_decimation_keeps_the_lowest_row_per_voxel_in_cell_order():
    xyz = torch.tensor([[0.9, 0.1, 0.1], [0.1, 0.1, 0.1], [0.2, 0.3, 0.1], [-0.1, 0.0, 0.0],
                        [0.7, 0.2, 0.3]], dtype=torch.float64)
    rows, voxels = ref.decimate_first_point(xyz, 0.5, 10)
    assert voxels == 3 and rows.tolist() == [3, 1, 0]
    assert ref.decimate_first_point(xyz, 0.5, 2)[0].tolist() == [3, 1]


def test_crop_keeps_every_stride_th_row_inside_the_box():
    xyz = torch.tensor([[float(i), 0.0, 0.0] for i in range(20)], dtype=torch.float64)
    scan = torch.tensor([[5.0, 0.0, 0.0], [9.0, 0.0, 0.0]], dtype=torch.float64)
    rows, inside = ref.crop(xyz, scan, 1.0, 3)  # rows 4 ... 10 inside, stride 3
    assert inside == 7 and rows.tolist() == [4, 7, 10]


def test_voxel_map_keeps_the_earliest_point_and_drops_past_its_capacity():
    vm = ref.VoxelMap(3, 1.0, "cpu", torch.float64)
    pts = torch.tensor([[0.5, 0.5, 0.5], [0.6, 0.5, 0.5], [1.5, 0.5, 0.5]], dtype=torch.float64)
    assert vm.insert(pts, torch.zeros_like(pts)).tolist() == [0, 2]
    more = torch.tensor([[0.1, 0.1, 0.1], [2.5, 0, 0], [3.5, 0, 0], [4.5, 0, 0]],
                        dtype=torch.float64)
    assert vm.insert(more, torch.zeros_like(more)).tolist() == [1]
    assert vm.xyz[:, 0].tolist() == [0.5, 1.5, 2.5] and vm.dropped == 2


def test_one_to_one_keeps_the_closest_claim():
    idx = torch.tensor([4, 4, -1, 7, 4])
    d2 = torch.tensor([0.3, 0.1, 0.0, 0.2, 0.1], dtype=torch.float64)
    assert ref.one_to_one(idx, d2).tolist() == [False, True, False, True, False]


def test_horn_and_gauss_newton_recover_a_known_pose():
    g = torch.Generator().manual_seed(1)
    local = torch.rand((100, 3), generator=g, dtype=torch.float64) * 10
    true = se3.exp(torch.tensor([0.3, -0.2, 0.1, 0.05, -0.02, 0.1], dtype=torch.float64))
    glob = se3.apply(true, local)
    R, t = ref.horn(local, glob, F64)
    assert torch.allclose(R, true[0], atol=1e-10) and torch.allclose(t, true[1], atol=1e-9)
    start = (torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    est = ref.gauss_newton(start, ref.pt2pt_terms(local, glob, F64), 10, F64)
    assert torch.allclose(est[1], true[1], atol=1e-8)


def test_deskew_and_decimation_match_the_program(drive):
    cfg, gt, tw, raw = drive
    m = programs.odometry_mapper(cfg)
    for i in (0, 3):
        prog = m._local({"raw": programs.frame_cloud(raw[i])}, torch.as_tensor(tw[i]))
        n = raw[i]["count"]
        x = ref.deskew(raw[i]["xyz"][:n].double(), raw[i]["time"][:n].double(),
                       torch.as_tensor(tw[i], dtype=torch.float64))
        rows, _ = ref.decimate_first_point(x, cfg["mapper"]["voxel_m"],
                                           cfg["mapper"]["decimated_capacity"])
        assert int(prog.count) == rows.shape[0]
        assert torch.allclose(prog.xyz[:rows.shape[0]].double(), x[rows], atol=1e-4)


def test_seed_map_and_its_normals_match_the_program(drive):
    cfg, gt, tw, raw = drive
    m = programs.odometry_mapper(cfg)
    pose0 = programs.pose(torch.from_numpy(gt[0, :3, :3]), torch.from_numpy(gt[0, :3, 3]), "cpu")
    st = m.seed_map({"raw": programs.frame_cloud(raw[0])}, pose0, torch.as_tensor(tw[0]))
    n = int(st.pc.count)
    r = ref.odometry(raw[:1], tw[:1], (torch.from_numpy(gt[0, :3, :3]),
                                       torch.from_numpy(gt[0, :3, 3])), cfg, F64)
    xyz, nrm = r["map"]
    assert xyz.shape[0] == n
    assert torch.allclose(st.pc.xyz[:n].double(), xyz, atol=1e-4)
    share_map, share_nrm = checks.map_gaps(st.pc.xyz[:n], st.pc.normals[:n], xyz, nrm)
    assert share_map == 0.0 and share_nrm < 3.0


def test_odometry_run_matches_the_program(drive):
    cfg, gt, tw, raw = drive
    m = programs.odometry_mapper(cfg)
    pose0 = programs.pose(torch.from_numpy(gt[0, :3, :3]), torch.from_numpy(gt[0, :3, 3]), "cpu")
    res = m.run([{"raw": programs.frame_cloud(r)} for r in raw], twists=tw, dt=0.1,
                initial_pose=pose0, progress_every=1)
    r = ref.odometry(raw, tw, (torch.from_numpy(gt[0, :3, :3]), torch.from_numpy(gt[0, :3, 3])),
                     cfg, F64)
    st = res["map_state"]
    n = int(st.pc.count)
    got = checks.odometry_numbers({"poses": res["poses"], "iterations": res["iterations"],
                                   "map": (st.pc.xyz[:n], st.pc.normals[:n])}, r)
    # 16 x 256 rays leave the street's x weakly held: gaps of ~1 cm
    assert got["pose_gap_m"] < 0.05 and got["map_gap_pct"] < 5.0
    assert abs(n - r["map"][0].shape[0]) <= 0.02 * n


def test_fleet_streams_match_the_reference(drive):
    from mp2p_icp_tpu_torch.odometry import BatchedOdometryMapper

    cfg, gt, tw, raw = drive
    m = programs.odometry_mapper(cfg)
    frames = [{"raw": programs.frame_cloud(r)} for r in raw]
    p0 = [programs.pose(torch.from_numpy(gt[o, :3, :3]), torch.from_numpy(gt[o, :3, 3]), "cpu")
          for o in (0, 2)]
    res = BatchedOdometryMapper(m).run([frames[0:4], frames[2:6]], twists=[tw[0:4], tw[2:6]],
                                       initial_poses=p0, dt=0.1)
    for b, o in enumerate((0, 2)):
        r = ref.odometry(raw[o:o + 4], tw[o:o + 4], (torch.from_numpy(gt[o, :3, :3]),
                                                     torch.from_numpy(gt[o, :3, 3])), cfg, F64)
        dt, _ = checks.pose_gaps(res["poses"][b], r["poses"])
        assert dt < 0.05


def test_localization_align_matches_the_program():
    cfg = tiny("corridor16m_localization")
    host, gen = scenes.generators(11, "cpu")
    corridor = scenes.corridor_scene(cfg["map"]["points"], cfg["map"]["length_m"], gen)
    local, guess, truth = scenes.sensor_scan(corridor, 150.0, (0.5, -0.1, 0.02, 0.01, 0.002, -0.003),
                                             cfg["scan"]["points"], 50.0, 0.02, 1.5, gen)
    icp, params = programs.map_icp(cfg)
    res = icp.align({"raw": programs.points_cloud(local)}, {"map": programs.points_cloud(corridor)},
                    programs.pose(*guess, "cpu"), params)
    pose, its, reason, inside, pairs = ref.align_to_map(corridor, local, guess, cfg["icp"], F64)
    dt, dr = se3.gaps((res.optimal_tf.R.double(), res.optimal_tf.t.double()), pose)
    # the stall test ends both loops within a step of 5e-4 m of their paths
    assert float(dt) < 5e-3 and float(dr) < 5e-4
    assert abs(int(res.n_iterations) - its) <= 3
    assert reason == res.termination_reason.name.lower()
    # the last iteration's pairs, matched at poses within millimetres
    assert abs(int(res.final_pairings.size()) - pairs) <= 0.01 * pairs
    assert float(se3.gaps(pose, truth)[0]) < 0.02
