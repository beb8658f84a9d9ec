"""The port's structured filters against the JAX package, on the CPU.

Mirrors tests/test_structured_filters.py: FilterCurvature,
GeneratorEdgesFromCurvature, GeneratorEdgesFromRangeImage,
FilterEdgesPlanes and FilterPoleDetector on simulated spinning scans (the
same numpy rows through both packages), and their YAML names through both
loaders.

Bands: every output layer row for row, except where a class decision sits
on its threshold. Only FilterEdgesPlanes has such rows here: its classes
are ratios of the eigenvalues of each voxel's covariance, and the two
closed-form ``eigh3x3`` differ by up to ~7e-5 of the largest eigenvalue
(the JAX package's CPU backend contracts multiply-adds; ROADMAP C, "closed
form eigen"), so a voxel whose ratios lie within 1e-4 * l2 of a threshold
may fall on either side. Those voxels are counted and printed, and only
they may differ. Plane centroids within 1e-5; plane normals within 1e-4
where the normal is well conditioned.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp2p_icp_tpu_torch
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.filters.curvature import FilterCurvature as JCurvature
from mp2p_icp_tpu.filters.edge_generators import (
    GeneratorEdgesFromCurvature as JEdgesCurvature,
    GeneratorEdgesFromRangeImage as JEdgesRange,
)
from mp2p_icp_tpu.filters.edges_planes import FilterEdgesPlanes as JEdgesPlanes
from mp2p_icp_tpu.filters.pole_detector import FilterPoleDetector as JPoles
from mp2p_icp_tpu.ops.eigen import eigh3x3 as jeigh3x3
from mp2p_icp_tpu.pipeline import yaml_loader as jyl
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.eval.lidar_sim import Scene, make_street_scene, render_spinning_scan
from mp2p_icp_tpu_torch.filters import (
    FilterCurvature,
    FilterEdgesPlanes,
    FilterPoleDetector,
    GeneratorEdgesFromCurvature,
    GeneratorEdgesFromRangeImage,
)
from mp2p_icp_tpu_torch.pipeline import yaml_loader as yl
from chip_smoke import EIGEN_BAND, edges_planes_threshold_voxels, voxel_rows

@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _render(scene, xyz_ypr, seed, n_rings, n_azimuth, **kw):
    pose = se3.from_xyz_ypr(*xyz_ypr, device="cpu")
    scan = render_spinning_scan(scene, pose, np.zeros(6), np.random.RandomState(seed),
                                n_rings=n_rings, n_azimuth=n_azimuth, **kw)
    v = scan["valid"]
    return {k: scan[k][v] for k in ("xyz", "intensity", "ring", "time")}


def _street_scan():
    scene = make_street_scene(np.random.RandomState(0), length=120.0, n_pillars=30)
    return _render(scene, (20.0, 0.0, 1.8, 0.0, 0.0, 0.0), 0, 32, 512)


def _box_scan():
    scene = Scene(walls=[(1, -6.0, -40.0, 40.0, 0.0, 5.0), (1, 6.0, -40.0, 40.0, 0.0, 5.0),
                         (0, 15.0, -6.0, 6.0, 0.0, 5.0)],
                  cylinders=[(8.0, 2.0, 0.3, 4.0), (5.0, -2.5, 0.25, 4.0)])
    return _render(scene, (0.0, 0.0, 1.6, 0.0, 0.0, 0.0), 1, 32, 512, range_noise=0.01)


def _pillar_scan():
    scene = Scene(walls=[(0, 20.0, -15.0, 15.0, 0.0, 6.0)],
                  cylinders=[(10.0, 0.0, 0.4, 5.0), (12.0, 4.0, 0.35, 5.0)])
    return _render(scene, (0.0, 0.0, 1.6, 0.0, 0.0, 0.0), 2, 24, 512, range_noise=0.0)


def _both(scan, capacity=None):
    """(JAX cloud, port cloud) of the same rows and channels."""
    ch = {k: scan[k] for k in ("intensity", "ring", "time")}
    return (JPointCloud.from_numpy(scan["xyz"], capacity=capacity, **ch),
            PointCloud.from_numpy(scan["xyz"], capacity=capacity, **ch))


def _rows(layer):
    n = int(layer.count)
    xyz = layer.xyz.numpy() if isinstance(layer.xyz, torch.Tensor) else np.asarray(layer.xyz)
    return xyz[:n]


def _layers_equal(jout, tout, names):
    for name in names:
        a, b = jout[name], tout[name]
        assert int(a.count) == int(b.count), name
        np.testing.assert_array_equal(np.asarray(a.xyz), b.xyz.numpy(), err_msg=name)
        for ch in ("intensity", "ring", "time"):
            np.testing.assert_array_equal(np.asarray(getattr(a, ch)), getattr(b, ch).numpy(),
                                          err_msg=f"{name}.{ch}")


@pytest.mark.parametrize("scan_of,max_cosine", [(_street_scan, 0.5), (_street_scan, 0.8),
                                                 (_pillar_scan, 0.5)])
def test_curvature_matches_jax(scan_of, max_cosine):
    jpc, tpc = _both(scan_of())
    kw = dict(output_layer_larger_curvature="larger", output_layer_smaller_curvature="smaller",
              output_layer_other="other", max_cosine=max_cosine)
    jout = JCurvature(**kw)({"raw": jpc})
    tout = FilterCurvature(**kw)({"raw": tpc})
    _layers_equal(jout, tout, ("larger", "smaller", "other"))
    n = [int(tout[k].count) for k in ("larger", "smaller", "other")]
    assert n[0] > 20 and n[1] > n[0]
    # every kept row lands in exactly one class; the clearance test drops the rest
    assert sum(n) <= int(tpc.count)


def test_curvature_requires_ring_and_an_output():
    pc = PointCloud.from_numpy(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="ring"):
        FilterCurvature(output_layer_larger_curvature="e")({"raw": pc})
    with pytest.raises(ValueError, match="at least one"):
        FilterCurvature()({"raw": PointCloud.from_numpy(np.zeros((4, 3)), ring=np.zeros(4))})


@pytest.mark.parametrize("scan_of", [_street_scan, _pillar_scan])
def test_edges_from_curvature_matches_jax(scan_of):
    jpc, tpc = _both(scan_of())
    jout = JEdgesCurvature(target_layer="edges")({"raw": jpc})
    tout = GeneratorEdgesFromCurvature(target_layer="edges")({"raw": tpc})
    _layers_equal(jout, tout, ("edges",))
    assert int(tout["edges"].count) > 0


@pytest.mark.parametrize("scan_of,kw", [(_pillar_scan, dict(score_threshold=40, window=4)),
                                        (_street_scan, dict()),
                                        (_street_scan, dict(score_threshold=5, window=2))])
def test_edges_from_range_image_matches_jax(scan_of, kw):
    jpc, tpc = _both(scan_of())
    jout = JEdgesRange(target_layer="edges", **kw)({"raw": jpc})
    tout = GeneratorEdgesFromRangeImage(target_layer="edges", **kw)({"raw": tpc})
    _layers_equal(jout, tout, ("edges",))


def _row_set(rows):
    return {tuple(r) for r in rows.tolist()}


@pytest.mark.parametrize("scan_of,res", [(_box_scan, 0.8), (_street_scan, 0.5),
                                         (_street_scan, 1.0)])
def test_edges_planes_matches_jax(scan_of, res):
    scan = scan_of()
    jpc, tpc = _both(scan)
    f = FilterEdgesPlanes(voxel_filter_resolution=res)
    jout = JEdgesPlanes(voxel_filter_resolution=res)({"raw": jpc})
    tout = f({"raw": tpc})
    near, well, cnt, segs = edges_planes_threshold_voxels(f, tpc)
    near_rows = _row_set(tpc.xyz[voxel_rows(segs, near)].numpy())
    differ = {}
    for name in ("edge_points", "plane_points", "full_decim"):
        a, b = _row_set(_rows(jout[name])), _row_set(_rows(tout[name]))
        differ[name] = a ^ b
        assert differ[name] <= near_rows, f"{name}: rows off the thresholds differ"
    # full_decim does not depend on a class: exact
    _layers_equal(jout, tout, ("full_decim",))
    # planes: the centroids of the voxels both call planes within 1e-5,
    # their normals within 1e-4 where well conditioned
    jc, tc = _rows(jout["plane_centroids"]), _rows(tout["plane_centroids"])
    jn = np.asarray(jout["_planes"].normal)[: len(jc)]
    tn = tout["_planes"].normal[: len(tc)].numpy()
    _, _, mean, _, _, _, is_plane = f.classify(tpc)
    plane_vox = torch.nonzero(is_plane).flatten().numpy()
    near_np, well_np = near.numpy(), well.numpy()
    matched, checked_normals = 0, 0
    for i, c in enumerate(tc):
        d = np.abs(jc - c).max(axis=1)
        j = int(d.argmin())
        v = plane_vox[i]
        if d[j] > 1e-5:
            assert near_np[v], f"plane {i} is not in the JAX package's set and not on a threshold"
            continue
        matched += 1
        if well_np[v]:
            checked_normals += 1
            np.testing.assert_allclose(tn[i], jn[j], atol=1e-4)
    n_near = int(near.sum())
    print(f"[edges/planes {res} m] {int(tout['plane_centroids'].count)} planes (JAX "
          f"{int(jout['plane_centroids'].count)}), {matched} matched, {checked_normals} normals "
          f"held to 1e-4; {n_near} threshold voxels ({int(cnt[near].sum())} rows); rows that "
          f"differ: " + ", ".join(f"{k} {len(v)}" for k, v in differ.items()))
    assert abs(len(tc) - len(jc)) <= n_near and matched >= len(tc) - n_near
    assert checked_normals > 0.5 * matched
    # the planes of the PlaneSet are the centroids layer's rows
    np.testing.assert_array_equal(tout["_planes"].centroid.numpy(),
                                  tout["plane_centroids"].xyz.numpy())


@pytest.mark.parametrize("kw", [dict(), dict(minimum_relative_height=0.5),
                                dict(grid_size=1.0, minimum_relative_height=1.0,
                                     minimum_neighbors_checks_to_pass=2)])
def test_pole_detector_matches_jax(kw):
    jpc, tpc = _both(_street_scan())
    kw = dict(output_layer_poles="poles", output_layer_no_poles="rest", **kw)
    jout = JPoles(**kw)({"raw": jpc})
    tout = FilterPoleDetector(**kw)({"raw": tpc})
    _layers_equal(jout, tout, ("poles", "rest"))
    assert int(tout["poles"].count) + int(tout["rest"].count) == int(tpc.count)


def test_filters_with_padding_rows():
    """Capacity beyond the point count: the same outputs as the JAX package
    (padding rows sort last, form no ring, no voxel and no cell)."""
    scan = _street_scan()
    jpc, tpc = _both(scan, capacity=1 << 15)
    for jf, tf, names in (
            (JCurvature(output_layer_larger_curvature="a", output_layer_smaller_curvature="b"),
             FilterCurvature(output_layer_larger_curvature="a",
                             output_layer_smaller_curvature="b"), ("a", "b")),
            (JEdgesCurvature(), GeneratorEdgesFromCurvature(), ("edges",)),
            (JEdgesRange(), GeneratorEdgesFromRangeImage(), ("edges",)),
            (JPoles(output_layer_poles="p"), FilterPoleDetector(output_layer_poles="p"), ("p",))):
        _layers_equal(jf({"raw": jpc}), tf({"raw": tpc}), names)


def test_eigen_band_covers_the_two_closed_forms():
    """The band the threshold voxels are counted with: the two packages'
    eigh3x3 on the same covariances (the street scan's voxels) differ by
    less than EIGEN_BAND * l2."""
    _, tpc = _both(_street_scan())
    f = FilterEdgesPlanes(voxel_filter_resolution=0.5)
    segs, cnt, mean, evals, _, _, _ = f.classify(tpc)
    from mp2p_icp_tpu_torch.ops.voxel_unique import segment_sums_in_order

    xyz_sorted = tpc.xyz[segs.order]
    w = segs.valid.to(torch.float32)
    centered = (xyz_sorted - mean[segs.segment_id]) * w[:, None]
    cov = segment_sums_in_order(centered[:, :, None] * centered[:, None, :], segs,
                                tpc.capacity) / torch.clamp(cnt, min=1.0)[:, None, None]
    je, _ = jeigh3x3(jnp.asarray(cov.numpy()))
    m = (cnt >= f.min_points_per_voxel).numpy()
    gap = np.abs(np.asarray(je) - evals.numpy()).max(axis=1) / np.abs(evals[:, 2].numpy())
    print(f"[eigen] largest gap {gap[m].max():.3g} of l2 over {int(m.sum())} voxels")
    assert gap[m].max() < EIGEN_BAND


_YAML = {
    "FilterCurvature": dict(input_pointcloud_layer="raw", output_layer_larger_curvature="L",
                            output_layer_smaller_curvature="S", output_layer_other="O",
                            max_cosine=0.6, min_clearance=0.03, max_gap=1.5),
    "FilterEdgesPlanes": dict(voxel_filter_resolution="$f{2*0.25}",
                              full_pointcloud_decimation=10, voxel_filter_decimation=2,
                              voxel_filter_max_e2_e0=25.0, voxel_filter_min_e1=0.001),
    "FilterPoleDetector": dict(output_layer_poles="poles", grid_size=1.5,
                               minimum_relative_height=2.0, minimum_pole_points=4),
    "GeneratorEdgesFromCurvature": dict(target_layer="e", max_cosine=0.4,
                                        min_point_clearance=0.2),
    "GeneratorEdgesFromRangeImage": dict(target_layer="e", score_threshold=20),
}


@pytest.mark.parametrize("name", sorted(_YAML))
def test_yaml_names_build_the_jax_loaders_modules(name):
    entry = [{"class_name": f"mp2p_icp_filters::{name}", "params": _YAML[name]}]
    (tf,) = yl.filter_pipeline_from_yaml(entry)
    (jf,) = jyl.filter_pipeline_from_yaml(entry)
    assert type(tf).__name__ == type(jf).__name__ == name
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
