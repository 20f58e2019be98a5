"""The benchmark's arithmetic: the rate over the window, the percentile
over all requests, the union of kernel intervals (the idle share), the
roofline sums and the per-layer readers."""

import numpy as np
import pytest
import torch

from benchmark import harness, peaks, tracing
from benchmark.drivers import common
from benchmark.reference import plain


class _Ctx:
    timings = []


def _layer_context(slice_info, walls=()):
    return tracing.LayerContext(_Ctx(), dict(slice=slice_info,
                                             walls=list(walls)))


def test_rate_is_window_over_requests():
    d = common.Driver.__new__(common.Driver)
    d.rate_metric = "scan_cloud_s"
    assert d.end_to_end(dict(window_s=31.5, requests=38,
                             window_requests=35)) == {
        "scan_cloud_s": pytest.approx(0.9)}


def test_percentile_is_numpys_linear_over_every_value():
    v = torch.arange(1, 101, dtype=torch.float32)
    assert plain.percentile(v, 90) == pytest.approx(90.1)
    assert plain.percentile(torch.tensor([]), 90) == float("inf")


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10)], 10e-6),
    ([(0, 10), (5, 20)], 20e-6),          # overlap counted once
    ([(0, 10), (20, 30)], 20e-6),         # a gap is idle
    ([(20, 30), (0, 10), (8, 22)], 30e-6),
])
def test_busy_union(intervals, busy):
    assert tracing.union_s(intervals) == pytest.approx(busy)


def test_idle_share_and_kernels_per_request():
    # Two profiled requests, busy 0.25 s each; the window's walls after
    # them have the median 1.0 s (the profiled walls, 9 s, do not count).
    sl = dict(kernels=100, window_s=18.0, busy_s=0.5, requests=2,
              rooflines={})
    lc = _layer_context(sl, walls=[9.0, 9.0, 0.9, 1.0, 1.2])
    assert lc.idle_pct() == pytest.approx(75.0)
    assert lc.kernels_per_request() == pytest.approx(50.0)
    assert _layer_context(dict(sl, kernels=0), [9, 9, 1]).idle_pct() is None
    assert _layer_context(sl, walls=[9.0, 9.0]).idle_pct() is None


def test_roofline_is_bound_over_device_time_and_stays_silent_unmeasured():
    lc = _layer_context(dict(rooflines={"nearest_one": dict(
        calls=43, recorded=43, device_s=0.016, bound_s=0.002)}))
    assert lc.roofline_pct("nearest_one") == pytest.approx(12.5)
    assert lc.roofline_pct("decode_maps") is None


def test_nearest_one_need_counts_valid_keys_only():
    q = torch.zeros(23, 2048, 3)
    kt = torch.zeros(23, 3, 8192)
    p2v = torch.full((23, 1, 8192), float("inf"))
    p2v[:, :, :1000] = 1.0
    flops, nbytes = peaks.KERNELS["nearest_one"]["need"](q, kt, p2v)()
    assert flops == 8 * 2048 * 23 * 1000
    assert nbytes == 23 * (4 * (3 * 2048 + 4 * 8192) + 12 * 2048)
    assert peaks.bound_seconds(flops, nbytes) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))


def test_recorder_records_and_restores():
    from structured_light_for_3d_model_replication_tpu_torch.ops import nn

    before = nn.nearest_one
    rec = tracing.Recorder("nearest_one")
    rec.install()
    try:
        pts = torch.randn(64, 3)
        kt, p2v = nn.key_table(pts, torch.ones(64, dtype=torch.bool))
        nn.nearest_one(pts, kt, p2v)
    finally:
        rec.uninstall()
    assert nn.nearest_one is before and len(rec.needs) == 1


def test_breakdown_names_gaps_by_the_host_span():
    kernels = [("k1", 0, 10, 0), ("k2", 50, 60, 0), ("k1", 61, 70, 0)]
    host = [("bench.scan", 0, 100), ("aten::sort", 20, 40),
            ("cudaLaunchKernel", 9, 11)]
    by_name = {"k1": (2, 19e-6), "k2": (1, 10e-6)}
    out = tracing.breakdown(by_name, kernels, host)
    assert out["device_ops"][0] == ["k1", 19e-6]
    assert out["idle_gaps"][0] == ["bench.scan / aten::sort",
                                   pytest.approx(40e-6)]
    assert len(out["idle_gaps"]) <= 10


def test_compared_numbers_stand_beside_limits():
    d = common.Driver.__new__(common.Driver)
    d.limits = {"pose_gap_mm": 1.0}
    got = d.compared({"pose_gap_mm": 0.3, "other": float("inf")})
    assert got == {"pose_gap_mm": {"value": 0.3, "limit": 1.0},
                   "other": {"value": common.BIG, "limit": common.BIG}}


def test_nearest_distance_matches_brute_force():
    g = torch.Generator().manual_seed(3)
    keys = torch.randn(5000, 3, generator=g) * 80 + torch.tensor(
        [0.0, 0.0, 500.0])
    q = keys[:700] + torch.randn(700, 3, generator=g) * 1e-3
    got = plain.nearest_distance(q, keys, block=256, key_block=1024)
    ref = np.sqrt(((q.double().numpy()[:, None] - keys.double().numpy()[None])
                   ** 2).sum(-1)).min(1)
    # The float64 expansion keeps a distance of 1e-3 mm to ~1e-7 mm.
    assert np.abs(got.numpy() - ref).max() < 1e-6
