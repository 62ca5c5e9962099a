"""The roofline, pair_mfu and trace arithmetic on hand-counted shapes."""
import pytest

from pbcore import roofline, spec, trace

BENCH = spec.load_benchmark()


def _record(per_step, window_s=2.0, match_s=0.5, desc_s=0.25, busy_s=1.5, net=None):
    s = dict(dims=128, knn=50)
    if net:
        s["hardnet"] = net
    return dict(pairs=[dict(per_step=per_step, timelog={})], spec=s,
                trace=dict(window_s=window_s, busy_s=busy_s,
                           span_device_s=dict(MatchTime=match_s, DescTime=desc_s)))


def test_hardnet_macs_and_flops():
    net = spec.config(BENCH, "hessaff-hardnet")["hardnet"]
    assert roofline.conv_macs(net["convs"], net["patch"]) == 39_092_224
    # one layer by hand: 3x3, 1 -> 2 channels, stride 1, pad 1 on 4x4
    assert roofline.conv_macs([[1, 2, 3, 1, 1]], 4) == 2 * 9 * 16


def test_knn_counts():
    assert roofline.knn_ops(1000, 2000, 128) == 2 * 1000 * 2000 * 128
    assert roofline.knn_bytes(1000, 2000, 128, 50) == 4 * 3000 * 128 + 12 * 1000 * 50
    # 65,536 x 65,536 rows of 128: 1.1e12 operations, 16.4 ms at 67 TFLOP/s
    least = roofline.least_seconds(roofline.knn_ops(65536, 65536, 128),
                                   roofline.knn_bytes(65536, 65536, 128, 50))
    assert least == pytest.approx(2 * 65536 ** 2 * 128 / 67e12)
    # a small call is bound by its bytes
    assert roofline.least_seconds(10.0, 3.35e12) == 1.0


def test_knn_roofline_and_pair_mfu():
    steps = [dict(descriptors1=8192, descriptors2=4096),
             dict(descriptors1=65536, descriptors2=32768)]
    rec = _record(steps)
    ops = 2 * 128 * (8192 * 4096 + 65536 * 32768)
    least = sum(roofline.least_seconds(roofline.knn_ops(a, b, 128),
                                       roofline.knn_bytes(a, b, 128, 50))
                for a, b in ((8192, 4096), (65536, 32768)))
    assert spec.metric("knn_roofline").read(rec) == pytest.approx(100 * least / 0.5)
    assert spec.metric("pair_mfu").read(rec) == pytest.approx(100 * ops / 2.0 / 67e12)
    assert spec.metric("hardnet_roofline").read(rec) is None
    assert spec.metric("device_idle_share").read(rec) == pytest.approx(25.0)


def test_hardnet_roofline():
    net = dict(patch=32, convs=[[1, 2, 3, 1, 1]])
    rec = _record([dict(descriptors1=10, descriptors2=30),
                   dict(descriptors1=100, descriptors2=300)], net=net)
    macs = 2 * 9 * 32 * 32
    flops = 2 * macs * 400         # the last step's counts hold every step's
    assert spec.metric("hardnet_roofline").read(rec) == pytest.approx(
        100 * flops / 67e12 / 0.25)
    knn = 2 * 128 * (10 * 30 + 100 * 300)
    assert spec.metric("pair_mfu").read(rec) == pytest.approx(
        100 * (knn + flops) / 2.0 / 67e12)


def test_span_metrics_read_the_timelog():
    rec = dict(pairs=[dict(timelog=dict(SynthTime=0.0, DetectTime=0.1, DescTime=0.2,
                                        MatchTime=0.3, MiscTime=0.01, RANSACTime=0.02)),
                      dict(timelog=dict(SynthTime=0.0, DetectTime=0.3, DescTime=0.2,
                                        MatchTime=0.1, MiscTime=0.03, RANSACTime=0.04))])
    assert spec.metric("detect_ms").read(rec) == pytest.approx(200.0)
    assert spec.metric("match_ms").read(rec) == pytest.approx(200.0)
    assert spec.metric("verify_ms").read(rec) == pytest.approx(50.0)
    assert spec.metric("synth_ms").read(rec) is None       # nothing to read


def test_trace_reduction():
    # device work [0,10) [5,20) [30,40) [50,60) us; window [0,100)
    work = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (50, 60, "c")]
    dev_spans = [(0, 25, "MatchTime"), (28, 45, "DescTime"), (45, 70, "MatchTime")]
    host_spans = [(0, 22, "MatchTime"), (22, 48, "DescTime"), (48, 100, "MatchTime")]
    r = trace.reduce_events(work, dev_spans, host_spans, (0, 100),
                            ("MatchTime", "DescTime", "SynthTime"))
    assert r["busy_s"] == pytest.approx(40e-6)          # union, not 45
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["span_device_s"]["MatchTime"] == pytest.approx(30e-6)
    assert r["span_device_s"]["DescTime"] == pytest.approx(10e-6)
    assert r["span_device_s"]["SynthTime"] is None
    assert r["device_ops"][0] == ["a", pytest.approx(20e-6)]
    # gaps: [20,30) and [60,100) under MatchTime, [40,50) under DescTime
    assert dict(r["idle_gaps"]) == {"MatchTime (2 gaps)": pytest.approx(50e-6),
                                    "DescTime (1 gaps)": pytest.approx(10e-6)}
