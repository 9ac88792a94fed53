"""Every per-layer reader on a synthetic profiler trace."""


import pytest

from benchmark.harness import trace as T
from benchmark.harness.registry import Registry
from benchmark.reference.models import Sizes
from benchmark.tests.conftest import ROOT, load


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def window(dur=1000):
    return ev(T.WINDOW, 0, dur, "user_annotation")


def test_busy_is_the_union_of_overlapping_streams():
    # a GEMM on one stream overlaps an NCCL kernel on another: the sum of
    # durations (600 us) passes the union (450 us)
    tr = T.read([window(), ev("sm90_gemm", 100, 300), ev("ncclDevKernel_AllReduce", 250, 300)])
    assert tr.busy_s == pytest.approx(450e-6)
    assert tr.window_s == pytest.approx(1e-3)
    assert sum(tr.kind_s.values()) == pytest.approx(600e-6)


def test_events_outside_the_window_are_left_out():
    tr = T.read([ev("before", -50, 40), window(), ev("sm90_gemm", 10, 10), ev("after", 1200, 5)])
    assert tr.kind_n == {"gemm": 1}


def test_idle_gaps_are_named_by_the_innermost_host_op():
    tr = T.read([window(100), ev("k1", 0, 10), ev("k2", 60, 40),
                 ev("Sampler::call", 0, 100, "user_annotation"),
                 ev("aten::copy_", 20, 30, "cpu_op")])
    assert dict(tr.idle_by_host) == {"aten::copy_": pytest.approx(50e-6)}


@pytest.mark.parametrize("name, want", [
    ("void modulated_ln_kernel<1024, 4>(...)", "row1"),
    ("void decode_attention_wgmma_kernel<false>(...)", "row2"),
    ("void decode_attention_wgmma_kernel<true>(...)", "row4"),
    ("topk_topp_bound_kernel", "row3"),
    ("void ptrain_fwd_wgmma_kernel<6>(...)", "row6_fwd"),
    ("void ptrain_fwd_wgmma_kernel<5>(...)", "row5_fwd"),
    ("void ptrain_dq_wgmma_kernel<6>(...)", "row6_bwd"),
    ("void ptrain_dkv_wgmma_kernel<6>(...)", "row6_bwd_dkv"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32", "conv"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel", "conv"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
])
def test_kinds_by_kernel_name(name, want):
    assert T.kind(name) == want


class View:
    def __init__(self, tr, sizes, traffic, capture_s=2.5, peak=31e9):
        self.trace, self.sizes, self.traffic = tr, sizes, traffic
        self.capture_s, self.peak_bytes = capture_s, peak


def test_every_reader_of_the_sampling_cells():
    reg = Registry(ROOT)
    s = Sizes.from_config(load("configs/var-d16.json"))
    traffic = load("traffic/fid50.json")
    from benchmark.counts.kernels import sample_rows

    rows = sample_rows(s, traffic["batch"])
    events, t = [window(10_000_000)], 0
    for name, kind, n in (("modulated_ln_kernel", "row1", rows["row1"][0]),
                          ("decode_attention_kernel<false>", "row2", rows["row2"][0]),
                          ("topk_topp_bound_kernel", "row3", rows["row3"][0])):
        for _ in range(n):
            events.append(ev(name, t, 10))
            t += 10
    events += [ev("nvjet_gemm", t, 1000), ev("cudnn_fprop", t + 1000, 2000),
               ev("elementwise_kernel", t + 3000, 500)]
    tr = T.read(events)
    tr.calls, tr.images = 1, traffic["batch"]
    v = View(tr, s, traffic)
    got = {m["name"]: reg.reader(m["name"])(v) for m in reg.metrics("d16-fid50", "per_layer")}
    assert got["gemm_ms.sample"] == pytest.approx(1.0 / 50)
    assert got["conv_ms.sample"] == pytest.approx(2.0 / 50)
    assert got["elementwise_ms.sample"] == pytest.approx(0.5 / 50)
    spent = (320 + 160 + 10) * 10e-6
    assert got["kernel_roofline.sample"] == pytest.approx(
        100 * sum(b for _, b in rows.values()) / spent)
    assert got["idle_share.sample"] == pytest.approx(100 * (1 - (t + 3500) * 1e-6 / 10.0))
    assert got["mfu.sample"] == pytest.approx(100 * 0.98503e12 * 50 / 10.0 / 989e12, rel=1e-4)
    assert got["peak_gb.sample"] == pytest.approx(31.0)
    assert got["capture_s"] == 2.5


def test_a_row_taken_off_the_path_leaves_the_share_to_the_others():
    s = Sizes.from_config(load("configs/var-d16.json"))
    traffic = load("traffic/train32.json")
    reg = Registry(ROOT)
    events = [window(10_000_000)] + [ev("ptrain_fwd_wgmma_kernel<6>", i * 10, 10)
                                     for i in range(32)]
    tr = T.read(events)
    tr.calls, tr.images = 1, 32
    read = reg.reader("kernel_roofline.train")
    from benchmark.counts.kernels import train_rows

    want = 100 * train_rows(s, 32)["row6_fwd"][1] / (32 * 10e-6)
    assert read(View(tr, s, traffic)) == pytest.approx(want)
    tr.kind_n, tr.kind_s = {}, {}
    assert read(View(tr, s, traffic)) is None


def test_readers_find_nothing_without_a_trace():
    reg = Registry(ROOT)
    s = Sizes.from_config(load("configs/var-d16.json"))
    v = View(None, s, load("traffic/train32.json"), capture_s=0.0, peak=0)
    for m in reg.metrics("d16-train32", "per_layer"):
        assert reg.reader(m["name"])(v) is None, m["name"]
