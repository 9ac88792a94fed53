"""The yardstick's operation and byte counts against hand counts."""


import pytest

from benchmark.counts import kernels, model, peaks
from benchmark.reference.models import Sizes
from benchmark.tests.conftest import load


def d16() -> Sizes:
    return Sizes.from_config(load("configs/var-d16.json"))


@pytest.mark.parametrize("got_ms, want_ms", [
    # PERF.md's kernel table: rows 1-3 at the last stage of a batch-8 decode,
    # row 6 at 256px B 32 (forward, backward)
    (lambda: kernels._ln(16, 256, 1024), 0.00505),
    (lambda: kernels._decode(16, 256, 680, 1024), 0.01831),
    (lambda: kernels._select(8 * 256, 4096), 0.01002),
    (lambda: kernels.sample_rows(d16(), 8)["row1"][1], 0.43821),
    (lambda: kernels.sample_rows(d16(), 8)["row3"][1], 0.02661),
    (lambda: kernels.train_rows(d16(), 32)["row6_fwd"][1] / 32, 0.05363),
    (lambda: kernels.train_rows(d16(), 32)["row6_bwd"][1] / 16, 0.10684),
])
def test_kernel_bounds_match_the_kernel_table(got_ms, want_ms):
    assert got_ms() * 1e3 == pytest.approx(want_ms, abs=5e-6)


def test_launch_counts_of_a_decode_and_a_step():
    s = d16()
    rows = kernels.sample_rows(s, 50)
    assert (rows["row1"][0], rows["row2"][0], rows["row3"][0]) == (320, 160, 10)
    rows = kernels.train_rows(s, 32, remat=2)
    assert (rows["row6_fwd"][0], rows["row6_bwd"][0]) == (32, 16)
    assert kernels.train_rows(s, 32, remat=0)["row6_fwd"][0] == 16


def tiny_sizes() -> Sizes:
    cfg = load("configs/var-d16.json")
    cfg.update(depth=1, embed_dim=64, num_heads=1, vocab_size=10, patch_nums=[1, 2])
    cfg["vae"] = dict(cfg["vae"], ch=32, ch_mult=[1, 2], num_res_blocks=1,
                      using_sa=False, using_mid_sa=False)
    return Sizes.from_config(cfg)


def test_flops_against_a_hand_count():
    s = tiny_sizes()  # L = 5: scale 0 (1 token) sees 1 key, scale 1 (4 tokens) sees 5
    c, L, v, z = 64, 5, 10, 32
    assert model.useful_pairs(s) == 1 * 1 + 4 * 5
    per_tok = 3 * c * c + c * c + 2 * c * 4 * c
    layer = L * per_tok + 2 * 21 * c + 6 * c * c
    fwd = layer + 2 * c * c + L * c * v + 4 * z * c
    # encoder at 4 x 4 pixels (patch 2, two levels): conv_in, one block a
    # level (32 -> 32, then 32 -> 64 with a 1x1 shortcut), one downsample,
    # the mid blocks, conv_out and quant_conv
    enc = (16 * 9 * 3 * 32 + 16 * 9 * 32 * 32 * 2 + 4 * 9 * 32 * 32
           + 4 * (9 * 32 * 64 + 9 * 64 * 64 + 32 * 64) + 2 * 4 * 9 * 64 * 64 * 2
           + 4 * 9 * (64 * 32 + 32 * 32))
    assert s.reso == 4
    assert model.encoder_macs(s) == enc
    assert model.train_flops_per_image(s) == 2.0 * (3 * fwd + enc)
    dec = (4 * 9 * (32 * 32 + 32 * 64) + 2 * 4 * 9 * 64 * 64 * 2
           + 2 * 4 * 9 * 64 * 64 * 2  # level 1: two blocks of 64 at 2 x 2
           + 16 * 9 * 64 * 64  # upsample conv at 4 x 4
           + 16 * (9 * 64 * 32 + 9 * 32 * 32 + 64 * 32) + 16 * 9 * 32 * 32 * 2  # level 0
           + 16 * 9 * 32 * 3)
    assert model.decoder_macs(s) == dec
    samp = 2 * (L * per_tok + 2 * 21 * c + 6 * c * c) + 4 * c * c + L * c * v + 4 * z * c + dec
    assert model.sample_flops_per_image(s) == 2.0 * samp


def test_published_sizes_give_the_known_totals():
    s = d16()
    assert s.seq_len == 680 and model.useful_pairs(s) == 286434
    assert model.sample_flops_per_image(s) == pytest.approx(0.985e12, rel=1e-3)
    assert model.train_flops_per_image(s) == pytest.approx(1.111e12, rel=1e-3)


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(3.35e12, 1.0, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 989e12, peaks.BF16_FLOPS) == pytest.approx(1.0)
