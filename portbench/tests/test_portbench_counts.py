"""The operation and byte counts against values worked by hand."""
import math

import pytest

from portbench import counts, harness


def test_ffdnet_color_512_is_89_8_gflop():
    # 2 * 9 * (13 * 96 + 8 * 96 * 96 + 96 * 12) * 256^2
    expected = 2 * 9 * (13 * 96 + 8 * 96 * 96 + 96 * 12) * 256 ** 2
    assert counts.ffdnet_flops(3, 96, 10, 512, 512) == expected
    assert expected == pytest.approx(89.80e9, rel=1e-3)
    assert counts.ffdnet_flops(3, 96, 10, 128, 128) == expected / 16


def test_kernel_bounds_match_the_kernel_table():
    # PERF.md's kernel table: TV 3x512^2 0.00188 ms, the divide 1x3x512^2
    # 0.00470 ms, bdot 1x3x256^2 0.00047 ms, all bound by bytes
    assert counts.tv_bytes(3, 512, 512) == 2 * 3 * 512 ** 2 * 4
    tv = counts.bound_s(counts.tv_bytes(3, 512, 512), counts.tv_ops(3, 512, 512, 10))
    assert tv * 1e3 == pytest.approx(0.00188, rel=2e-3)
    div = counts.bound_s(counts.freq_divide_bytes(3, 512, 512, 3 * 512 ** 2),
                         counts.freq_divide_ops(3, 512, 512))
    assert counts.freq_divide_bytes(3, 512, 512, 3 * 512 ** 2) == 16 * 3 * 512 ** 2 + 4 * 3 * 512 ** 2
    assert div * 1e3 == pytest.approx(0.00470, rel=2e-3)
    bd = counts.bound_s(counts.bdot_bytes(1, 3 * 256 ** 2), counts.bdot_ops(1, 3 * 256 ** 2))
    assert bd * 1e3 == pytest.approx(0.00047, rel=2e-3)


def test_fft_count():
    assert counts.fft2_flops(3, 512, 512) == 5 * 3 * 512 ** 2 * math.log2(512 ** 2)


def test_configs_count_from_their_traffic():
    cfg = harness.config("deconv_ffdnet")
    w = cfg.work(harness.traffic("deconv_ffdnet.512"))
    assert w["ffdnet_conv_flops_per_call"] == 48 * counts.ffdnet_flops(3, 96, 10, 512, 512)
    assert set(w["kernel_bound_s"]) == {"tv_denoise_chw", "freq_divide"}
    mix = dict(harness.traffic("jdd_ffdnet.2048"), size=512)
    jdd = harness.config("jdd_ffdnet").work(mix)
    assert jdd["ffdnet_conv_flops_per_call"] == 5 * counts.ffdnet_flops(3, 96, 10, 512, 512)
    assert jdd["kernel_bound_s"] == {"bdot": counts.bound_s(
        counts.bdot_bytes(1, 3 * 512 ** 2), counts.bdot_ops(1, 3 * 512 ** 2))}
    # an inner CG iteration: A p (4 FFTs) and M^-1 r (2), and 30 operations
    # an element
    fft = counts.fft2_flops(3, 512, 512)
    assert jdd["flops_per_cg_iteration"] == 6 * fft + 30 * 3 * 512 ** 2
    # a call: 5 outer iterations of FFDNet, CG's set-up (6 FFTs, 26
    # operations an element) and the ADMM updates (5), K^T b (2 FFTs), and
    # the 3x3 bilinear demosaic of each plane
    assert jdd["flops_per_call"]["fft"] == 5 * 6 * fft + 2 * fft
    assert jdd["flops_per_call"]["elementwise"] == 5 * 31 * 3 * 512 ** 2
    assert jdd["flops_per_call"]["demosaic"] == 3 * 2 * 9 * 512 ** 2
