"""The yardstick's arithmetic on shapes worked by hand."""

import pytest

from core import counts
from core.runner import load_spec


def test_flash_forward_full_and_causal():
    ops, n_bytes = counts.flash_fwd_work(2, 3, 10, 20, 64, causal=False)
    assert ops == 4 * 2 * 3 * 64 * 10 * 20
    assert n_bytes == 2 * 2 * 3 * 64 * (2 * 10 + 2 * 20) + 4 * 2 * 3 * 10
    ops_c, _ = counts.flash_fwd_work(2, 3, 10, 10, 64, causal=True)
    assert ops_c == 4 * 2 * 3 * 64 * 55  # 10 * 11 / 2 query-key pairs


def test_flash_backward_counts_five_products():
    ops, n_bytes = counts.flash_bwd_work(1, 1, 4, 6, 64, causal=False)
    assert ops == 10 * 64 * 24
    assert n_bytes == 2 * 64 * (4 * 4 + 4 * 6) + 4 * 4


def test_quant_cross_reads_real_positions_and_all_scales():
    ops, n_bytes = counts.quant_cross_work(32, 1500, 1536, 512)
    assert ops == 4 * 32 * 1500 * 512
    assert n_bytes == 2 * 32 * 1500 * 512 + 8 * 32 * 1536 + 4 * 32 * 512


def test_bound_takes_the_larger_time():
    assert counts.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(67e12, 1.0, counts.PEAK_F32_FLOPS) == pytest.approx(1.0)


def test_encoder_flops_of_base_en():
    g = load_spec("serve.base.en.biased32")["g"]
    d, t = 512, 1500
    conv = 2 * 3000 * d * 3 * 80 + 2 * t * d * 3 * d
    layers = 6 * (24 * t * d * d + 4 * t * t * d)
    assert counts.encoder_flops(g) == conv + layers


def test_training_counts_a_backward_of_twice_the_forward():
    g = load_spec("train.base.en.weightce")["g"]
    s = 300
    fwd = (counts.encoder_flops(g) + 6 * 4 * 1500 * 512 ** 2
           + 6 * (28 * s * 512 ** 2 + 4 * s * (s + 1) / 2 * 512 + 4 * s * 1500 * 512)
           + 2 * s * 512 * 51864)
    assert counts.train_row_flops(g, s) == pytest.approx(3 * fwd)


def test_serving_row_counts_prefill_and_steps():
    g = load_spec("serve.large-v3.biased32")["g"]
    base = counts.encoder_flops(g) + counts.cross_kv_flops(g)
    pre = counts.decoder_tokens_flops(g, 70, 35.5)
    assert counts.serve_row_flops(g, 70, 0) == pytest.approx(base + pre)
    one = counts.serve_row_flops(g, 70, 1) - counts.serve_row_flops(g, 70, 0)
    assert one == pytest.approx(counts.decoder_tokens_flops(g, 1, 71))
