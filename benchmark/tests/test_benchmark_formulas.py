"""The yardstick's arithmetic: the instance norm's bytes against
``chip_smoke.py``'s bound, and the FLOP count against a count by hand."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import formulas, harness
from benchmark.reference import otm
from one_to_many_gan_torch.presets import tiny_config


def test_instance_norm_bytes_match_chip_smoke():
    import chip_smoke

    assert harness.peaks()["hbm_bytes_per_s"] == chip_smoke.HBM_BYTES_PER_S
    config = harness.cell("otm_default_bf16.serve_n64")["config_file"]["config"]
    config = {**config, "tpu": {"precision": "bfloat16"}}
    work = formulas.serve_work(otm, config, 64, 1)
    want = sum(2 * c * h * w * 2 for c, h, w, _ in chip_smoke.ENCODE_SITES)
    assert work["instance_norm_sites"] == len(chip_smoke.ENCODE_SITES)
    assert work["instance_norm_bytes"] == want
    x = torch.empty((4, 256, 128, 64), dtype=torch.bfloat16)
    assert formulas.instance_norm_bytes(tuple(x.shape), 2) == 2 * x.numel() * x.element_size()


def _conv(c_in, c_out, k, h, w, groups=1):
    return 2 * c_out * (c_in // groups) * k * k * h * w


@pytest.mark.parametrize("n", [1, 8])
def test_flops_by_hand_at_a_tiny_config(n):
    config = tiny_config((32, 16), 2, min_latent=8, n_resnet_blocks=3)
    work = formulas.serve_work(otm, config, n, 1)
    # encode: stem 7x7 1->64 at 32x16; down 3x3 64->128 at 32x16, blur
    # (two depthwise 3-tap passes) at 32x16; 1 resnet block (two 3x3
    # 128->128) at 16x8
    blur = lambda c, h, w: 2 * _conv(c, c, 1, h, w, groups=c) * 3  # noqa: E731
    encode = (_conv(1, 64, 7, 32, 16) + _conv(64, 128, 3, 32, 16) + blur(128, 32, 16)
              + 2 * _conv(128, 128, 3, 16, 8))
    # decode: 2 modulated resnet blocks (two 3x3 128->128 at 16x8, style
    # affines 6->128); upsample blur at 32x16; modulated 3x3 128->64 at
    # 32x16; out 7x7 64->1; styles' demodulation matmuls
    style = lambda c_in: 2 * 6 * c_in  # noqa: E731
    demod = lambda c_in, c_out: 2 * c_in * c_out  # noqa: E731
    decode = (4 * (_conv(128, 128, 3, 16, 8) + style(128) + demod(128, 128))
              + blur(128, 32, 16) + _conv(128, 64, 3, 32, 16) + style(128) + demod(128, 64)
              + _conv(64, 1, 7, 32, 16))
    mapping = 2 * (2 * 6 * 6)
    assert work["encode_flops"] == encode
    assert work["decode_flops"] == decode
    assert math.isclose(work["flops_per_image"], decode + mapping + encode / n)
