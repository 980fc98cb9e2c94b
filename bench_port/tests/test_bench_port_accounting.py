"""The yardstick's arithmetic against the program's own."""

import pytest

from bench_port import accounting


def test_flops_at_the_cells_width():
    assert accounting.augmented_width(160 * 21) == 3456
    assert accounting.plm_flops_per_seq_site(160, 21) == 303744


@pytest.mark.parametrize("lq", [1, 127, 128, 3360, 3456, 4999])
def test_augmented_width_matches_the_program(lq):
    from evcouplings_torch.ops.plm import _augmented_width

    assert accounting.augmented_width(lq) == _augmented_width(lq)


def test_peaks_by_card_name():
    peaks = accounting.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["fp32_simt"] == 66.9e12 and peaks["bf16_tensor"] == 989.4e12
    assert accounting.device_peaks("cpu") is None
    least = accounting.least_seconds(66.9e12, 0, 66.9e12, peaks)
    assert least == 1.0
