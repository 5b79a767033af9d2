"""The yardstick's counts against numbers derived by hand."""

import pytest

from portbench import harness, work

DQN = harness.load_json(harness.ROOT / "portbench" / "configs" / "dqn_full.json")
QR = harness.load_json(harness.ROOT / "portbench" / "configs" / "qrdqn_full_n200.json")


def test_fused_update_counts_at_bench_batch():
    # F = 128*512 + 512*256 + 256*8 = 198,656 MACs a row; double Q runs three
    # forwards, the weight gradients (F) and the activation gradients past the
    # first layer (F - 128*512): 2 * 4096 * 927,744 FLOPs
    assert work.forward_macs(DQN) == 198_656
    assert work.matmul_flops_per_step(DQN, 4096) == 2 * 4096 * 927_744 == 7_600_078_848
    bound_s, which = work.fused_update_bound_s(DQN, 4096, work.peaks_for("NVIDIA H100 80GB HBM3"))
    assert which == "operations"
    assert bound_s * 1e3 == pytest.approx(0.1134, abs=5e-5)  # chip_smoke.py's K1 bound


def test_fused_update_bytes():
    P = 128 * 512 + 512 + 512 * 256 + 256 + 256 * 8 + 8
    B = 16384
    assert work.parameter_count(DQN) == P
    assert work.fused_update_bytes(DQN, B) == 4 * (2 * B * 128 + 2 * B * 8 + 2 * B + 2 + 16 * P + 4)


def test_qr_step_counts():
    # F = 128*512 + 512*256 + 256*1600 = 606,208; 2 * 16384 * (5F - 65,536)
    assert work.output_dim(QR) == 1600
    assert work.forward_macs(QR) == 606_208
    flops = work.matmul_flops_per_step(QR, 16384)
    assert flops == 2 * 16384 * 2_965_504
    assert flops / 1e9 == pytest.approx(97.2, abs=0.05)


def test_quantile_huber_least_work():
    B, N = 65536, 200
    assert work.quantile_huber_flops(B, N) == 7 * B * N * N
    assert work.quantile_huber_bytes(B, N) == 4 * (3 * B * N + B)
    bound_s, which = work.quantile_huber_bound_s(B, N, work.peaks_for("NVIDIA H100 80GB HBM3"))
    assert which == "operations"
    assert bound_s == pytest.approx(7 * B * N * N / 67e12)


def test_peaks_by_card_name():
    assert work.peaks_for("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    assert work.peaks_for("NVIDIA H100 PCIe")["f32_flops"] == 51e12
    with pytest.raises(RuntimeError):
        work.peaks_for("cpu")
