"""The yardstick's arithmetic against hand counts at the cells' shapes."""
import pytest

from harness import roofline, stats, trace


def test_encoder_flops_by_hand():
    # one 10 s sequence of ATST base: 250 tokens, width 768, MLP 3072, 12
    # blocks; per block qkv 2*250*768*2304, scores and values 2*2*250^2*768,
    # proj 2*250*768^2, MLP 2*2*250*768*3072; patch projection 2*250*256*768
    per_block = (884_736_000 + 192_000_000 + 294_912_000 + 2_359_296_000)
    want = 12 * per_block + 98_304_000
    assert roofline.encoder_flops(1, 250, 768, 3072, 12, 256) == want
    assert want == pytest.approx(44.86e9, rel=1e-3)


def test_frame_step_flops_by_hand():
    cfg = dict(n_mels=64, patch_freq=64, patch_time=4, crop_frames=1001,
               hidden_size=768, intermediate_size=3072, num_layers=12,
               head_hidden=4096, head_out=256)
    enc = 288 * roofline.encoder_flops(1, 250, 768, 3072, 12, 256)
    rows = 288 * 250
    proj = 2 * rows * (768 * 4096 + 4096 * 256)
    pred = 2 * rows * (256 * 4096 + 4096 * 256)
    want = 3 * (enc + proj + pred) + enc + proj
    assert roofline.frame_pretrain_step_flops(cfg, 144) == pytest.approx(want)
    assert want == pytest.approx(55.06e12, rel=1e-3)


def test_clip_finetune_flops_by_hand():
    cfg = dict(n_mels=64, patch_freq=64, patch_time=4, chunk_frames=601,
               hidden_size=768, intermediate_size=3072, num_layers=12,
               head_blocks=12)
    tr = dict(crop_s=12.0, batch=64, num_labels=527)
    # 1201 frames -> two chunks of 601 frames: 150 patches and CLS
    enc = 128 * roofline.encoder_flops(1, 151, 768, 3072, 12, 256)
    head = 2 * 64 * 18432 * 527
    assert roofline.clip_finetune_step_flops(cfg, tr) == pytest.approx(
        3 * (enc + head))


def test_kernel_bounds_by_hand():
    # K2 at serving's [128, 250, 768], 12 heads: operations bound it
    ops = 8 * 32000 * 768 ** 2 + 4 * 768 * 128 * 250 ** 2
    got = roofline.kernel_bound_s("attn_block", (128, 250, 768, 12), {})
    assert got == pytest.approx(ops / 989e12)
    # K3 [128, 250, 768] with hidden 3072
    got = roofline.kernel_bound_s("mlp_block", (128, 250, 768, 3072), {})
    assert got == pytest.approx(4 * 32000 * 768 * 3072 / 989e12)
    # K7 over 1e6 elements, 5e5 with a teacher copy: bytes bound it
    ctx = {"adamw_elements": 10 ** 6, "adamw_teacher_elements": 5 * 10 ** 5}
    got = roofline.kernel_bound_s("adamw_ema", (3, 500), ctx)
    assert got == pytest.approx(4 * (7e6 + 1e6) / 3.35e12)
    # K8 backward, bf16 [48000, 768]
    got = roofline.kernel_bound_s("ln_pg_bwd", (132, 1, 48000, 768), {})
    assert got == pytest.approx((2 * 3 * 48000 * 768 + 4 * 3 * 768) / 3.35e12)
    # K1 over the recipe's filterbank at [96, 1026, 1001]: bytes bound it
    from reference import atst as ref
    lo, hi, terms = band = roofline.mel_band(ref.mel_filterbank())
    assert 0 < lo < hi < 513 and terms > 64
    got = roofline.kernel_bound_s("mel_db", (96, 513, 1001, 64, 3, 400),
                                  {"mel_band": band})
    nbytes = 4 * (2 * (hi - lo + 1) * 96 * 1001 + 64 * 96 * 1001)
    assert got == pytest.approx(nbytes / 3.35e12)
    assert roofline.kernel_bound_s("not_a_kernel", (1,), {}) is None


def test_percentile():
    v = list(range(1, 101))  # 1..100
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile(list(reversed(v)), 50) == pytest.approx(50.5)
    assert stats.percentile([3.0], 95) == 3.0


def _ev(a, b, kind="kernel", name="k"):
    return trace.Event(kind, name, a, b)


def test_idle_union_of_intervals():
    window = (0.0, 10.0)
    evs = [_ev(1, 3), _ev(2, 4), _ev(6, 7), _ev(9, 12), _ev(-1, 0.5)]
    # covered: [0, 0.5], [1, 4], [6, 7], [9, 10] -> 5.5 s
    assert trace.busy_seconds(evs, window) == pytest.approx(5.5)
    gaps = trace.idle_gaps(evs, window)
    assert gaps[0] == (4, 6)
    assert sum(b - a for a, b in gaps) == pytest.approx(4.5)


def test_per_name_seconds_keeps_launches():
    # 3 units of 2 launches of 1 ms; one record lost
    evs = [_ev(i, i + 0.001, name="k") for i in range(5)]
    got = trace.per_name_seconds(evs, 3)
    assert got["k"] == pytest.approx(0.006)


def test_kernel_identifier():
    assert trace.kernel_identifier(
        "void attn::attn_fwd_mma_kernel<128, (bool)1>(Params const*)") \
        == "attn_fwd_mma_kernel"


def test_judge_reads_missing_and_non_finite_as_over():
    from harness import compare

    ok, checks = compare.judge({"a": 0.1, "b": float("inf")},
                               {"a": 0.2, "b": 1.0, "c": 1.0})
    assert not ok
    assert checks == {"a": {"value": 0.1, "limit": 0.2},
                      "b": {"value": "inf", "limit": 1.0},
                      "c": {"value": None, "limit": 1.0}}
    assert compare.judge({"a": 0.1}, {"a": 0.2})[0]
