"""The roofline arithmetic reproduces the bounds of the port's kernel
table (PERF.md, "Every TPU kernel of the repo"): rows 1-3 at C 8, K 88,
p 32768, P 33; row 5 at R 512, N 2048 and at config6's N 480,000; row
10, the soft clip, at R 512, N 480,000."""
import pytest

from benchmark import roofline as rl

C, K, P_SIZE, NPARTS = 8, 88, 32768, 33


@pytest.mark.parametrize("name, got, want_ms, by", [
    ("frames_rfft", lambda: rl.frames_rfft(C, K, P_SIZE), 0.083, "bytes"),
    ("causal_mac", lambda: rl.causal_mac(C, K, P_SIZE, NPARTS), 0.113,
     "bytes"),
    ("irfft_valid", lambda: rl.irfft_valid(C, K, P_SIZE), 0.083, "bytes"),
    ("quantizer", lambda: rl.quantizer(512, 2048, "lattice_fir", 9), 0.005,
     "bytes"),
    ("quantizer_config6", lambda: rl.quantizer(512, 480000, "lattice_fir", 9),
     1.174, "bytes"),
])
def test_kernel_table_bounds(name, got, want_ms, by):
    ms, what = rl.bound(*got())
    assert what == by
    assert round(ms, 3) == want_ms


def test_f64_rows_double_the_bytes():
    """Rows 6 and 8 (f64): 0.165 ms by bytes."""
    for f in (rl.frames_rfft, rl.irfft_valid):
        ms, what = rl.bound(*f(C, K, P_SIZE, 8), item=8)
        assert (round(ms, 3), what) == (0.165, "bytes")


def test_least_time_takes_the_larger_bound():
    ops = 67e12 * 2                       # 2 s of f32 operations
    assert rl.least_s(3.35e12, ops) == pytest.approx(2.0)
    assert rl.least_s(3.35e12 * 4, ops) == pytest.approx(4.0)
    assert rl.least_s(3.35e12, ops, item=8) == pytest.approx(67 / 34 * 2)


def test_kernel_names():
    assert rl.is_kernel("void (anonymous namespace)::fwd_packed_pass1"
                        "<float2, true>(...)", rl.FORWARD)
    assert rl.is_kernel("causal_mac_kernel<float2>", rl.MAC)
    name = ("void (anonymous namespace)::soft_clip_local2x_kernel<float>"
            "(float const*, float*, int, int, int, (anonymous namespace)::"
            "Params<float>)")
    assert rl.is_kernel(name, rl.SOFT_CLIP)
    assert rl.is_kernel(name, rl.PORT_KERNELS)
    assert not rl.is_kernel(name, rl.QUANTIZER + rl.FORWARD)
    assert not rl.is_kernel("at::native::vectorized_elementwise_kernel",
                            rl.PORT_KERNELS)


def test_soft_clip_against_a_hand_count():
    """512 x 480,000 f32: 8 B a sample, y read and written once; 70
    operations a sample (two FIRs of 16 multiplies and 15 adds, the gains
    2, 0.5 and 0.5, the add, two clip tests of 2), bound by the bytes."""
    R, N = 512, 480000
    nbytes, ops = rl.soft_clip_local2x(R, N)
    assert nbytes == 1_966_080_000
    assert ops == R * N * (2 * (16 + 15) + 3 + 1 + 2 * 2)
    ms, what = rl.bound(nbytes, ops)
    assert (round(ms, 3), what) == (0.587, "bytes")
    worst = R * N * (rl.SOFT_CLIP_OPS + 2 * rl.SOFT_CLIP_KNEE_OPS)
    assert R * N * 144 == worst and rl.bound(nbytes, worst)[1] == "bytes"
    f64 = rl.soft_clip_local2x(8, 3840000, 8)
    assert rl.bound(*f64, item=8) == rl.bound(f64[0], 8 * 3840000 * 144,
                                              item=8)
