"""The readers of the program's own ranges (SAM2's stages, its
synchronising copies, the attention calls, DiffuEraser's modules) on
made-up traces."""
from pathlib import Path

import pytest

from benchmark import harness, trace

BENCH = Path(__file__).resolve().parents[1]
R = trace.STAGE_RANGE
STEP = R + "sam2.step_dispatch"


def read(metric, t):
    return harness.load_file(BENCH / "metrics" / f"{metric}.py", "m").read(t)


def made_up(kernels, counts=None, frames=2):
    return trace.Trace(kernels=kernels, gaps=[], window_us=1000.0,
                       wall_s=0.001, frames=frames, chips=1,
                       peak_flops=989e12, peak_bytes=3.35e12,
                       counts=counts or {})


def k(name, start, end, *ranges, cls="glue"):
    return trace.Kernel(name, cls, start, end, tuple(ranges))


def test_sam2_stage_readers():
    t = made_up([
        k("Memcpy HtoD", 0, 10, R + "sam2.encode_dispatch",
          R + "sam2.encode", R + "sam2.upload"),
        k("gemm", 10, 50, R + "sam2.encode_dispatch", R + "sam2.encode"),
        k("gemm", 60, 100, STEP, R + "sam2.memory_attention",
          R + "attention:plain:2x1x4096x4112x256", cls="matmul"),
        k("softmax", 100, 110, STEP, R + "sam2.memory_attention"),
        k("gemm", 110, 130, STEP, R + "sam2.decode"),
        k("conv", 130, 136, STEP, R + "sam2.memory_encode"),
        k("Memcpy DtoH", 140, 141, R + "sam2.fetch")])
    assert read("sam2_encode_ms_per_frame.mask", t) == pytest.approx(0.025)
    assert read("sam2_memory_attention_ms_per_frame.mask", t) == \
        pytest.approx(0.025)
    assert read("sam2_decode_ms_per_frame.mask", t) == pytest.approx(0.01)
    assert read("sam2_memory_encode_ms_per_frame.mask", t) == \
        pytest.approx(0.003)
    # the parent's trace: no such ranges, so no reading
    bare = made_up([k("gemm", 0, 10, R + "propainter_prior")])
    for stage in ("encode", "memory_attention", "decode", "memory_encode",
                  "sync_idle"):
        assert read(f"sam2_{stage}_ms_per_frame.mask", bare) is None


def test_sync_idle_counts_the_waits_after_a_synchronising_copy():
    """A gap after a sam2.fetch copy (or a sam2.upload one) counts, a gap
    after a compute kernel does not, and the stretches before the first
    operation and after the last do not; the operation that ended last
    before a gap decides, not the last to start."""
    fetch, up = R + "sam2.fetch", R + "sam2.upload"
    t = made_up([
        k("gemm", 100, 200, STEP, R + "sam2.decode"),
        k("Memcpy DtoH", 200, 210, fetch),
        # 40 us idle after the fetch: the host walked to the next step
        k("Memcpy HtoD", 250, 252, R + "sam2.memory_attention", up),
        # 8 us idle after an upload
        k("gemm", 260, 400, STEP, R + "sam2.memory_attention"),
        # 100 us idle after a compute kernel: the host was late, no sync
        k("copy", 500, 505, STEP, R + "sam2.memory_attention", up),
        k("gemm", 503, 600, STEP, R + "sam2.memory_attention"),
        # 50 us idle after the gemm, though the upload started last
        k("gemm", 650, 700, STEP, R + "sam2.decode"),
        k("Memcpy DtoH", 700, 701, fetch)], frames=4)
    assert read("sam2_sync_idle_ms_per_frame.mask", t) == \
        pytest.approx((40 + 8) / 1e3 / 4)


def test_attention_roofline_of_every_route():
    """SAM2's attention roofline: the reference's least time over the
    device time of every kernel inside an attention call's range, the
    plain route's matmuls and softmax with the hand-written kernels."""
    call = (1, 8, 4096, 4096, 64)
    t = made_up([
        k("flash_fwd_kernel", 0, 100, R + "sam2.encode",
          R + "attention:flash:1x8x4096x4096x64", cls="attention"),
        k("gemm", 100, 150, STEP, R + "attention:plain:1x8x64x4096x64",
          cls="matmul"),
        k("softmax", 150, 200, STEP, R + "attention:plain:1x8x64x4096x64"),
        k("gemm", 200, 900, STEP, R + "sam2.decode", cls="matmul")],
        counts={"attention": {"sam2": [call, (1, 8, 64, 4096, 64)]}})
    least = 4 * 8 * 4096 * 4096 * 64 / 989e12 + max(
        4 * 8 * 64 * 4096 * 64 / 989e12,
        2 * 8 * 64 * (2 * 64 + 2 * 4096) / 3.35e12)
    assert read("attn_roofline.mask", t) == pytest.approx(
        100 * least / 200e-6)
    t.counts = {}
    assert read("attn_roofline.mask", t) is None
    assert read("attn_roofline.mask", made_up(
        [k("gemm", 0, 1, STEP)], counts={"attention": {"sam2": [call]}})) \
        is None


def test_diffueraser_module_readers():
    den = R + "diffueraser_denoise"
    t = made_up([
        k("conv", 0, 300, den, R + "dn.upload_encode", R + "dn.vae"),
        k("conv", 300, 400, den, R + "dn.windows", R + "dn.window",
          R + "dn.brushnet"),
        k("gemm", 400, 900, den, R + "dn.windows", R + "dn.window",
          R + "dn.unet"),
        k("add", 900, 910, den, R + "dn.windows"),
        k("conv", 910, 1200, den, R + "dn.decode_fetch", R + "dn.decode",
          R + "dn.vae")])
    assert read("vae_ms.infill", t) == pytest.approx(0.59)
    assert read("brushnet_ms.infill", t) == pytest.approx(0.1)
    assert read("unet_ms.infill", t) == pytest.approx(0.5)
    bare = made_up([k("conv", 0, 10, den)])
    for m in ("vae_ms.infill", "brushnet_ms.infill", "unet_ms.infill"):
        assert read(m, bare) is None
