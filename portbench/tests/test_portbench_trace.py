"""The kernel class table and the reduction of a trace's events."""

import pytest

from portbench import trace

NAMES = {
    "void tc::decode_tc_kernel<__nv_bfloat16, 128, 2, PagedPool<__nv_bfloat16> >(...)": "K3",
    "void tc::decode_tc_kernel<__nv_bfloat16, 128, 2, RingPool<__nv_bfloat16> >(...)": "K1",
    "void fma_split_kernel<float, 64, PagedPool<float> >(...)": "K3",
    # the merge of split partials is not K3's nor a copy
    "void decode_merge_kernel<128>(float const*, float const*, __nv_bfloat16*, int)": "K1/K3 merge",
    "void k2_fwd_wgmma_kernel<128>(CUtensorMap, ...)": "K2f",
    "void k2_dkdv_wgmma_kernel<128>(CUtensorMap, ...)": "K2b",
    "void k2_dq_wgmma_kernel<128>(CUtensorMap, ...)": "K2q",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#12}::operator()() const::{lambda(c10::BFloat16)#1}, std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigned int>, TrivialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, at::native::memory::StoreWithCast<1> >(...)": "cast copies",
    "void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#12}::operator()() const::{lambda(c10::BFloat16)#1}, std::array<char*, 2ul> >(int, ...)": "copies",
    "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN": "matmul",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "matmul",
    "void at::native::vectorized_elementwise_kernel<4, at::native::silu_kernel(...)": "other",
}


@pytest.mark.parametrize("name,cls", sorted(NAMES.items()))
def test_classes(name, cls):
    assert trace.classify(name) == cls


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_union_and_gaps():
    ev = [_ev("user_annotation", trace.WINDOW, 100, 100),
          _ev("kernel", "nvjet_x", 90, 30),         # clipped to [100, 120]
          _ev("kernel", "k2_fwd_x", 110, 20),       # overlaps: union [100, 130]
          _ev("gpu_memcpy", "Memcpy HtoD", 150, 10),
          _ev("kernel", "decode_merge_kernel<1>", 190, 50),  # [190, 200]
          _ev("user_annotation", "step", 100, 100),
          _ev("cpu_op", "aten::_local_scalar_dense", 131, 18),
          _ev("cuda_runtime", "cudaStreamSynchronize", 135, 10)]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 10 + 10) * 1e-6)
    assert s["classes"]["matmul"][0] == pytest.approx(20e-6)
    assert s["classes"]["K1/K3 merge"] == [pytest.approx(10e-6), 1]
    # gaps: [130, 150] (mid 140: the sync inside the readback, under "step")
    # and [160, 190] (mid 175: only "step")
    assert s["idle"]["step > cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert s["idle"]["step"] == pytest.approx(30e-6)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "matmul"
    assert len(b["idle_gaps"]) == 2


def test_summarize_without_device_ops():
    assert trace.summarize([_ev("user_annotation", trace.WINDOW, 0, 10)]) \
        is None
    assert trace.summarize([]) is None
