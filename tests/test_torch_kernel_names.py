"""Which counted wrapper a profiler's kernel event belongs to
(``ops/cuda/__init__.py::wrapper_of``), by the names the profiler
(demangled) and ``cuobjdump`` (mangled) give the port's kernels; every
other kernel belongs to none."""

import pytest

from benchmark.harness.trace import kind
from var_tpu_torch.ops.cuda import counted_wrappers, wrapper_of

# the training-attention kernels of rows 5 and 6, by the kRow template
# argument; the fp32 path's delta kernel serves both rows and counts for none
TRAIN_ATTENTION = [
    ("void ptrain_dq_wgmma_kernel<6>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float*, "
     "__nv_bfloat16*, int, int, int, Ends)", "paired_train_bwd"),
    ("void ptrain_dkv_wgmma_kernel<6>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, int, Ends)",
     "paired_train_bwd"),
    ("void ptrain_dq_wgmma_kernel<5>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float*, "
     "__nv_bfloat16*, int, int, int, Ends)", "flash_attention_bwd"),
    ("void ptrain_dkv_wgmma_kernel<5>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, int, Ends)",
     "flash_attention_bwd"),
    ("void ptrain_dq_f32_kernel<5>(float const*, float const*, float const*, float const*, "
     "float const*, float const*, float*, int, int, int, Ends)", "flash_attention_bwd"),
    ("_Z22ptrain_dq_wgmma_kernelILi6EEv14CUtensorMap_stS0_S0_S0_PK13__nv_bfloat16S3_PKfPfPS1_iii4Ends",
     "paired_train_bwd"),
    ("_Z23ptrain_dkv_wgmma_kernelILi5EEv14CUtensorMap_stS0_S0_S0_PKfP13__nv_bfloat16S4_iii4Ends",
     "flash_attention_bwd"),
    ("void train_delta_f32_kernel(float const*, float const*, float*, int, int)", None),
    ("void ptrain_fwd_wgmma_kernel<5>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, float*, int, int, int, Ends)", "flash_attention_fwd"),
    ("void ptrain_fwd_wgmma_kernel<6>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, float*, int, int, int, Ends)", "paired_train_fwd"),
    ("_Z23ptrain_fwd_wgmma_kernelILi5EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16Pfiii4Ends",
     "flash_attention_fwd"),
]

# rows 1 and 3, every instantiation, demangled and mangled
ROWS_1_AND_3 = [
    ("void (anonymous namespace)::topk_topp_bound_kernel<1024>(float const*, int*, int, int, "
     "float)", "topk_topp_bound"),
    ("void (anonymous namespace)::topk_topp_bound_kernel<256>(float const*, int*, int, int, "
     "float)", "topk_topp_bound"),
    ("_ZN41_GLOBAL__N__1190a843_9_select_cu_3d17efc422topk_topp_bound_kernelILi512EEEvPKfPiiif",
     "topk_topp_bound"),
    ("void (anonymous namespace)::modulated_ln_kernel<__nv_bfloat16, 4>(__nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, long long, int, int, long long, long long, "
     "float, bool)", "modulated_layernorm"),
    ("void (anonymous namespace)::modulated_ln_kernel<float, 18>(float const*, float const*, "
     "float const*, float*, long long, int, int, long long, long long, float, bool)",
     "modulated_layernorm"),
    ("_ZN44_GLOBAL__N__bf3534bb_11_fused_ln_cu_87a5bffb19modulated_ln_kernel"
     "I13__nv_bfloat16Li4EEEvPKT_PKfS6_PS2_xiixxfb", "modulated_layernorm"),
]

# rows 2 and 4 (the kPaired false / true instantiations of one kernel),
# row 7, the decoder's GroupNorm-SiLU, the cache write, the fp32 forwards
# of rows 5 and 6; then kernels of no wrapper: the span stamp, cuBLAS,
# cuDNN (implicit GEMM and FFT) and PyTorch's own
OTHERS = [
    ("void decode_attention_wgmma_kernel<false>(CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16 const*, long long, long long, float const*, __nv_bfloat16*, int, int, "
     "float)", "flash_decode"),
    ("void decode_attention_kernel<false>(float const*, long long, long long, float const*, "
     "float const*, float*, int, int, int, float)", "flash_decode"),
    ("_Z23decode_attention_kernelILb0EEvPKfxxS1_S1_Pfiiif", "flash_decode"),
    ("void decode_attention_wgmma_kernel<true>(CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16 const*, long long, long long, float const*, __nv_bfloat16*, int, int, "
     "float)", "flash_decode_paired"),
    ("_Z29decode_attention_wgmma_kernelILb1EEv14CUtensorMap_stS0_PK13__nv_bfloat16xxPKfPS1_iif",
     "flash_decode_paired"),
    ("void (anonymous namespace)::gn_stats_kernel<float, 4>(float const*, float*, float*, int, "
     "int)", "gn_channel_stats"),
    ("void (anonymous namespace)::gn_silu_stats_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
     "float const*, float4*, int, int, int, int)", "gn_silu"),
    ("void (anonymous namespace)::gn_silu_finalize_kernel(float4 const*, float const*, "
     "float const*, float2*, int, int, int, float)", "gn_silu"),
    ("void (anonymous namespace)::gn_silu_apply_kernel<__nv_bfloat16, true>(__nv_bfloat16 "
     "const*, float2 const*, __nv_bfloat16*, int, int, int)", "gn_silu"),
    ("void kv_write_kernel<__nv_bfloat16, true>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16*, __nv_bfloat16*, long long, long long, int, int, int, int)", "kv_write"),
    ("void ptrain_fwd_f32_kernel<6>(float const*, float const*, float const*, float*, float*, "
     "int, int, int, Ends)", "paired_train_fwd"),
    ("void ptrain_dkv_f32_kernel<5>(float const*, float const*, float const*, float const*, "
     "float const*, float*, float*, int, int, int, Ends)", "flash_attention_bwd"),
    ("var_span_stamp_kernel", None),
    ("nvjet_tst_192x208_64x4_2x1_v_bz_coopB_bias_TNT", None),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize128x128x16", None),
    ("void DSE::regular_fft_pad<0, 1, 128, 16, 32, 1, float, float, float2>(float2*, float*, "
     "int, int3, float*, int, float*, float*, int, int, int, int, int, bool)", None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3>)", None),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>::operator()"
     "(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, float, 4, 4> >"
     "(at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
     "at::native::sum_functor<float, float, float>::operator()(at::TensorIterator&)::"
     "{lambda(float, float)#1}>, unsigned int, float, 4, 4>)", None),
]

# the frozen encoder's float32 convolution, both instantiations: its wrapper,
# and the benchmark files its time under convolutions (tokenizer_ms.train)
CONV3XTF32 = [
    ("void (anonymous namespace)::conv3xtf32_wgmma_kernel<160>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, float*, (anonymous namespace)::Geometry)",
     "conv3xtf32"),
    ("void (anonymous namespace)::conv3xtf32_wgmma_kernel<32>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, float*, (anonymous namespace)::Geometry)",
     "conv3xtf32"),
    ("_ZN46_GLOBAL__N__8dd27be3_13_conv3xtf32_cu_1f60781c23conv3xtf32_wgmma_kernelILi160EEEv"
     "14CUtensorMap_stS1_S1_PKfS3_PfNS_8GeometryE", "conv3xtf32"),
    ("_ZN46_GLOBAL__N__8dd27be3_13_conv3xtf32_cu_1f60781c23conv3xtf32_wgmma_kernelILi32EEEv"
     "14CUtensorMap_stS1_S1_PKfS3_PfNS_8GeometryE", "conv3xtf32"),
]

KERNEL_NAMES = TRAIN_ATTENTION + ROWS_1_AND_3 + OTHERS + CONV3XTF32


@pytest.mark.parametrize("name,wrapper", KERNEL_NAMES)
def test_wrapper_of_names_the_kernels_wrapper(name, wrapper):
    assert wrapper_of(name) == wrapper


@pytest.mark.parametrize("name", [name for name, _ in CONV3XTF32])
def test_the_benchmark_files_conv3xtf32_under_conv(name):
    assert kind(name) == "conv"


def test_every_counted_wrapper_has_a_listed_kernel():
    """A kernel added to ``counted_wrappers`` without a name here, or
    without a mapping in ``wrapper_of``, fails this test."""
    named = {wrapper_of(name) for name, _ in KERNEL_NAMES}
    assert {fn.__name__ for fn in counted_wrappers()} <= named
