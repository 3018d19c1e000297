"""The profilers' trace accounting (``brever_tpu_torch.profile_enhance``,
shared by ``profile_train``): kernel names without return type, template
and argument lists, and the device's busy time as the union of its events'
intervals. The profilers themselves need a card."""

from types import SimpleNamespace

import pytest
import torch

from brever_tpu_torch.profile_enhance import _device_time, _kernel_name

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


@pytest.mark.parametrize('name,short', [
    ('std::enable_if<!(T7), void>::type internal::gemvx::kernel<int, '
     'float2, cublasGemvParamsEx<int, float2> >(cublasGemvParamsEx<int, '
     'float2>)', 'internal::gemvx::kernel'),
    ('void at::native::elementwise_kernel<128, 4, at::native::Functor<float> '
     '>(int, at::native::Functor<float>)', 'at::native::elementwise_kernel'),
    ('void (anonymous namespace)::gn_apply<true>(float const*, int, float*)',
     'gn_apply'),
    ('gn_merge(double2 const*, float const*)', 'gn_merge'),
    ('Memcpy HtoD (Pageable -> Device)', 'Memcpy HtoD'),
    ('sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n', 'sm80_xmma_gemm_cf32cf32_'
     'f32f32_cf32_tn_n'),
])
def test_kernel_name(name, short):
    assert _kernel_name(name) == short


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def _trace(*events):
    return SimpleNamespace(events=lambda: [
        SimpleNamespace(device_type=kind, name=name, time_range=_Range(a, b))
        for kind, name, a, b in events])


def test_device_time_is_the_union_of_overlapping_events():
    busy, kernels = _device_time(_trace(
        (CUDA, 'void k<1>(int)', 0, 10), (CUDA, 'void k<2>(int)', 5, 12),
        (CPU, 'aten::add', 0, 100), (CUDA, 'm', 20, 25), (CUDA, 'm', 21, 23)))
    assert busy == 17.0     # [0, 12) and [20, 25)
    assert dict(kernels) == {'k': [17.0, 2], 'm': [7.0, 2]}


def test_device_time_without_device_events_raises():
    with pytest.raises(RuntimeError, match='no device activity'):
        _device_time(_trace((CPU, 'aten::add', 0, 100)))
