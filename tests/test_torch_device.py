"""Entry points run on the card unless the caller asks for the CPU:
without CUDA and without ``device="cpu"`` they raise, never quietly
falling back. The kernel wrappers reject what their kernels do not take."""

import pytest
import torch

from xllm_service_tpu_torch.common.device import resolve_device
from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
from xllm_service_tpu_torch.models import llama
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.ops.fused_decode_attention import (
    fused_decode_attention,
)
from xllm_service_tpu_torch.ops.page_dma import (
    gather_kv_pages,
    scatter_kv_pages,
)
from xllm_service_tpu_torch.ops.paged_attention import (
    check_cuda_operands,
    paged_attention,
)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_cuda):
    cfg = EngineConfig(model=tiny_config(dtype=torch.float32,
                                         max_context_len=256),
                       num_pages=8, max_seq_len=64, hash_block_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(cfg.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_params_from_jax({})


def test_explicit_cpu_runs(no_cuda):
    cfg = EngineConfig(model=tiny_config(dtype=torch.float32,
                                         max_context_len=256),
                       num_pages=8, max_seq_len=64, hash_block_size=16)
    eng = InferenceEngine(cfg, device="cpu")
    assert eng.device.type == "cpu" and eng.kv_pages.device.type == "cpu"
    assert eng.params["lm_head"]["kernel"].device.type == "cpu"


def test_non_cpu_non_cuda_tensor_is_refused():
    q = torch.zeros((1, 4, 32), device="meta")
    pages = torch.zeros((2, 2, 4, 32), device="meta")
    idx = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(q, pages, pages, idx, idx[0])


@pytest.mark.parametrize("call", ["fused", "gather", "scatter"])
def test_new_wrappers_refuse_non_cpu_non_cuda_tensors(call):
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if call == "fused":
            q = torch.zeros((1, 4, 32), **meta)
            new = torch.zeros((1, 2, 32), **meta)
            pages = torch.zeros((2, 2, 4, 32), **meta)
            idx = torch.zeros((1, 1), dtype=torch.int32, **meta)
            fused_decode_attention(q, new, new, pages, pages, idx, idx[0])
        kv = torch.zeros((1, 2, 3, 2, 4, 8), **meta)
        if call == "gather":
            gather_kv_pages(kv, [1])
        scatter_kv_pages(kv, [1], torch.zeros((1, 2, 1, 2, 4, 8), **meta))


def test_operand_checks():
    q = torch.zeros((2, 4, 32), dtype=torch.float32)
    pages = torch.zeros((3, 2, 4, 32), dtype=torch.float32)
    ints = [torch.zeros((2, 2), dtype=torch.int32),
            torch.zeros((2,), dtype=torch.int32)]
    check_cuda_operands("k", q, pages, pages, ints, 16, 2)
    with pytest.raises(TypeError):
        check_cuda_operands("k", q.double(), pages, pages, ints, 16, 2)
    with pytest.raises(TypeError):
        check_cuda_operands("k", q, pages, pages, [ints[0].long()], 16, 2)
    with pytest.raises(ValueError, match="not supported"):
        check_cuda_operands("k", q, pages, pages, ints, 0, 2)
    with pytest.raises(ValueError, match="does not match"):
        check_cuda_operands("k", q[..., :24].contiguous(), pages, pages,
                            ints, 16, 2)
    with pytest.raises(ValueError, match="contiguous"):
        check_cuda_operands("k", q.transpose(0, 1), pages, pages, ints,
                            16, 2)
    with pytest.raises(ValueError, match="exceed"):
        check_cuda_operands("k", q, pages, pages, ints, 1, 2)
