"""The repaired fault on the dense engine: tiny-moe with 8 experts in
float32, where idle and retired rows take MoE capacity, gives the JAX
package's greedy tokens at both packages' defaults (two chunks in
flight) and at the per-chunk settings, chunked and single-step, for
three prompt seeds (``tests/test_torch_decode_loop.py``'s
``binding_case``; the paged cases are in
``tests/test_torch_decode_loop_paged.py``, a file of their own so that
neither runs much over a minute)."""

import pytest
import torch

from tests.test_torch_decode_loop import binding_case


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [2, 3, 4])
@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "single_step"])
def test_dense_binding_capacity_tokens_equal_jax_defaults(monkeypatch,
                                                          chunked, seed):
    binding_case(monkeypatch, False, chunked, seed)
