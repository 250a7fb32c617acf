"""The rope archs of the llama mapper through both packages' `Engine` on
the CPU (default bf16 cache and int8), as `test_torch_hf_models.py`:
llama, mistral, mixtral, qwen2, phi3, gemma, baichuan."""

import pytest

from tests.torch_hf_models import check_arch


@pytest.mark.parametrize("kv", ["default", "int8"])
@pytest.mark.parametrize("name", ["llama", "mistral", "mixtral", "qwen2",
                                  "phi3", "gemma", "baichuan"])
def test_llama_mapper_archs_match_jax(name, kv):
    check_arch(name, kv)
