"""The other mappers' archs through both packages' `Engine` on the CPU
(default bf16 cache and int8), as `test_torch_hf_models.py`: gptj,
gptneox, opt, starcoder, phi, stablelm."""

import pytest

from tests.torch_hf_models import check_arch


@pytest.mark.parametrize("kv", ["default", "int8"])
@pytest.mark.parametrize("name", ["gptj", "gptneox", "opt", "starcoder",
                                  "phi", "stablelm"])
def test_other_mapper_archs_match_jax(name, kv):
    check_arch(name, kv)
