"""MPT, BLOOM and Falcon through both packages' `Engine` on the CPU, over
the engines' default bf16 cache (no KV arguments on either side) and over
int8 (`kv_quantized=True`): logits within LOGIT_TOL, identical greedy ids
over 8 steps with clear top-2 margins (`tests/torch_hf_models.py` has the
setup and the tolerances).  `test_torch_hf_paged_models.py` runs the same
through `PagedEngine`."""

import pytest

from tests.torch_hf_models import check_arch


@pytest.mark.parametrize("kv", ["default", "int8"])
@pytest.mark.parametrize("name", ["mpt", "bloom", "falcon"])
def test_alibi_and_layernorm_archs_match_jax(name, kv):
    check_arch(name, kv)
