"""MPT, BLOOM and Falcon through both packages' `PagedEngine` (page size
16) on the CPU, over the default bf16 pool and over int8: as
`test_torch_hf_models.py`."""

import pytest

from tests.torch_hf_models import check_arch


@pytest.mark.parametrize("kv", ["default", "int8"])
@pytest.mark.parametrize("name", ["mpt", "bloom", "falcon"])
def test_alibi_and_layernorm_archs_paged_match_jax(name, kv):
    check_arch(name, kv, paged=True)
