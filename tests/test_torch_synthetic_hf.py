"""`utils/synthetic.hf_shapes` / `synth_hf_state_dict`, which draw the
full-size float checkpoints that `chip_smoke.py` converts and serves on the
card, against `transformers`' own models at a tiny size: for each layout
(llama, mpt, bloom, falcon, gemma, gptj, phi, gpt_neox) the names and shapes equal
those of the `transformers` model's state dict, but for the tied head's
alias, which must share the embedding's storage there; and the drawn
checkpoint converts with `convert/hf.py` (int4 g32) into params that a CPU
`Engine` serves to finite logits."""

import pytest
import torch

from neural_speed_tpu_torch.convert.hf import params_from_state_dict
from neural_speed_tpu_torch.models.configs import arch_from_hf_config
from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
from neural_speed_tpu_torch.runtime.engine import Engine
from neural_speed_tpu_torch.utils.synthetic import (hf_shapes,
                                                    synth_hf_state_dict)

from tests.test_torch_hf import _tf
from tests.test_torch_hf_head_dims import HEAD_DIM_KW

torch.set_num_threads(1)

# model_type -> (the tiny `transformers` builder's name, its config knobs)
LAYOUTS = {"llama": ("llama", {}), "mpt": ("mpt", {}), "bloom": ("bloom", {}),
           "falcon": ("falcon", {}), "gemma": ("gemma", HEAD_DIM_KW["gemma"]),
           "gptj": ("gptj", HEAD_DIM_KW["gptj"]),
           "phi": ("phi", HEAD_DIM_KW["phi"]),
           "gpt_neox": ("gptneox", HEAD_DIM_KW["gptneox"])}


@pytest.mark.parametrize("model_type", list(LAYOUTS))
def test_hf_shapes_match_transformers(model_type):
    name, kw = LAYOUTS[model_type]
    cls, config = _tf(name, **kw)
    torch.manual_seed(0)
    with torch.no_grad():
        model = cls(config)
    want = model.state_dict()
    cfg = arch_from_hf_config(config.to_dict())
    shapes = hf_shapes(model_type, cfg)
    assert {k: tuple(want[k].shape) for k in shapes if k in want} == shapes
    for alias in set(want) - set(shapes):
        assert any(want[alias].data_ptr() == want[k].data_ptr()
                   for k in shapes), f"{alias} is not a tied alias"
    sd = synth_hf_state_dict(model_type, cfg, seed=1, device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    params = params_from_state_dict(
        sd, cfg, QSpec(QType.INT, 4, 32, True, scale_dtype="bfloat16"),
        device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    eng = Engine(params, cfg, max_batch=1, max_len=64, device="cpu")
    logits = eng.prefill([[1, 5, 9, 17]])
    assert logits.shape == (1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
