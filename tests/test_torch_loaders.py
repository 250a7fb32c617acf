"""The port's checkpoint loaders: its own safetensors reader against the
`safetensors` package on files written in the test (every dtype the
format names that torch holds, scalars and empty tensors, two shards),
torch bins, and the refusal of a name that is not a local directory."""

import json
import os

import numpy as np
import pytest
import torch

from neural_speed_tpu_torch.convert import loaders


def _tensors(seed: int):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g)
    return {
        "a.f32": f(3, 5), "a.f16": f(4, 4).half(), "a.bf16": f(7).bfloat16(),
        "a.f64": f(2, 3).double(),
        "b.i64": torch.randint(-2 ** 40, 2 ** 40, (5,), generator=g),
        "b.i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 2), generator=g,
                               dtype=torch.int32),
        "b.i16": torch.randint(-300, 300, (6,), generator=g,
                               dtype=torch.int16),
        "b.i8": torch.randint(-128, 127, (3, 1), generator=g,
                              dtype=torch.int8),
        "b.u8": torch.randint(0, 255, (9,), generator=g, dtype=torch.uint8),
        "b.bool": f(4) > 0, "c.scalar": torch.tensor(2.5),
        "c.empty": torch.zeros((0, 3)),
        "c.fp8": f(8).to(torch.float8_e4m3fn),
    }


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    shards = [_tensors(0), {"d.w": torch.randn(16, 8).bfloat16()}]
    for i, t in enumerate(shards):
        save_file(t, str(tmp_path / f"model-{i:05d}-of-00002.safetensors"),
                  metadata={"format": "pt"})
    got = loaders.load_state_dict(str(tmp_path))
    want = {}
    for i in range(2):
        with safe_open(str(tmp_path / f"model-{i:05d}-of-00002.safetensors"),
                       framework="pt") as f:
            want.update({k: f.get_tensor(k) for k in f.keys()})
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert torch.equal(g.view(torch.uint8) if g.dtype.itemsize == 1
                           and g.is_floating_point() else g,
                           w.view(torch.uint8) if w.dtype.itemsize == 1
                           and w.is_floating_point() else w), key


def test_torch_bins_and_refusals(tmp_path):
    t = _tensors(1)
    del t["c.fp8"]
    torch.save(dict(list(t.items())[:5]), tmp_path / "pytorch_model-1.bin")
    torch.save(dict(list(t.items())[5:]), tmp_path / "pytorch_model-2.bin")
    got = loaders.load_state_dict(str(tmp_path))
    assert set(got) == set(t)
    assert all(torch.equal(got[k], t[k]) for k in t)
    with pytest.raises(FileNotFoundError, match="local"):
        loaders.load_state_dict("meta-llama/Llama-2-7b-hf")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        loaders.load_state_dict(str(tmp_path / "empty"))


def test_reader_reads_the_format_by_hand(tmp_path):
    """A file written byte by byte from the format's definition (8-byte
    little-endian header length, JSON header, raw little-endian data)."""
    a = np.arange(6, dtype="<f4").reshape(2, 3)
    b = np.array([1, -2], dtype="<i8")
    header = {"a": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]},
              "b": {"dtype": "I64", "shape": [2], "data_offsets": [24, 40]},
              "__metadata__": {"k": "v"}}
    raw = json.dumps(header).encode()
    with open(tmp_path / "x.safetensors", "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + a.tobytes()
                + b.tobytes())
    got = loaders.read_safetensors(str(tmp_path / "x.safetensors"))
    np.testing.assert_array_equal(got["a"].numpy(), a)
    np.testing.assert_array_equal(got["b"].numpy(), b)


def test_convert_model_reads_gptq_directories_and_gguf_files(tmp_path):
    """`convert_model` on a GPTQ directory (config.json + safetensors,
    written here) gives `params_from_quantized_state_dict`'s params, on a
    GGUF file `load_gguf_model`'s; read as a float checkpoint, the GPTQ
    directory lacks the float weights."""
    import dataclasses

    from safetensors.torch import save_file

    from neural_speed_tpu.convert import gguf as JG
    from neural_speed_tpu_torch.convert import convert_model
    from neural_speed_tpu_torch.convert import gguf as TG
    from neural_speed_tpu_torch.convert.gptq import \
        params_from_quantized_state_dict
    from neural_speed_tpu_torch.models.configs import arch_from_hf_config
    from tests.test_torch_gguf import HF, _state_dict as hf_state_dict
    from tests.test_torch_gptq import CFG, HF_CFG, _state_dict

    hf = dict(HF_CFG, model_type="llama", vocab_size=CFG["vocab_size"],
              hidden_size=CFG["hidden_size"], num_hidden_layers=2,
              num_attention_heads=CFG["n_heads"],
              num_key_value_heads=CFG["n_kv_heads"],
              intermediate_size=CFG["intermediate_size"])
    (tmp_path / "config.json").write_text(json.dumps(hf))
    sd = {k: torch.from_numpy(v) for k, v in _state_dict(3).items()}
    save_file(sd, str(tmp_path / "model.safetensors"))
    params, cfg = convert_model(str(tmp_path), use_quantized_model=True,
                                device="cpu")
    want = params_from_quantized_state_dict(sd, arch_from_hf_config(hf), hf)
    assert cfg == arch_from_hf_config(hf)
    for name in ("q", "o"):
        got_w, want_w = params["layers"][1][name]["w"], want["layers"][1][
            name]["w"]
        assert all(torch.equal(a, b) for a, b in zip(got_w.data, want_w.data))
        assert torch.equal(params["layers"][1][name]["perm"],
                           want["layers"][1][name]["perm"])
    # read as a float checkpoint, as the JAX package reads it: the float
    # projection weights are missing
    with pytest.raises(KeyError, match="q_proj.weight"):
        convert_model(str(tmp_path), device="cpu")

    path = str(tmp_path / "m.gguf")
    JG.write_hf_to_gguf(hf_state_dict(HF, 0), dict(HF, model_type="llama"),
                        path, ggml_type=JG.GGML_Q8_0)
    params, cfg = convert_model(path, device="cpu")
    want, want_cfg, _ = TG.load_gguf_model(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert torch.equal(params["layers"][0]["ffn"]["down"]["w"].data[0],
                       want["layers"][0]["ffn"]["down"]["w"].data[0])
