"""int8 K/V codes with float32 scales: the port's caches against the JAX
package's on the CPU.

The JAX caches take `scale_dtype=jnp.float32` (or read
`NST_KV_SCALE_DTYPE=f32` when they are built) and the engines
`kv_scale_dtype=`; every writer computes the codes against the float32
scale and only the stored copy rounds, so at float32 the stored scale is
the scale itself.  Held, contiguous and paged, under the argument and
under the environment variable: a prefill span (slot 0's 11 real rows and
padding, slot 1 inactive), then three decode appends with slot 1 a
spectator, and the port's codes and scales equal JAX's byte for byte (the
pool on every page but the trash page); the default stays bf16; the
engines pass `kv_scale_dtype` to both caches.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import kv_cache as jkv
from neural_speed_tpu.ops import paged_kv as jpk
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.ops import kv_cache as tkv
from neural_speed_tpu_torch.ops import paged_kv as tpk
from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine

from tests.torch_port_util import jax_bf16, to_numpy, torch_bf16, \
    torch_to_numpy

torch.set_num_threads(1)
L, H, D, S, T = 2, 4, 16, 256, 16


def _caches(paged, how, rng, monkeypatch):
    """A JAX and a port cache of int8 codes with float32 scales, asked for
    by `how`: "argument" or "environment"."""
    kw_j, kw_t = {}, {}
    if how == "argument":
        kw_j, kw_t = dict(scale_dtype=jnp.float32), dict(
            scale_dtype=torch.float32)
    else:
        monkeypatch.setenv("NST_KV_SCALE_DTYPE", "f32")
    if not paged:
        return (jkv.init_cache(L, 2, S, H, D, quantized=True, **kw_j),
                tkv.init_cache(L, 2, S, H, D, quantized=True, device="cpu",
                               **kw_t))
    nb, ps = S // 16, 16
    n_pages = 2 * nb + 1
    tables = rng.permutation(n_pages - 1).reshape(2, nb).astype(np.int32)
    jc = jpk.init_paged_cache(L, 2, S, H, D, n_pages, ps, quantized=True,
                              **kw_j)
    jc = jpk.PagedKVCache(jc.k_pages, jc.v_pages, jc.k_scale, jc.v_scale,
                          jnp.asarray(tables), jc.lengths)
    tc = tpk.init_paged_cache(L, 2, S, H, D, n_pages, ps, quantized=True,
                              device="cpu", **kw_t)
    tc.page_tables.copy_(torch.from_numpy(tables))
    return jc, tc


@pytest.mark.parametrize("how", ["argument", "environment"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_float32_scale_caches_bit_identical(paged, how, monkeypatch):
    rng = np.random.default_rng(5 + paged)
    jc, tc = _caches(paged, how, rng, monkeypatch)
    names = (("k_pages", "v_pages", "k_scale", "v_scale") if paged
             else ("k", "v", "k_scale", "v_scale"))
    assert getattr(tc, names[2]).dtype == torch.float32
    assert getattr(jc, names[2]).dtype == jnp.float32
    if paged:
        span = (jpk.append_span, tpk.append_span)
        dec = (jpk.append_decode, tpk.append_decode)
    else:
        span = dec = (jkv.append_layer, tkv.append_layer)

    def same():
        for name in names:
            want = to_numpy(getattr(jc, name))
            got = torch_to_numpy(getattr(tc, name))
            if paged:
                want, got = want[:, :, :-1], got[:, :, :-1]
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)

    kv = lambda n: [jax_bf16(3 * rng.standard_normal((2, n, H, D)).astype(
        np.float32)) for _ in range(2)]
    lens = np.array([11, 0], np.int32)
    ar = np.arange(T)[None]
    pos = np.where(ar < lens[:, None], ar, S - 1).astype(np.int32)
    active = lens > 0
    k, v = kv(T)
    jc = span[0](jc, 1, k, v, jnp.asarray(pos), active=jnp.asarray(active))
    span[1](tc, 1, torch_bf16(k), torch_bf16(v), torch.from_numpy(pos),
            active=torch.from_numpy(active))
    same()
    lengths = lens.copy()
    for _ in range(3):
        k, v = kv(1)
        act = np.array([True, False])
        p = np.where(act, lengths, S - 1)[:, None].astype(np.int32)
        for layer in range(L):
            jc = dec[0](jc, layer, k, v, jnp.asarray(p),
                        active=jnp.asarray(act))
            dec[1](tc, layer, torch_bf16(k), torch_bf16(v),
                   torch.from_numpy(p), active=torch.from_numpy(act))
        lengths = lengths + act
        same()
    # float32 scales keep bits that a bf16 copy drops
    sc = getattr(tc, names[2])
    assert not torch.equal(sc, sc.to(torch.bfloat16).float())


def test_scale_dtype_default_and_refusal(monkeypatch):
    """bf16 unless asked; the environment variable's other values keep
    bf16; a scale dtype other than bf16 or float32 raises."""
    monkeypatch.delenv("NST_KV_SCALE_DTYPE", raising=False)
    assert tkv.init_cache(1, 1, 64, 1, 16, quantized=True,
                          device="cpu").k_scale.dtype == torch.bfloat16
    for val, want in (("float32", torch.float32), ("bf16", torch.bfloat16),
                      ("f16", torch.bfloat16)):
        monkeypatch.setenv("NST_KV_SCALE_DTYPE", val)
        assert tkv.kv_scale_dtype() == want
        assert tpk.init_paged_cache(1, 1, 64, 1, 16, 5, 16, quantized=True,
                                    device="cpu").k_scale.dtype == want
    assert tkv.kv_scale_dtype(torch.bfloat16) == torch.bfloat16
    with pytest.raises(ValueError, match="bf16 or float32"):
        tkv.kv_scale_dtype(torch.float16)


@pytest.mark.parametrize("engine", [Engine, PagedEngine])
def test_engines_take_kv_scale_dtype(engine, monkeypatch):
    """`kv_scale_dtype` reaches the engines' caches, and with None the
    environment variable decides, as in the JAX engines."""
    cfg = ArchConfig(name="llama", vocab_size=64, hidden_size=64, n_layers=1,
                     n_heads=4, n_kv_heads=2, intermediate_size=128)
    monkeypatch.delenv("NST_KV_SCALE_DTYPE", raising=False)
    eng = engine({"layers": []}, cfg, max_len=128, kv_quantized=True,
                 kv_scale_dtype=torch.float32, device="cpu")
    assert eng.cache.k_scale.dtype == eng.cache.v_scale.dtype == torch.float32
    assert engine({"layers": []}, cfg, max_len=128, kv_quantized=True,
                  device="cpu").cache.k_scale.dtype == torch.bfloat16
    monkeypatch.setenv("NST_KV_SCALE_DTYPE", "f32")
    assert engine({"layers": []}, cfg, max_len=128, kv_quantized=True,
                  device="cpu").cache.k_scale.dtype == torch.float32
