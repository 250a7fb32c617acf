"""Every pack a Pallas kernel of the JAX package takes has a CUDA kernel in
the port (a guard, on the CPU, that no such pack raises on the card).

The formats are enumerated: every INT width 1..8, symmetric / uint8 zero
points / float offsets, bf16 / float32 / double-quantized scales, groups
16, 32 and 128, K = 4096 and Llama-2-7B's FFN-down K = 11008.  Each pack
goes through both packages' load-time repack (`transformer._kernel_pack`:
the K-repad, and in the JAX package the widening of odd widths its planar
kernel does not take).  Where the JAX package's gates (`_pallas_supported`,
`_planar_supported`) say yes, the port's pack must be taken by a kernel,
formats and shapes (`matmul.kernel_takes`).  Likewise for expert stacks:
where `_stack_kernel_ok` says yes, a grouped kernel takes the port's stack
(`moe.grouped_kernel_takes`).  The NF4 / FP4 and FP8 packs are held the
same way.  Packs in K slabs (`k_shards > 1`), which the JAX package runs on
XLA, raise in the port, naming the format.
"""

import dataclasses
import importlib
import itertools

import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.models import transformer as jtr
from neural_speed_tpu.ops import matmul as jm
from neural_speed_tpu.ops import moe as jmoe
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu_torch.models import transformer as ttr
from neural_speed_tpu_torch.ops import matmul as tm
from neural_speed_tpu_torch.ops import moe as tmoe

from tests.torch_port_util import port_qtensor, tree_to_numpy

jq = importlib.import_module("neural_speed_tpu.ops.quantize")

N = 8
ZEROS = ("sym", "uint8", "float")
SCALES = ("bfloat16", "float32", "double-quant")


def _jax_pack(qtype, bits, zeros, scales, g, k, k_shards=1):
    """A JAX pack of zero codes in the given format (the gates read the
    spec, the shapes and the dtypes, not the values)."""
    spec = JSpec(qtype, bits, g, symmetric=zeros == "sym",
                 scale_dtype="float32" if scales == "double-quant"
                 else scales, double_quant=scales == "double-quant")
    groups = k // g
    if spec.is_fp8:
        data = (jnp.zeros((k, N), jnp.float8_e4m3fn),)
    else:
        data = jq.pack_codes(jnp.zeros((k, N), jnp.uint8),
                             4 if spec.is_lut else bits, k_shards)
    if scales == "double-quant":
        sc = jnp.ones((groups, N), jnp.int8)
        sscale = jnp.ones((1, N), jnp.float32)
    else:
        sc = jnp.ones((groups, N), getattr(jnp, scales))
        sscale = None
    z = {"sym": None, "uint8": jnp.zeros((groups, N), jnp.uint8),
         "float": jnp.zeros((groups, N), jnp.float32)}[zeros]
    return jq.QTensor(data, sc, z, sscale, spec, (k, N), k_shards)


def _both(jqt):
    """Both packages' load-time repack of the same pack."""
    return jtr._kernel_pack(jqt), ttr._kernel_pack(port_qtensor(jqt))


def _ref_takes(jqt) -> bool:
    return jm._pallas_supported(jqt) or jm._planar_supported(jqt)


@pytest.mark.parametrize("k", [4096, 11008])
@pytest.mark.parametrize("bits", range(1, 9))
def test_every_pack_a_pallas_kernel_takes_has_a_kernel(bits, k):
    taken = 0
    for zeros, scales, g in itertools.product(ZEROS, SCALES, (16, 32, 128)):
        jqt = _jax_pack(JQType.INT, bits, zeros, scales, g, k)
        jpad, tpad = _both(jqt)
        what = f"int{bits} zeros={zeros} scales={scales} g={g} K={k}"
        if _ref_takes(jqt) or _ref_takes(jpad):
            assert tm.kernel_takes(tpad), what
            taken += 1
        # the port's kernels also take what the JAX package runs on XLA
        # here (small groups, float offsets at every width)
        assert tm.kernel_for(tpad), what
    assert taken > 0


@pytest.mark.parametrize("qtype", [JQType.NF4, JQType.FP4, JQType.FP8_E4M3,
                                   JQType.FP8_E5M2])
@pytest.mark.parametrize("k", [4096, 11008])
def test_lut_and_fp8_packs_have_a_kernel(qtype, k):
    bits = 8 if qtype in (JQType.FP8_E4M3, JQType.FP8_E5M2) else 4
    for scales, g in itertools.product(SCALES, (16, 32, 128)):
        jqt = _jax_pack(qtype, bits, "sym", scales, g, k)
        jpad, tpad = _both(jqt)
        if _ref_takes(jqt) or _ref_takes(jpad):
            assert tm.kernel_takes(tpad), (qtype, scales, g, k)


@pytest.mark.parametrize("fmt", ["int4", "nf4", "int5"])
def test_k_slab_packs_raise_naming_the_format(fmt):
    qtype = JQType.NF4 if fmt == "nf4" else JQType.INT
    jqt = _jax_pack(qtype, int(fmt[-1]), "sym", "bfloat16", 128, 4096,
                    k_shards=2)
    assert not _ref_takes(jqt)
    tqt = port_qtensor(jqt)
    assert tm.kernel_for(tqt) == ""
    meta = dataclasses.replace(tqt, data=tuple(d.to("meta") for d in tqt.data),
                               scales=tqt.scales.to("meta"))
    x = torch.zeros((4, 4096), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no CUDA kernel takes this pack") as e:
        tm.qmatmul(x, meta)
    assert "k_shards=2" in str(e.value)


def _stacks(qtype, bits, zeros, scales, g, k):
    jqt = jtr._kernel_pack(_jax_pack(qtype, bits, zeros, scales, g, k))
    jst = jmoe.stack_experts([jqt, jqt])
    if jst is None:
        return None, None
    from neural_speed_tpu_torch.models.params import params_from_numpy

    return jst, params_from_numpy({"s": tree_to_numpy(jst)},
                                  device="cpu")["s"]


@pytest.mark.parametrize("k", [4096, 11008])
def test_every_stack_the_pallas_kernel_takes_has_a_kernel(k):
    taken = 0
    formats = [(JQType.INT, b) for b in range(1, 9)] + [(JQType.NF4, 4),
                                                        (JQType.FP4, 4)]
    for (qtype, bits), zeros, scales, g in itertools.product(
            formats, ("sym", "uint8"), ("bfloat16", "float32"),
            (16, 32, 128)):
        if qtype != JQType.INT and zeros != "sym":
            continue
        jst, st = _stacks(qtype, bits, zeros, scales, g, k)
        if jst is None:
            continue
        assert tmoe._stack_kernel_ok(st) == jmoe._stack_kernel_ok(jst)
        if jmoe._stack_kernel_ok(jst):
            assert tmoe.grouped_kernel_takes(st), (qtype, bits, zeros,
                                                   scales, g, k)
            taken += 1
    assert taken > 0
