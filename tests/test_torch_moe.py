"""The port's grouped MoE dispatch (`neural_speed_tpu_torch/ops/moe.py`) and
MoE FFN (`models/transformer.py::moe_ffn`) against the JAX package's, on
the CPU.  Inputs come from numpy seeds and go through both packages.

Tolerances:
* routes (`src`, `dest_by_a`, `block_expert`): bit for bit;
* stacked planes and scales: bit for bit;
* grouped matmuls: both packages round the weight to the compute dtype
  and sum in float32, in another order: RTOL = 1e-5 of the largest
  output (a float32 sum over K <= 512 terms); the JAX package's Pallas
  kernel in interpret mode takes K in blocks: 2e-4 in float32, as the JAX
  package's own test holds it, and 2 bf16 ulps (2**-7) of the largest
  output in bf16, where it rounds its operands at other points than
  `qmatmul_xla` (measured 0.3% of the largest output);
* `moe_ffn` in float32: 1e-5 of the largest output; in bf16: 2 bf16
  ulps (2**-7) of the largest output, for the bf16 roundings of
  activations the two packages take on sums taken in another order; 4
  (2**-6) on the single-token paths, where the port multiplies exact
  float32 weights (the compute dtype of kernel 11's GEMV, as of kernel
  A's, at M <= 32) and the JAX CPU path bf16-rounded ones (measured up to
  2.2 ulps with fp8 weights).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.models.arch import MoEConfig as JMoEConfig
from neural_speed_tpu.models import transformer as jtr
from neural_speed_tpu.ops import moe as jmoe
from neural_speed_tpu.ops.qtypes import named_qspec as j_named_qspec
from neural_speed_tpu.utils.synthetic import synth_qtensor as j_synth_qtensor
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.models import transformer as ttr
from neural_speed_tpu_torch.models.arch import ArchConfig, MoEConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import moe as tmoe

from tests.torch_port_util import (assert_qtensor_equal, port_qtensor,
                                   tree_to_numpy)

torch.set_num_threads(1)

RTOL = 1e-5
BF16_ULPS2 = 2.0 ** -7


def _route_eids(kind, rng, n_tok, e, top_k):
    """Expert ids of the assignments (token-major), each token's top_k
    experts distinct, as a router's are."""
    if kind == "single-token":
        n_tok = 1
    if kind == "skewed":          # every token on expert 3 (and one other)
        first = np.full(n_tok, 3)
        second = (3 + 1 + rng.integers(0, e - 1, n_tok)) % e
        return np.stack([first, second], 1).reshape(-1)
    if kind == "empty-expert":    # expert 5 gets nothing
        choices = [x for x in range(e) if x != 5]
        picks = [rng.choice(choices, top_k, replace=False)
                 for _ in range(n_tok)]
        return np.asarray(picks).reshape(-1)
    return np.asarray([rng.choice(e, top_k, replace=False)
                       for _ in range(n_tok)]).reshape(-1)


@pytest.mark.parametrize("bm", [128, 64])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "empty-expert",
                                  "single-token"])
def test_route_tokens_matches_jax(kind, bm):
    e, top_k, n_tok = 8, 2, 300
    eid = _route_eids(kind, np.random.default_rng(7), n_tok, e, top_k)
    want = jmoe.route_tokens(jnp.asarray(eid, jnp.int32), e, top_k, bm)
    got = tmoe.route_tokens(torch.from_numpy(eid.astype(np.int32)), e,
                            top_k, bm)
    for name in ("src", "dest_by_a", "block_expert"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the port's live-row count: the rows of each block that hold an
    # assignment, all at the block's head
    n = eid.shape[0] // top_k
    live = (got.src != n).reshape(-1, bm)
    np.testing.assert_array_equal(got.block_rows.numpy(),
                                  live.sum(1).numpy())
    ar = torch.arange(bm)[None]
    assert torch.equal(live, ar < got.block_rows[:, None])


def _jax_stack(seed, k, n, spec, n_exp):
    key = jax.random.PRNGKey(seed)
    qts = [j_synth_qtensor(jax.random.fold_in(key, e), k, n, spec)
           for e in range(n_exp)]
    return jmoe.stack_experts(qts), qts


def _port_stack(jst):
    return params_from_numpy({"s": tree_to_numpy(jst)}, device="cpu")["s"]


def test_stack_experts_matches_jax():
    spec = j_named_qspec("int4", 64, scale_dtype="bfloat16")
    jst, jqts = _jax_stack(0, 256, 128, spec, 4)
    got = tmoe.stack_experts([port_qtensor(q) for q in jqts])
    assert got.n_experts == 4 and got.shape == (256, 128)
    assert got.leaf_dims() == (256, 128) and got.local_view() is got
    carried = _port_stack(jst)
    for e in range(4):
        assert_qtensor_equal(jqts[e], got.expert(e))
        assert_qtensor_equal(jst.expert(e), carried.expert(e))
    for a, b in zip(got.data, carried.data):
        assert torch.equal(a, b)
    assert got.nbytes() == sum(q.nbytes() for q in
                               [port_qtensor(q) for q in jqts])


@pytest.mark.parametrize("case", ["spec", "shape", "zeros", "double_quant",
                                  "fp8", "float_offsets"])
def test_stack_experts_refusals(case):
    """The JAX package's refusals: None on both sides."""
    base = j_named_qspec("int4", 64)
    key = jax.random.PRNGKey(1)
    qa = j_synth_qtensor(key, 256, 128, base)
    qb = j_synth_qtensor(jax.random.fold_in(key, 1), 256, 128, base)
    if case == "spec":
        qb = j_synth_qtensor(key, 256, 128, j_named_qspec("int4", 32))
    elif case == "shape":
        qb = j_synth_qtensor(key, 256, 64, base)
    elif case == "zeros":
        qb = j_synth_qtensor(key, 256, 128, j_named_qspec("int4", 64, False))
        qb = dataclasses.replace(qb, spec=base)
    elif case == "double_quant":
        dq = j_named_qspec("int4", 64, double_quant=True)
        qa = dataclasses.replace(qa, spec=dq)
        qb = dataclasses.replace(qb, spec=dq)
    elif case == "fp8":
        f8 = j_named_qspec("fp8_e4m3", 64)
        qa = j_synth_qtensor(key, 256, 128, f8)
        qb = j_synth_qtensor(jax.random.fold_in(key, 1), 256, 128, f8)
    else:
        qa = dataclasses.replace(qa, zeros=jnp.zeros((4, 128), jnp.float32))
        qb = dataclasses.replace(qb, zeros=jnp.zeros((4, 128), jnp.float32))
    assert jmoe.stack_experts([qa, qb]) is None
    assert tmoe.stack_experts([port_qtensor(qa), port_qtensor(qb)]) is None


SPECS = [
    pytest.param(j_named_qspec("int4", 32), id="int4g32"),
    pytest.param(j_named_qspec("int4", 128, scale_dtype="bfloat16"),
                 id="int4g128-bf16"),
    pytest.param(j_named_qspec("int4", 64, False), id="int4g64asym"),
    pytest.param(j_named_qspec("int8", 64), id="int8g64"),
    pytest.param(j_named_qspec("nf4", 64), id="nf4g64"),
]


@pytest.mark.parametrize("spec", SPECS + [
    pytest.param(j_named_qspec("int3", 64), id="int3g64"),
    pytest.param(j_named_qspec("int4", 16), id="int4g16"),
    pytest.param(j_named_qspec("int4", 96), id="int4g96")])
def test_stack_kernel_rule_matches_jax(spec):
    """`_kernel_group_stacked` and `_stack_kernel_ok` (which packs the JAX
    package's Pallas kernel takes) give the JAX package's answers."""
    k = 384 if spec.group_size == 96 else 256
    jst, _ = _jax_stack(8, k, 128, spec, 2)
    st = _port_stack(jst)
    assert tmoe._kernel_group_stacked(st) == jmoe._kernel_group_stacked(jst)
    assert tmoe._stack_kernel_ok(st) == jmoe._stack_kernel_ok(jst)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", SPECS)
def test_grouped_qmatmul_plain_matches_jax(spec, dtype):
    """`grouped_qmatmul` on the CPU against the JAX package's XLA path
    (`_grouped_xla`) and its Pallas kernel in interpret mode."""
    e, k, n, bm, n_blocks = 3, 256, 128, 8, 6
    jst, _ = _jax_stack(2, k, n, spec, e)
    rng = np.random.default_rng(3)
    be = rng.integers(0, e, n_blocks).astype(np.int32)
    xs = rng.standard_normal((n_blocks * bm, k)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jxs = jnp.asarray(xs).astype(jdt)
    txs = torch.tensor(np.asarray(jxs.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tmoe.grouped_qmatmul(txs, _port_stack(jst), torch.from_numpy(be),
                               bm).numpy()
    assert got.dtype == np.float32 and got.shape == (n_blocks * bm, n)
    scale = np.abs(got).max()
    want = np.asarray(jmoe._grouped_xla(jxs, jst, jnp.asarray(be), bm))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)
    pallas = np.asarray(jmoe.grouped_qmatmul(jxs, jst, jnp.asarray(be), bm,
                                             interpret=True))
    tol = 2e-4 if dtype == "float32" else BF16_ULPS2
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol * scale)


def test_grouped_rows_plain_matches_per_row_qmatmul():
    """The per-row entry equals each row against its own expert through
    the JAX package's `qmatmul_xla` in float32 (exact weights)."""
    from neural_speed_tpu.ops.matmul import qmatmul_xla

    spec = j_named_qspec("int4", 64, scale_dtype="bfloat16")
    jst, jqts = _jax_stack(4, 256, 128, spec, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    rows_e = np.array([2, 0, 2, 3, 1], np.int32)
    got = tmoe.grouped_qmatmul_rows(torch.from_numpy(x), _port_stack(jst),
                                    torch.from_numpy(rows_e)).numpy()
    want = np.stack([np.asarray(qmatmul_xla(jnp.asarray(x[i:i + 1]),
                                            jqts[rows_e[i]], jnp.float32))[0]
                     for i in range(5)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

H, INTER, N_EXP = 128, 256, 4


def _cfgs(renorm=True):
    kw = dict(name="mixtral", vocab_size=64, hidden_size=H, n_layers=1,
              n_heads=2, n_kv_heads=2, intermediate_size=INTER)
    return (JArchConfig(**kw, moe=JMoEConfig(N_EXP, 2, renorm=renorm)),
            ArchConfig(**kw, moe=MoEConfig(N_EXP, 2, renorm=renorm)))


def _moe_params(seed, layout, spec=None):
    """JAX MoE params: `stacked` (experts_stacked gate/up/down), `list`
    (a per-expert list), or `fp8` (a list `stack_experts` refuses)."""
    spec = spec or j_named_qspec(
        "fp8_e4m3" if layout == "fp8" else "int4", 64,
        scale_dtype="bfloat16")
    key = jax.random.PRNGKey(seed)
    experts = []
    for e in range(N_EXP):
        kk = jax.random.fold_in(key, e)
        experts.append({
            "gate": {"w": j_synth_qtensor(jax.random.fold_in(kk, 0), H,
                                          INTER, spec)},
            "up": {"w": j_synth_qtensor(jax.random.fold_in(kk, 1), H, INTER,
                                        spec)},
            "down": {"w": j_synth_qtensor(jax.random.fold_in(kk, 2), INTER,
                                          H, spec)}})
    p = {"router": {"w": jax.random.normal(key, (H, N_EXP), jnp.float32)
                    * 0.3}}
    if layout == "stacked":
        p["experts_stacked"] = jtr._stack_expert_ffns(experts)
    else:
        p["experts"] = experts
    return p


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, tx


def _hold(got, want, dtype, ulps2=BF16_ULPS2):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = (RTOL if dtype == "float32" else ulps2) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "global"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["single-stacked", "grouped",
                                  "single-list", "dense-list",
                                  "single-fp8", "dense-fp8"])
def test_moe_ffn_matches_jax(path, dtype, renorm):
    """Each local path of `moe_ffn`, with both router rules."""
    jcfg, tcfg = _cfgs(renorm)
    layout = ("stacked" if path in ("single-stacked", "grouped")
              else path.split("-")[1])
    jp = _moe_params(11, layout)
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    shape = (1, 1, H) if path.startswith("single") else (2, 9, H)
    jx, tx = _x(12, shape, dtype)
    before = _build.plain_dispatches["qmatmul_grouped"]
    got = ttr.moe_ffn(tx, tp, tcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _hold(got, jtr.moe_ffn(jx, jp, jcfg), dtype,
          2 * BF16_ULPS2 if path.startswith("single") else BF16_ULPS2)
    # the stacked paths go through the grouped entries, the lists not
    used = _build.plain_dispatches["qmatmul_grouped"] - before
    assert (used > 0) == (layout == "stacked")


def test_single_token_path_is_the_switch_over_expert_views():
    """`_moe_single` (one per-row launch per projection) gives what the JAX
    package's `lax.switch` computes: `ffn` over each selected expert's
    view, rounded to x's dtype, summed in float32 in the order of top_k.
    Both sides run the port's plain versions on exact float32 weights:
    within 1e-6 of the largest output (two float32 matmuls of 1 and 2 rows
    may sum in another order)."""
    _, tcfg = _cfgs()
    tp = params_from_numpy(tree_to_numpy(_moe_params(17, "stacked")),
                           device="cpu")
    stacked = tp["experts_stacked"]
    _, tx = _x(18, (1, 1, H), "bfloat16")
    logits = ttr.linear(tx, tp["router"]).float()
    topv, topi = ttr._top_k(logits, 2)
    probs = torch.softmax(topv, dim=-1)
    got = ttr._moe_single(tx, stacked, topi, probs, tcfg).float()
    want = torch.zeros((1, 1, H))
    for j in range(2):
        view = ttr._expert_view(stacked, int(topi[0, 0, j]))
        want = want + ttr.ffn(tx, view, tcfg).float() * probs[0, 0, j]
    want = want.to(torch.bfloat16).float()
    tol = 1e-6 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def test_moe_ffn_refuses_expert_parallelism():
    _, tcfg = _cfgs()
    tp = params_from_numpy(tree_to_numpy(_moe_params(11, "stacked")),
                           device="cpu")
    with pytest.raises(NotImplementedError):
        ttr.moe_ffn(torch.zeros((1, 2, H)), tp, tcfg, ep_axis_name="ep")


@pytest.mark.parametrize("rope", [None, {"type": "linear", "factor": 2.0},
                                  {"rope_type": "yarn", "factor": 4.0,
                                   "original_max_position_embeddings": 4096},
                                  {"type": "longrope", "factor": 2.0,
                                   "long_factor": [1.0, 2.0],
                                   "short_factor": [1.0, 1.5]}])
def test_mixtral_arch_matches_jax(rope):
    """`models/configs.py`'s builders give the JAX package's ArchConfig,
    field by field, for Mixtral-8x7B's published config.json."""
    from neural_speed_tpu.models import configs as jcfgs
    from neural_speed_tpu_torch.models import configs as tcfgs

    hf = dict(tcfgs.MIXTRAL_8X7B_HF, rope_scaling=rope)
    for name in ("llama_arch", "mixtral_arch"):
        want = dataclasses.asdict(getattr(jcfgs, name)(hf))
        got = dataclasses.asdict(getattr(tcfgs, name)(hf))
        assert got == want, name
    assert tcfgs.mixtral_arch(hf).moe.num_experts == 8


def test_router_ties_go_to_the_lower_index():
    """Equal router logits: `lax.top_k` picks the lower index first, and so
    does the port (a stable descending sort), whatever their position."""
    logits = np.array([[0.5, 1.0, 1.0, -2.0, 1.0, 0.25],
                       [3.0, 3.0, 3.0, 3.0, 3.0, 3.0],
                       [-1.0, 2.0, 0.0, 2.0, 2.0, 0.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = ttr._top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_ffn_tie_in_the_router():
    """A router whose two columns are equal gives bf16 logits that tie for
    every token: both packages send each token to the lower expert first,
    and their outputs agree."""
    jcfg, tcfg = _cfgs()
    jp = _moe_params(13, "stacked")
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 2] = w[:, 1]
    jp["router"]["w"] = jnp.asarray(w)
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    for shape in ((1, 1, H), (2, 9, H)):
        jx, tx = _x(14, shape, "bfloat16")
        logits = ttr.linear(tx, tp["router"])
        _, topi = ttr._top_k(logits.float(), 2)
        assert (logits[..., 1] == logits[..., 2]).all()
        assert not ((topi == 2).any(-1) & ~(topi == 1).any(-1)).any()
        _hold(ttr.moe_ffn(tx, tp, tcfg), jtr.moe_ffn(jx, jp, jcfg),
              "bfloat16", 2 * BF16_ULPS2 if shape[1] == 1 else BF16_ULPS2)


@pytest.mark.parametrize("layout", ["list", "fp8"])
def test_fuse_params_stacks_experts(layout):
    """`fuse_params` fuses each expert's gate/up, then stacks the list where
    it stacks (int4), as the JAX package's; an fp8 list stays a list."""
    jcfg, tcfg = _cfgs()
    jp = {"layers": [{"moe": _moe_params(15, layout)}]}
    want = jtr.fuse_params(jp, jcfg)["layers"][0]["moe"]
    got = ttr.fuse_params(params_from_numpy(tree_to_numpy(jp), device="cpu"),
                          tcfg)["layers"][0]["moe"]
    assert set(got) == set(want)
    if layout == "list":
        assert set(got["experts_stacked"]) == {"gateup", "down"}
        for key in ("gateup", "down"):
            g, w = got["experts_stacked"][key], want["experts_stacked"][key]
            assert isinstance(g, tmoe.StackedExperts)
            for e in range(N_EXP):
                assert_qtensor_equal(w.expert(e), g.expert(e))
    else:
        assert [set(e) for e in got["experts"]] == [
            set(e) for e in want["experts"]]
    jx, tx = _x(16, (2, 9, H), "bfloat16")
    _hold(ttr.moe_ffn(tx, got, tcfg), jtr.moe_ffn(jx, want, jcfg),
          "bfloat16")


def _to_meta(st):
    return dataclasses.replace(st, data=tuple(d.to("meta") for d in st.data),
                               scales=st.scales.to("meta"))


@pytest.mark.parametrize("fmt", ["int4", "nf4", "int8"])
def test_wrappers_refuse_off_the_cpu(fmt):
    """A tensor on another device (meta, which no kernel takes) runs no
    plain version: an int4 stack reaches kernel 11's checks and raises, the
    other stacks the checks of the grouped F/P instances."""
    spec = j_named_qspec(fmt, 64, scale_dtype="bfloat16")
    st = _to_meta(_port_stack(_jax_stack(6, 256, 128, spec, 3)[0]))
    x = torch.zeros((256, 256), dtype=torch.bfloat16, device="meta")
    be = torch.zeros((2,), dtype=torch.int32, device="meta")
    rows_e = torch.zeros((2,), dtype=torch.int32, device="meta")
    before = dict(_build.plain_dispatches)
    want = ("kernel 11" if fmt == "int4" else
            f"grouped F/P instances.*{spec.qtype.value}{spec.bits}")
    with pytest.raises(ValueError, match=want + ".*GEMM" if fmt == "int4"
                       else want):
        tmoe.grouped_qmatmul(x, st, be, 128)
    with pytest.raises(ValueError, match=want):
        tmoe.grouped_qmatmul_rows(x[:2], st, rows_e)
    assert dict(_build.plain_dispatches) == before
